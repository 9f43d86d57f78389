"""Build the port's CUDA sources into shared libraries with a plain C interface.

Each `csrc/*.cu` is compiled on its own by nvcc for sm_90a (no fast-math: the
int8 kernels divide and round as IEEE does) into `_build/` next to the
package, which git ignores. The library's name carries a hash of the source,
of every header it includes with `#include "..."` (`csrc/sm90.cuh`), and of
the flags, so a stale build is never loaded; a present one is reused.
`build_all` starts one nvcc per missing library at once and waits for all of
them, so the kernels of a run build in parallel. The wrappers load the
result with ctypes. ptxas reports each kernel's registers and spills
(`-Xptxas=-v`); the report goes to a `.log` beside the library, which
`ptxas_usage` reads.
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_headers(source: Path) -> List[Path]:
    """The headers `source` includes with quotes, found beside the file that
    names them, and theirs in turn (each once)."""
    seen: List[Path] = []
    todo = [source]
    while todo:
        current = todo.pop()
        for name in _LOCAL_INCLUDE.findall(current.read_bytes()):
            header = (current.parent / name.decode()).resolve()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(source: Path) -> Path:
    """The content-keyed library that `source` builds into: the hash covers
    the source, its local headers and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in local_headers(source):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Path]) -> Dict[Path, Path]:
    """Compile every source whose library is missing, all nvcc processes
    running together; return {source: library path}. Raises with the
    compiler's output if any build fails."""
    libs = {src: library_path(src) for src in sources}
    todo = [(src, lib) for src, lib in libs.items() if not lib.exists()]
    if todo and os.environ.get("RTV_CUDA_NO_BUILD") == "1":
        # a rank of parallel/launch.run: its parent builds, the ranks only load
        raise RuntimeError(f"RTV_CUDA_NO_BUILD=1 and {[s.name for s, _ in todo]} not built: "
                           "build them before the ranks start (cuda_build.build_all)")
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = []
        try:
            for src, lib in todo:
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((cmd, tmp, lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            errors = []
            for cmd, tmp, lib, proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    errors.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
                else:
                    log_path(lib).write_text(err)
                    os.replace(tmp, lib)
        finally:
            for _, _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def log_path(lib: Path) -> Path:
    """The compiler's report of a library's build (ptxas's resource usage)."""
    return lib.with_suffix(".log")


_PTXAS_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([\w$.]+)'?")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_usage(report: str) -> Dict[str, Dict[str, int]]:
    """{mangled kernel name: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from the text ptxas prints under -v."""
    usage: Dict[str, Dict[str, int]] = {}
    current = None
    for line in report.splitlines():
        entry = _PTXAS_ENTRY.search(line)
        if entry:
            current = usage.setdefault(entry.group(1), {})
            continue
        if current is None:
            continue
        spill = _PTXAS_SPILL.search(line)
        if spill:
            current.update(stack_bytes=int(spill.group(1)), spill_store_bytes=int(spill.group(2)),
                           spill_load_bytes=int(spill.group(3)))
        regs = _PTXAS_REGS.search(line)
        if regs:
            current["registers"] = int(regs.group(1))
    return usage


def build(source: Path) -> Path:
    """Compile one source if its library is missing; return the library path."""
    return build_all([source])[source]
