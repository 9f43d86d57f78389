"""Build the port's CUDA sources into shared libraries with a plain C interface.

Each `csrc/*.cu` is compiled on its own by nvcc for sm_90a (no fast-math: the
int8 kernels divide and round as IEEE does) into `_build/` next to the
package, which git ignores. The library's name carries a hash of the source,
of every header it includes with `#include "..."` (`csrc/sm90.cuh`), and of
the flags, so a stale build is never loaded; a present one is reused.
`build_all` starts one nvcc per missing library at once and waits for all of
them, so the kernels of a run build in parallel. The wrappers load the
result with ctypes.
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
              "-shared", "-Xcompiler", "-fPIC")


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
                    os.replace(tmp, lib)
        finally:
            for _, _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if errors:
            raise RuntimeError("\n".join(errors))
    return libs


def build(source: Path) -> Path:
    """Compile one source if its library is missing; return the library path."""
    return build_all([source])[source]
