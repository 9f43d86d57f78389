"""The PyTorch port imports no JAX: a fresh interpreter imports the package,
its serving stack and every other module of it, and `jax` stays out of
sys.modules. Also holds that the port's kernel wrapper takes a CUDA tensor
only to the kernel (on a CPU-only host it must raise, not fall back)."""
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "realtime_video_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_port_imports_no_jax():
    mods = _modules()
    assert "realtime_video_tpu_torch.serving.server" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'realtime_video_tpu' or m.startswith('realtime_video_tpu.'))\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_wrapper_never_falls_back_for_cuda_tensors(monkeypatch):
    """With a (fake) CUDA tensor the wrapper must go to the kernel; when the
    kernel cannot be built it raises instead of running the plain version."""
    from realtime_video_tpu_torch.ops import hopper_attention as hk

    monkeypatch.setattr(hk, "_lib", None)
    monkeypatch.setattr(hk, "build", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    monkeypatch.setattr(hk, "_check", lambda *a: None)
    hk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.window_attention(q, q, q, 0, 4)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.block_causal_attention(q, q, q, 2)
    assert hk.PLAIN_ON_CUDA == {"window": 0, "block_causal": 0}
