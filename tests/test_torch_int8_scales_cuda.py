"""The int8 trees built on a card equal, bit for bit, the trees built on the
CPU from the same f32 weights (marked `cuda`; skips on a host without one).
This file imports no JAX, so it runs on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_int8_scales_cuda.py

The weight scales are max|w| / 127 per output channel and the static
activation scales amax * 1.5 / 127. On a card PyTorch divides by a Python
scalar as a multiply by its reciprocal, which differs from the IEEE quotient
in the last bit for some amaxes, and then `w_q` differs wherever a quotient
sits at a rounding edge; the quantisers divide by a tensor, so `scale`,
`w_q` and `a_scale` must be equal on both sides. The JAX quantisers compute
the same quotients in numpy on the host.
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.config import VAEConfig, WanModelConfig
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

WAN = WanModelConfig(dim=256, ffn_dim=512, num_heads=2, num_layers=3)
VAEC = VAEConfig(dim=32, z_dim=16, dim_mult=(1, 2, 2, 2), num_res_blocks=1)


def _device_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the quotients under test are the card's")
    return torch.device("cuda")


def _f32_tree(tree, seed):
    """The tree's structure with f32 normal weights of varied magnitudes."""
    rng = np.random.default_rng(seed)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        arr = rng.normal(size=tuple(node.shape)) * rng.uniform(0.01, 3.0)
        return torch.from_numpy(arr.astype(np.float32))

    return fill(tree)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _int8_leaves(tree, path=""):
    """(path, leaf) of every w_q, scale and a_scale of an int8 tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "w_q" in tree and k in ("w_q", "scale", "a_scale"):
                yield f"{path}/{k}", v
            elif isinstance(v, (dict, list)):
                yield from _int8_leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _int8_leaves(v, f"{path}/{i}")


def _assert_bit_equal(cpu_tree, gpu_tree):
    cpu, gpu = dict(_int8_leaves(cpu_tree)), dict(_int8_leaves(gpu_tree))
    assert cpu.keys() == gpu.keys() and cpu
    for path, a in cpu.items():
        b = gpu[path].cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, path
        bits = torch.int8 if a.dtype == torch.int8 else torch.int32
        assert torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)), path


@pytest.mark.cuda
def test_dit_int8_tree_is_the_same_on_the_card():
    dev = _device_or_skip()
    base = wan_dit.fuse_qkv_params(wan_dit.init_wan_params(
        WAN, torch.Generator().manual_seed(0), "cpu", torch.float32))
    params = _f32_tree(base, 1)
    sites = wan_dit._calib_site_order(params["blocks"])
    rng = np.random.default_rng(2)
    act = {s: torch.from_numpy(rng.uniform(0.1, 40.0, size=WAN.num_layers)) for s in sites}
    on_cpu = wan_dit.quantize_wan_linears(params, act_scales=act)
    on_gpu = wan_dit.quantize_wan_linears(_to(params, dev), act_scales=act)
    _assert_bit_equal(on_cpu, on_gpu)


@pytest.mark.cuda
def test_vae_int8_tree_is_the_same_on_the_card():
    dev = _device_or_skip()
    base = vae_mod.init_vae_params(VAEC, torch.Generator().manual_seed(0), "cpu",
                                   torch.float32)
    params = _f32_tree(base, 3)
    rng = np.random.default_rng(4)
    act = {path: float(rng.uniform(0.1, 40.0)) for path, _ in vae_mod._walk_paths(params)}
    on_cpu = vae_mod.quantize_vae_params(params, act_scales=act)
    on_gpu = vae_mod.quantize_vae_params(_to(params, dev), act_scales=act)
    _assert_bit_equal(on_cpu, on_gpu)


@pytest.mark.cuda
def test_dynamic_scale_is_the_ieee_quotient_on_the_card():
    dev = _device_or_skip()
    rng = np.random.default_rng(5)
    for _ in range(64):
        x = torch.from_numpy(rng.normal(size=(8, 64)).astype(np.float32)
                             * rng.uniform(0.01, 100.0))
        want = hm.dynamic_scale(x)
        got = hm.dynamic_scale(x.to(dev)).cpu()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
