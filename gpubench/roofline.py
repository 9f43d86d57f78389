"""The yardstick's arithmetic: the work of one warm serving block, counted
from the model's shapes and the session's geometry (never from launches),
the H100's published peaks, and the table that maps a profiled kernel's
name to its family.

A warm block (block_idx >= 1, kv_cache_num_frames = 3, 3 latent frames a
block) runs the context prefill and the 4 denoise forwards of the DiT, each
over one block's tokens (3 latent frames, each cut into patches: (H/16) *
(W/16) at the VAE's stride 8 and the DiT's 2 x 2 patches), the prefill's
self-attention over its own tokens and each denoise's over the context and
its own (twice as many keys), every forward's cross-attention over the
512 text tokens; then the streamed decode of 3 latents (4 frames each) and,
from block 2 on, the fresh encode of one frame (the anti-drift re-encode).

Bounds follow chip_smoke.py's: a family's least time is the larger of its
operations over the peak of each operation's precision and its bytes
(each input read once, each output written once) over HBM bandwidth.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

from gpubench import layout, weights

#: NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12
FAMILIES = ("attention", "linear", "conv", "copy", "other")


def family(kernel_name: str) -> str:
    """A device kernel's family by its name (a frozen copy of the buckets of
    the port's tools/profile_block.py, grouped): the attention kernels and
    their pre-passes; the int8 linear kernel and library GEMMs; the int8 conv
    kernel, its quantise pre-pass and library convolutions; copies; the rest
    (elementwise and other torch kernels)."""
    n = kernel_name.lower()
    if "attn_bwd_" in n or "attn_logit_bound" in n or "attention_kernel" in n \
            or "attn_int8_" in n:
        return "attention"
    if "int8_linear_kernel" in n:
        return "linear"
    if "conv_kernel<" in n or "conv_kernel_sm90" in n or "conv_quantize_kernel" in n:
        return "conv"
    if n.startswith("memcpy") or n.startswith("memset"):
        return "copy"
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "conv"
    if "gemm" in n or "nvjet" in n or "cutlass" in n:
        return "linear"
    return "other"


def _work() -> Dict[str, float]:
    return {"bf16": 0.0, "int8": 0.0, "bytes": 0.0}


def block_tokens(cfg: dict) -> int:
    (lat_h, lat_w), (_, ph, pw) = layout.latent_hw(cfg), cfg["patch_size"]
    return cfg["session"]["num_frame_per_block"] * (lat_h // ph) * (lat_w // pw)


def dit_linear_work(cfg: dict, tokens: int, forwards: int) -> Dict[str, float]:
    """The block linears (int8: x bf16 and w s8 read, y bf16 written) and the
    patch embedding and head (bf16) of `forwards` forwards of `tokens`."""
    d, f, nl = cfg["dim"], cfg["ffn_dim"], cfg["num_layers"]
    w = _work()
    shapes = [(d, 3 * d), (d, d), (d, d), (d, d), (d, f), (f, d)]
    for k, n in shapes:
        w["int8"] += forwards * nl * 2.0 * tokens * k * n
        w["bytes"] += forwards * nl * (2.0 * tokens * k + k * n + 6.0 * n + 2.0 * tokens * n)
    patch = math.prod(cfg["patch_size"])
    for k, n in ((cfg["in_dim"] * patch, d), (d, cfg["out_dim"] * patch)):
        w["bf16"] += forwards * 2.0 * tokens * k * n
        w["bytes"] += forwards * (2.0 * tokens * k + 2.0 * k * n + 2.0 * tokens * n)
    return w


def attention_work(cfg: dict, pairs: List[Tuple[int, int]], int8_qk: bool) -> Dict[str, float]:
    """Every layer's attention over (queries, keys) pairs of calls: QK^T and
    PV, 2 operations a term each; with int8 QK^T its half at the int8 peak.
    q, k, v read and o written once, bf16."""
    d, nl = cfg["dim"], cfg["num_layers"]
    w = _work()
    for lq, lk in pairs:
        half = nl * 2.0 * lq * lk * d
        w["int8" if int8_qk else "bf16"] += half
        w["bf16"] += half
        w["bytes"] += nl * 2.0 * (2 * lq * d + 2 * lk * d)
    return w


def _conv(w: Dict[str, float], t: int, h: int, wd: int, cin: int, cout: int, taps: int,
          int8: bool, t_in: int = None, h_in: int = None, w_in: int = None) -> None:
    """Add one conv of `taps` kernel taps writing [t, h, wd, cout]."""
    w["int8" if int8 else "bf16"] += 2.0 * t * h * wd * cout * taps * cin
    t_in, h_in, w_in = t_in or t, h_in or h, w_in or wd
    w["bytes"] += 2.0 * t_in * h_in * w_in * cin + (1 if int8 else 2) * taps * cin * cout \
        + 2.0 * t * h * wd * cout


def _res(w, t, h, wd, cin, cout, kt):
    _conv(w, t, h, wd, cin, cout, kt * 9, True)
    _conv(w, t, h, wd, cout, cout, kt * 9, True)
    if cin != cout:
        _conv(w, t, h, wd, cin, cout, 1, False)


def _vae_attention(w, t, h, wd, c):
    """The mid-block's single-head attention per frame (matrix work: bf16)."""
    n = h * wd
    w["bf16"] += t * 2.0 * (n * c * 3 * c + 2 * n * n * c + n * c * c)
    w["bytes"] += t * 2.0 * (4 * n * c + 4 * c * c)


def decode_latent_work(vae: dict, lat_h: int, lat_w: int) -> Tuple[dict, dict]:
    """(conv work, attention matmul work) of one streamed decode call of one
    latent after the first (caches full: every causal conv runs its 3 taps)."""
    conv, mm = _work(), _work()
    z = vae["z_dim"]
    dims, plan = weights.decoder_plan(vae)
    t, h, wd = 1, lat_h, lat_w
    _conv(conv, t, h, wd, z, z, 1, False)  # conv2
    _conv(conv, t, h, wd, z, dims[0], 27, True)  # conv1
    _res(conv, t, h, wd, dims[0], dims[0], 3)
    _vae_attention(mm, t, h, wd, dims[0])
    _res(conv, t, h, wd, dims[0], dims[0], 3)
    for spec in plan:
        if spec[0] == "res":
            _res(conv, t, h, wd, spec[1], spec[2], 3)
            continue
        mode, dim = spec[1], spec[2]
        if mode == "upsample3d":
            _conv(conv, t, h, wd, dim, 2 * dim, 3, False, t_in=t + 2)  # time conv
            t *= 2
        _conv(conv, t, 2 * h, 2 * wd, dim, dim // 2, 9, True, h_in=2 * h, w_in=2 * wd)
        h, wd = 2 * h, 2 * wd
    _conv(conv, t, h, wd, dims[-1], 3, 27, True)  # head
    return conv, mm


def encode_frame_work(vae: dict, height: int, width: int) -> Tuple[dict, dict]:
    """(conv work, attention matmul work) of a fresh one-frame encode (the
    causal convs run their last tap only)."""
    conv, mm = _work(), _work()
    z = vae["z_dim"]
    dims, plan = weights.encoder_plan(vae)
    h, wd = height, width
    _conv(conv, 1, h, wd, 3, dims[0], 9, True)
    for spec in plan:
        if spec[0] == "res":
            _res(conv, 1, h, wd, spec[1], spec[2], 1)
            continue
        dim = spec[2]
        _conv(conv, 1, h // 2, wd // 2, dim, dim, 9, True, h_in=h, w_in=wd)
        h, wd = h // 2, wd // 2
    _res(conv, 1, h, wd, dims[-1], dims[-1], 1)
    _vae_attention(mm, 1, h, wd, dims[-1])
    _res(conv, 1, h, wd, dims[-1], dims[-1], 1)
    _conv(conv, 1, h, wd, dims[-1], 2 * z, 9, True)
    _conv(conv, 1, h, wd, 2 * z, 2 * z, 1, False)
    return conv, mm


def _add(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def warm_block_work(cfg: dict) -> Dict[str, Dict[str, float]]:
    """Work of one warm block with the re-encode, by family."""
    s = cfg["session"]
    n = block_tokens(cfg)
    ctx = n  # kv_cache_num_frames = 3 latents of context: one block
    lat_h, lat_w = layout.latent_hw(cfg)
    steps = s["num_denoising_steps"]
    linear = dit_linear_work(cfg, n, steps + 1)
    pairs = [(ctx, ctx)] + [(n, ctx + n)] * steps + [(n, cfg["text_len"])] * (steps + 1)
    attn = attention_work(cfg, pairs, cfg["port"]["int8_qk_attention"])
    conv, mm = _work(), _work()
    for _ in range(s["num_frame_per_block"]):
        c, m = decode_latent_work(cfg["vae"], lat_h, lat_w)
        conv, mm = _add(conv, c), _add(mm, m)
    c, m = encode_frame_work(cfg["vae"], s["height"], s["width"])
    conv, mm = _add(conv, c), _add(mm, m)
    return {"attention": attn, "linear": _add(linear, mm), "conv": conv}


def least_time_s(work: Dict[str, float]) -> float:
    """max(operations at their precision's peak, bytes at HBM bandwidth)."""
    compute = sum(work[p] / PEAK_OPS_PER_S[p] for p in PEAK_OPS_PER_S)
    return max(compute, work["bytes"] / HBM_BYTES_PER_S)


def matrix_time_s(works: Dict[str, Dict[str, float]]) -> float:
    """All matrix work of the families at its precisions' peaks (MFU's numerator)."""
    return sum(w[p] / PEAK_OPS_PER_S[p] for w in works.values() for p in PEAK_OPS_PER_S)
