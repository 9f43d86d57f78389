"""XLM-Roberta-CLIP for image-to-video conditioning (port of
realtime_video_tpu/models/clip.py).

Mirrors the reference wan/modules/clip.py: ViT-H/14 (dim 1280, 32 layers,
16 heads, exact GELU, pre-norm) whose 31st-block features [B, 257, 1280]
condition the i2v cross attention (CLIPModel.visual with use_31_block=True,
clip.py:527-541); plus the XLM-Roberta text tower (clip.py:455-471,
xlm_roberta.py) for the API's sake.

Parameters are plain dicts of tensors in the JAX package's layout (blocks
stacked on a leading layer axis, linear weights [in, out]), so a JAX tree
carries across leaf by leaf (`utils/convert.clip_params_from_jax`). The
towers run in their parameters' dtype (f32 by default) with plain
`torch.matmul` and an f32 softmax, as the JAX package computes them with
einsum outside any Pallas kernel: once per request, and with a head dim of 80
that the attention kernel (head dim 128) does not take.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from realtime_video_tpu_torch.utils.checkpoint import _Converter
from realtime_video_tpu_torch.utils.device import resolve_device
from realtime_video_tpu_torch.utils.image import resize_bicubic

Params = Dict[str, Any]

VIT_H_CFG = dict(
    image_size=224, patch_size=14, dim=1280, mlp_ratio=4, num_heads=16,
    num_layers=32, norm_eps=1e-5,
)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

XLM_ROBERTA_CFG = dict(
    vocab_size=250002, max_text_len=514, type_size=1, pad_id=1,
    dim=1024, num_heads=16, num_layers=24, post_norm=True, norm_eps=1e-5,
)


def _ln(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _attention(q, k, v, scale: float, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q/k/v [B, L, N, Dh] -> [B, L, N * Dh]: f32 logits and softmax, the
    probabilities in v's dtype, as the JAX towers' einsum path."""
    b, L, n, dh = q.shape
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, L, n * dh)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def init_vit_params(generator: torch.Generator, cfg: Optional[dict] = None, device=None,
                    dtype=torch.float32) -> Params:
    """Random ViT parameters with the JAX init's structure and distributions
    (normal / sqrt(dim) weights, zero biases, unit norms), drawn from
    `generator` on `device` (default: the CUDA card)."""
    cfg = cfg or VIT_H_CFG
    d, nl, mr = cfg["dim"], cfg["num_layers"], cfg["mlp_ratio"]
    ps = cfg["patch_size"]
    np_tokens = (cfg["image_size"] // ps) ** 2
    dev = resolve_device(device)
    gain = 1.0 / math.sqrt(d)

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                * gain).to(dtype)

    def lin(din, dout):
        return {"w": normal((nl, din, dout)), "b": torch.zeros((nl, dout), dtype=dtype,
                                                               device=dev)}

    def norm(layers=None):
        shape = (d,) if layers is None else (layers, d)
        return {"scale": torch.ones(shape, dtype=dtype, device=dev),
                "bias": torch.zeros(shape, dtype=dtype, device=dev)}

    blocks = {
        "norm1": norm(nl),
        "attn": {"qkv": lin(d, 3 * d), "proj": lin(d, d)},
        "norm2": norm(nl),
        "mlp": {"fc1": lin(d, mr * d), "fc2": lin(mr * d, d)},
    }
    return {
        # the patch conv as a matmul over 14x14x3 patches (pre_norm: no bias)
        "patch_embedding": {"w": normal((ps * ps * 3, d))},
        "cls_embedding": normal((1, 1, d)),
        "pos_embedding": normal((1, np_tokens + 1, d)),
        "pre_norm": norm(),
        "blocks": blocks,
    }


def vit_forward(params: Params, images: torch.Tensor, cfg: Optional[dict] = None,
                use_31_block: bool = True) -> torch.Tensor:
    """images [B, 3, H, W], normalised with the CLIP statistics -> [B, 1 +
    patches, dim] features (at ViT-H/14: [B, 257, 1280] after 31 blocks,
    clip.py:281-302)."""
    cfg = cfg or VIT_H_CFG
    d, nh = cfg["dim"], cfg["num_heads"]
    hd = d // nh
    ps = cfg["patch_size"]
    b, c, H, W = images.shape
    gh, gw = H // ps, W // ps
    x = images.reshape(b, c, gh, ps, gw, ps).permute(0, 2, 4, 1, 3, 5)
    x = _lin(params["patch_embedding"], x.reshape(b, gh * gw, c * ps * ps))
    cls = params["cls_embedding"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["pos_embedding"].to(x.dtype)
    x = _ln(params["pre_norm"], x, cfg["norm_eps"])
    L = x.shape[1]
    for i in range(cfg["num_layers"] - (1 if use_31_block else 0)):
        bp = _layer(params["blocks"], i)
        y = _ln(bp["norm1"], x, cfg["norm_eps"])
        q, k, v = _lin(bp["attn"]["qkv"], y).reshape(b, L, 3, nh, hd).unbind(2)
        x = x + _lin(bp["attn"]["proj"], _attention(q, k, v, hd ** -0.5))
        y = _ln(bp["norm2"], x, cfg["norm_eps"])
        x = x + _lin(bp["mlp"]["fc2"], F.gelu(_lin(bp["mlp"]["fc1"], y)))
    return x


def init_xlm_roberta_params(generator: torch.Generator, cfg: Optional[dict] = None,
                            device=None, dtype=torch.float32) -> Params:
    """Random XLM-Roberta text tower (reference xlm_roberta.py:76-170): a
    BERT-style post-LN encoder with word, position and type embeddings, the
    JAX init's structure and distributions (normal * 0.02), drawn from
    `generator` on `device` (default: the CUDA card)."""
    cfg = cfg or XLM_ROBERTA_CFG
    d, nl = cfg["dim"], cfg["num_layers"]
    dev = resolve_device(device)

    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
                * 0.02).to(dtype)

    def lin(din, dout):
        return {"w": normal((nl, din, dout)), "b": torch.zeros((nl, dout), dtype=dtype,
                                                               device=dev)}

    def norm(layers=None):
        shape = (d,) if layers is None else (layers, d)
        return {"scale": torch.ones(shape, dtype=dtype, device=dev),
                "bias": torch.zeros(shape, dtype=dtype, device=dev)}

    return {
        "token_embedding": normal((cfg["vocab_size"], d)),
        "pos_embedding": normal((cfg["max_text_len"], d)),
        "type_embedding": normal((cfg["type_size"], d)),
        "emb_norm": norm(),
        "blocks": {
            "attn": {n: lin(d, d) for n in ("q", "k", "v", "o")},
            "norm1": norm(nl),
            "ffn": {"fc1": lin(d, 4 * d), "fc2": lin(4 * d, d)},
            "norm2": norm(nl),
        },
        "pad_id": cfg["pad_id"],
    }


def xlm_roberta_forward(params: Params, ids: torch.Tensor,
                        cfg: Optional[dict] = None) -> torch.Tensor:
    """ids [B, L] -> hidden states [B, L, dim] (a post-norm transformer; pad
    tokens keep the pad position and are masked out of every key set)."""
    cfg = cfg or XLM_ROBERTA_CFG
    d, nh = cfg["dim"], cfg["num_heads"]
    hd = d // nh
    b, L = ids.shape
    pad_id = cfg["pad_id"]
    mask = (ids != pad_id).long()
    # roberta position ids: pad positions stay at pad_id, the others count up
    pos = torch.cumsum(mask, dim=1) * mask + pad_id
    x = (params["token_embedding"][ids] + params["pos_embedding"][pos]
         + params["type_embedding"][torch.zeros_like(ids)])
    x = _ln(params["emb_norm"], x, cfg["norm_eps"])
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e30).to(torch.float32)
    for i in range(cfg["num_layers"]):
        bp = _layer(params["blocks"], i)
        ap = bp["attn"]
        q, k, v = (_lin(ap[n], x).reshape(b, L, nh, hd) for n in ("q", "k", "v"))
        x = _ln(bp["norm1"], x + _lin(ap["o"], _attention(q, k, v, hd ** -0.5, bias)),
                cfg["norm_eps"])
        h = F.gelu(_lin(bp["ffn"]["fc1"], x))
        x = _ln(bp["norm2"], x + _lin(bp["ffn"]["fc2"], h), cfg["norm_eps"])
    return x


class CLIPVisionEncoder:
    """The i2v conditioning encoder (reference CLIPModel.visual,
    clip.py:527-541): ViT-H/14 to its 31st block. Without `params` it
    random-initialises them from `seed` on `device` (default: the CUDA
    card; pass device="cpu" for the CPU)."""

    def __init__(self, params: Optional[Params] = None, device=None,
                 dtype=torch.float32, seed: int = 0, cfg: Optional[dict] = None):
        self.cfg = cfg or VIT_H_CFG
        if params is None:
            dev = resolve_device(device)
            params = init_vit_params(torch.Generator(device=dev).manual_seed(seed), self.cfg,
                                     dev, dtype)
        self.params = params
        self.device = params["cls_embedding"].device

    def __call__(self, videos: torch.Tensor) -> torch.Tensor:
        """videos [B, C, T, H, W] in [-1, 1] -> [B * T, 257, 1280] features."""
        b, c, t, h, w = videos.shape
        frames = videos.to(self.device, torch.float32).permute(0, 2, 1, 3, 4)
        frames = frames.reshape(b * t, c, h, w)
        size = self.cfg["image_size"]
        frames = resize_bicubic(frames, size, size)
        mean = torch.tensor(CLIP_IMAGE_MEAN, device=self.device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_IMAGE_STD, device=self.device).reshape(1, 3, 1, 1)
        frames = (frames * 0.5 + 0.5 - mean) / std
        dtype = self.params["cls_embedding"].dtype
        return vit_forward(self.params, frames.to(dtype), self.cfg, True)


def convert_clip_vision(sd, dtype=torch.float32, device=None) -> Params:
    """The open-clip-xlm-roberta-large-vit-huge-14 checkpoint's `visual.*`
    tensors as the port's ViT tree, as the JAX package's converter builds it:
    linear weights transposed to [in, out], the patch conv flattened to
    [3 * 14 * 14, dim], the blocks stacked."""
    c = _Converter(sd, dtype, device)

    def norm(name):
        return {"scale": c.t(f"{name}.weight"), "bias": c.t(f"{name}.bias")}

    def block(i):
        b = f"visual.transformer.{i}"
        return {"norm1": norm(f"{b}.norm1"),
                "attn": {"qkv": c.lin(f"{b}.attn.to_qkv"), "proj": c.lin(f"{b}.attn.proj")},
                "norm2": norm(f"{b}.norm2"),
                "mlp": {"fc1": c.lin(f"{b}.mlp.0"), "fc2": c.lin(f"{b}.mlp.2")}}

    layers = 0
    while f"visual.transformer.{layers}.norm1.weight" in sd:
        layers += 1
    pe = c.t("visual.patch_embedding.weight")  # [D, 3, 14, 14]
    return {
        "patch_embedding": {"w": pe.reshape(pe.shape[0], -1).t().contiguous()},
        "cls_embedding": c.t("visual.cls_embedding"),
        "pos_embedding": c.t("visual.pos_embedding"),
        "pre_norm": norm("visual.pre_norm"),
        "blocks": c.stack(layers, block),
    }
