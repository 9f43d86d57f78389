"""Checkpoint loading: the reference's torch / safetensors state dicts -> the
port's parameter trees (port of realtime_video_tpu/utils/checkpoint.py).

Handles the reference's checkpoint formats:
  * DiT safetensors or .pt with an optional "model." prefix (sweep_sample.py:7-21,
    release_server.py:160-169) and the 1.3B/14B autodetect from
    blocks.0.self_attn.k.weight (release_server.py:162-165), its self-attention
    q/k/v split or fused as `to_qkv`; an i2v checkpoint (Wan2.1-I2V-14B) with
    its image cross-attention projections and `img_emb`;
  * the umt5-xxl encoder safetensors (models_t5_umt5-xxl-enc-bf16.safetensors);
  * the Wan2.1_VAE.pth torch pickle.

The converters map reference names straight to the port's trees, in the
port's layout: linear weights [out, in] -> [in, out], conv3d [out, in, kt,
kh, kw] -> [kt, kh, kw, in, out], per-layer tensors stacked on a leading layer
axis, the DiT's self-attention q/k/v fused into one `qkv` projection (the
int8 tier's K-major `w_q` is made later, by quantising). Each tensor goes
to the requested dtype and device on its own, with no float32 round trip, so
host memory stays near the state dict's own size. `safetensors` is imported
only for a .safetensors file; a .pt / .pth file needs only torch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from realtime_video_tpu_torch.config import (
    T5_CONFIGS,
    VAE_CONFIGS,
    WAN_CONFIGS,
    T5Config,
    VAEConfig,
    WanModelConfig,
)

StateDict = Dict[str, Any]


def load_torch_state_dict(path: str) -> StateDict:
    """Load a .safetensors or .pt/.pth file into a name -> tensor dict on the CPU."""
    if path.endswith(".safetensors") or path.endswith(".sft"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{path} is a safetensors file and the safetensors package "
                              "is not installed (pip install safetensors)") from e
        return load_file(path, device="cpu")
    return torch.load(path, map_location="cpu", weights_only=True)


def strip_prefix(sd: StateDict, prefix: str = "model.") -> StateDict:
    """Remove a wrapper prefix wherever a key carries it (sweep_sample.py:7-21)."""
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in sd.items()}
    return sd


def detect_wan_config(sd: StateDict) -> WanModelConfig:
    """1.3B vs 14B autodetect (release_server.py:162-165); a checkpoint with
    `img_emb` is i2v-14B, its `in_dim` read from `patch_embedding.weight`
    [dim, in_dim, 1, 2, 2]. (The JAX package's detect returns t2v-14B there,
    and its i2v-14B config keeps in_dim 16; the port's copy repairs both.)"""
    if "img_emb.proj.0.weight" in sd:
        return dataclasses.replace(WAN_CONFIGS["i2v-14B"],
                                   in_dim=int(sd["patch_embedding.weight"].shape[1]))
    w = sd.get("blocks.0.self_attn.k.weight")
    if w is not None and w.shape[0] == 1536:
        return WAN_CONFIGS["t2v-1.3B"]
    return WAN_CONFIGS["t2v-14B"]


class _Converter:
    """Reads tensors of one state dict into `dtype` on `device`."""

    def __init__(self, sd: StateDict, dtype: torch.dtype, device):
        self.sd, self.dtype, self.device = sd, dtype, device

    def t(self, name: str, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        return self.sd[name].to(device=self.device, dtype=dtype or self.dtype)

    def lin(self, name: str, dtype=None, bias: bool = True) -> Dict[str, torch.Tensor]:
        p = {"w": self.t(f"{name}.weight", dtype).t().contiguous()}
        if bias and f"{name}.bias" in self.sd:
            p["b"] = self.t(f"{name}.bias", dtype)
        return p

    def stack(self, layers: int, fn) -> Any:
        """Layer-stacked tree of fn(i)'s trees, filled one layer at a time."""
        first = fn(0)

        def alloc(node):
            if isinstance(node, dict):
                return {k: alloc(v) for k, v in node.items()}
            return torch.empty((layers, *node.shape), dtype=node.dtype, device=node.device)

        def fill(dst, src, i):
            if isinstance(dst, dict):
                for k in dst:
                    fill(dst[k], src[k], i)
            else:
                dst[i] = src

        out = alloc(first)
        fill(out, first, 0)
        for i in range(1, layers):
            fill(out, fn(i), i)
        return out


def convert_wan_dit(sd: StateDict, cfg: WanModelConfig, dtype=torch.bfloat16,
                    device=None) -> Dict[str, Any]:
    """A reference DiT state dict (t2v or i2v) as the port's tree with the
    self-attention projections fused; the time MLP and the modulation tables
    stay f32, as in the JAX converter. An i2v state dict's `k_img`, `v_img`,
    `norm_k_img` and `img_emb.proj.{0,1,3,4}` (LN, Linear, GELU, Linear, LN)
    map as the JAX converter maps them: proj.1 -> fc1, proj.3 -> fc2."""
    sd = strip_prefix(sd, "model.")
    c = _Converter(sd, dtype, device)

    def qkv(base: str) -> Dict[str, Dict[str, torch.Tensor]]:
        if f"{base}.to_qkv.weight" in sd:
            w = c.t(f"{base}.to_qkv.weight").t()
            b = c.t(f"{base}.to_qkv.bias")
            return {n: {"w": w[:, j * cfg.dim:(j + 1) * cfg.dim].contiguous(),
                        "b": b[j * cfg.dim:(j + 1) * cfg.dim].contiguous()}
                    for j, n in enumerate("qkv")}
        return {n: c.lin(f"{base}.{n}") for n in "qkv"}

    def attn(base: str, fused: bool) -> Dict[str, Any]:
        p = qkv(base)
        if fused:
            p = {"qkv": {"w": torch.cat([p[n]["w"] for n in "qkv"], dim=1),
                         "b": torch.cat([p[n]["b"] for n in "qkv"])}}
        p["o"] = c.lin(f"{base}.o")
        p["norm_q"] = {"scale": c.t(f"{base}.norm_q.weight")}
        p["norm_k"] = {"scale": c.t(f"{base}.norm_k.weight")}
        if f"{base}.k_img.weight" in sd:
            p["k_img"] = c.lin(f"{base}.k_img")
            p["v_img"] = c.lin(f"{base}.v_img")
            p["norm_k_img"] = {"scale": c.t(f"{base}.norm_k_img.weight")}
        return p

    def block(i: int) -> Dict[str, Any]:
        b = f"blocks.{i}"
        blk = {"self_attn": attn(f"{b}.self_attn", True),
               "cross_attn": attn(f"{b}.cross_attn", False),
               "ffn": {"fc1": c.lin(f"{b}.ffn.0"), "fc2": c.lin(f"{b}.ffn.2")},
               "modulation": c.t(f"{b}.modulation", torch.float32)}
        if cfg.cross_attn_norm:
            blk["norm3"] = {"scale": c.t(f"{b}.norm3.weight"), "bias": c.t(f"{b}.norm3.bias")}
        return blk

    pe_w = c.t("patch_embedding.weight")  # [D, C, pt, ph, pw]
    f32 = torch.float32
    params = {
        # flatten (C, pt*ph*pw) row-major to match patchify's token layout
        "patch_embedding": {"w": pe_w.reshape(pe_w.shape[0], -1).t().contiguous(),
                            "b": c.t("patch_embedding.bias")},
        "text_embedding": {"fc1": c.lin("text_embedding.0"), "fc2": c.lin("text_embedding.2")},
        "time_embedding": {"fc1": c.lin("time_embedding.0", f32),
                           "fc2": c.lin("time_embedding.2", f32)},
        "time_projection": {"fc": c.lin("time_projection.1", f32)},
        "blocks": c.stack(cfg.num_layers, block),
        "head": {"head": c.lin("head.head"), "modulation": c.t("head.modulation", f32)},
    }
    if "img_emb.proj.0.weight" in sd:
        params["img_emb"] = {
            "norm1": {"scale": c.t("img_emb.proj.0.weight"), "bias": c.t("img_emb.proj.0.bias")},
            "fc1": c.lin("img_emb.proj.1"),
            "fc2": c.lin("img_emb.proj.3"),
            "norm2": {"scale": c.t("img_emb.proj.4.weight"), "bias": c.t("img_emb.proj.4.bias")},
        }
    return params


def convert_t5_encoder(sd: StateDict, cfg: T5Config, dtype=torch.bfloat16,
                       device=None) -> Dict[str, Any]:
    """A reference umT5 encoder state dict as the port's tree (`models/t5.py`);
    the relative position embeddings stay f32."""
    c = _Converter(sd, dtype, device)

    def block(i: int) -> Dict[str, Any]:
        b = f"blocks.{i}"
        return {
            "norm1": {"scale": c.t(f"{b}.norm1.weight")},
            "attn": {n: c.lin(f"{b}.attn.{n}", bias=False) for n in ("q", "k", "v", "o")},
            "norm2": {"scale": c.t(f"{b}.norm2.weight")},
            "ffn": {"gate": c.lin(f"{b}.ffn.gate.0", bias=False),
                    "fc1": c.lin(f"{b}.ffn.fc1", bias=False),
                    "fc2": c.lin(f"{b}.ffn.fc2", bias=False)},
            "rel_emb": c.t(f"{b}.pos_embedding.embedding.weight", torch.float32),
        }

    return {"token_embedding": c.t("token_embedding.weight"),
            "blocks": c.stack(cfg.num_layers, block),
            "norm": {"scale": c.t("norm.weight")}}


def convert_vae(sd: StateDict, cfg: VAEConfig, dtype=torch.float32,
                device=None) -> Dict[str, Any]:
    """A reference Wan 2.1 VAE state dict as the port's tree (`models/vae.py`)."""
    from realtime_video_tpu_torch.models.vae import _decoder_plan, _encoder_plan

    c = _Converter(sd, dtype, device)

    def conv(name: str, perm) -> Dict[str, torch.Tensor]:
        return {"w": c.t(f"{name}.weight").permute(*perm).contiguous(),
                "b": c.t(f"{name}.bias")}

    def conv3(name):  # [out, in, kt, kh, kw] -> [kt, kh, kw, in, out]
        return conv(name, (2, 3, 4, 1, 0))

    def conv2(name):  # [out, in, kh, kw] -> [kh, kw, in, out]
        return conv(name, (2, 3, 1, 0))

    def gamma(name):
        return {"gamma": c.t(name).reshape(-1)}

    def res(base):
        p = {"norm1": gamma(f"{base}.residual.0.gamma"), "conv1": conv3(f"{base}.residual.2"),
             "norm2": gamma(f"{base}.residual.3.gamma"), "conv2": conv3(f"{base}.residual.6")}
        if f"{base}.shortcut.weight" in sd:
            p["shortcut"] = conv3(f"{base}.shortcut")
        return p

    def attn(base):
        # to_qkv / proj are 1x1 Conv2d [out, in, 1, 1] -> dense [in, out]
        return {"norm": gamma(f"{base}.norm.gamma"),
                "to_qkv": {"w": c.t(f"{base}.to_qkv.weight")[:, :, 0, 0].t().contiguous(),
                           "b": c.t(f"{base}.to_qkv.bias")},
                "proj": {"w": c.t(f"{base}.proj.weight")[:, :, 0, 0].t().contiguous(),
                         "b": c.t(f"{base}.proj.bias")}}

    def resample(base, mode):
        p = {}
        if mode != "none":
            p["conv"] = conv2(f"{base}.resample.1")
        if mode in ("upsample3d", "downsample3d"):
            p["time_conv"] = conv3(f"{base}.time_conv")
        return p

    def stage(prefix, plan):
        return [res(f"{prefix}.{i}") if spec[0] == "res" else resample(f"{prefix}.{i}", spec[1])
                for i, spec in enumerate(plan)]

    _, enc_plan = _encoder_plan(cfg)
    _, dec_plan = _decoder_plan(cfg)
    return {
        "encoder": {"conv1": conv3("encoder.conv1"),
                    "downsamples": stage("encoder.downsamples", enc_plan),
                    "middle_res1": res("encoder.middle.0"),
                    "middle_attn": attn("encoder.middle.1"),
                    "middle_res2": res("encoder.middle.2"),
                    "head_norm": gamma("encoder.head.0.gamma"),
                    "head_conv": conv3("encoder.head.2")},
        "decoder": {"conv1": conv3("decoder.conv1"),
                    "middle_res1": res("decoder.middle.0"),
                    "middle_attn": attn("decoder.middle.1"),
                    "middle_res2": res("decoder.middle.2"),
                    "upsamples": stage("decoder.upsamples", dec_plan),
                    "head_norm": gamma("decoder.head.0.gamma"),
                    "head_conv": conv3("decoder.head.2")},
        "conv1": conv3("conv1"),
        "conv2": conv3("conv2"),
    }


def load_wan_dit(checkpoint_path: str, dtype=torch.bfloat16,
                 device=None) -> Tuple[WanModelConfig, Dict[str, Any]]:
    sd = strip_prefix(load_torch_state_dict(checkpoint_path), "model.")
    cfg = detect_wan_config(sd)
    return cfg, convert_wan_dit(sd, cfg, dtype, device)


def load_t5(checkpoint_path: str, cfg: Optional[T5Config] = None, dtype=torch.bfloat16,
            device=None) -> Tuple[T5Config, Dict[str, Any]]:
    cfg = cfg or T5_CONFIGS["umt5-xxl"]
    return cfg, convert_t5_encoder(load_torch_state_dict(checkpoint_path), cfg, dtype, device)


def load_vae(checkpoint_path: str, cfg: Optional[VAEConfig] = None, dtype=torch.float32,
             device=None) -> Tuple[VAEConfig, Dict[str, Any]]:
    cfg = cfg or VAE_CONFIGS["wan2.1"]
    return cfg, convert_vae(load_torch_state_dict(checkpoint_path), cfg, dtype, device)
