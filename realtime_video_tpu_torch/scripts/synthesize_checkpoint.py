"""Synthesize a full-size RANDOM checkpoint set in the reference's exact
layout (tensor names, shapes, dtypes, file locations: release_server.py:160-169
/ README.md:53), so the real-checkpoint load path can be exercised end to end
without the 30 GB weight download (port of the repo's
scripts/synthesize_checkpoint.py, drawing the same numbers):

    MODEL_FOLDER/
      wan_synth_t2v_1.3b.safetensors                       (DiT, torch [out,in])
      Wan2.1-T2V-1.3B/Wan2.1_VAE.pth                       (torch pickle)
      Wan2.1-T2V-1.3B/models_t5_umt5-xxl-enc-bf16.safetensors

The tensors carry the UPSTREAM orientation and naming (split q/k/v, torch
Linear [out, in], Conv3d [out, in, kt, kh, kw]): the point is to drive
utils/checkpoint.py's converters over their real input format. Every tensor
is drawn from the module-level generator `GEN` (torch.Generator seeded 0) in
the JAX package's script's order, so at every config the state dicts equal
that script's bit for bit. `--verify` round-trips tiny configs through the
port's converters and holds the trees against the port's own init_* trees:
names, shapes and dtypes.

    python -m realtime_video_tpu_torch.scripts.synthesize_checkpoint \\
        [--out ~/models] [--t5 tiny|full]
    python -m realtime_video_tpu_torch.scripts.synthesize_checkpoint --verify
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, Optional, Sequence

import torch

from realtime_video_tpu_torch.config import T5_CONFIGS, VAE_CONFIGS, WAN_CONFIGS
from realtime_video_tpu_torch.models.vae import _decoder_plan, _encoder_plan

GEN = torch.Generator().manual_seed(0)
DIT_NAME = "wan_synth_t2v_1.3b.safetensors"


def _w(*shape, dtype=torch.bfloat16, std=0.02):
    return torch.empty(*shape, dtype=torch.float32).normal_(0.0, std, generator=GEN).to(dtype)


def _zeros(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


def _ones(*shape, dtype=torch.bfloat16):
    return torch.ones(*shape, dtype=dtype)


# ---------------------------------------------------------------------------
# DiT (upstream layout: causal_model.py parameter names)
# ---------------------------------------------------------------------------


def synth_dit(cfg) -> dict:
    d, ffn = cfg.dim, cfg.ffn_dim
    pt, ph, pw = cfg.patch_size
    sd: dict = {}

    def lin(name, din, dout, dtype=torch.bfloat16):
        sd[f"{name}.weight"] = _w(dout, din, dtype=dtype)
        sd[f"{name}.bias"] = _zeros(dout, dtype=dtype)

    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        for attn in ("self_attn", "cross_attn"):
            for n in ("q", "k", "v", "o"):
                lin(f"{b}.{attn}.{n}", d, d)
            sd[f"{b}.{attn}.norm_q.weight"] = _ones(d)
            sd[f"{b}.{attn}.norm_k.weight"] = _ones(d)
        lin(f"{b}.ffn.0", d, ffn)
        lin(f"{b}.ffn.2", ffn, d)
        sd[f"{b}.modulation"] = _w(1, 6, d, dtype=torch.float32, std=d ** -0.5)
        if cfg.cross_attn_norm:
            sd[f"{b}.norm3.weight"] = _ones(d)
            sd[f"{b}.norm3.bias"] = _zeros(d)

    sd["patch_embedding.weight"] = _w(d, cfg.in_dim, pt, ph, pw)
    sd["patch_embedding.bias"] = _zeros(d)
    lin("text_embedding.0", cfg.text_dim, d)
    lin("text_embedding.2", d, d)
    lin("time_embedding.0", cfg.freq_dim, d, dtype=torch.float32)
    lin("time_embedding.2", d, d, dtype=torch.float32)
    lin("time_projection.1", d, 6 * d, dtype=torch.float32)
    sd["head.head.weight"] = _zeros(cfg.out_dim * pt * ph * pw, d)
    sd["head.head.bias"] = _zeros(cfg.out_dim * pt * ph * pw)
    sd["head.modulation"] = _w(1, 2, d, dtype=torch.float32, std=d ** -0.5)
    return sd


# ---------------------------------------------------------------------------
# umT5-XXL encoder (wan/modules/t5.py layout)
# ---------------------------------------------------------------------------


def synth_t5(cfg) -> dict:
    sd: dict = {
        "token_embedding.weight": _w(cfg.vocab_size, cfg.dim),
        "norm.weight": _ones(cfg.dim),
    }
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        sd[f"{b}.norm1.weight"] = _ones(cfg.dim)
        for n in ("q", "k", "v"):
            sd[f"{b}.attn.{n}.weight"] = _w(cfg.dim_attn, cfg.dim)
        sd[f"{b}.attn.o.weight"] = _w(cfg.dim, cfg.dim_attn)
        sd[f"{b}.norm2.weight"] = _ones(cfg.dim)
        sd[f"{b}.ffn.gate.0.weight"] = _w(cfg.dim_ffn, cfg.dim)
        sd[f"{b}.ffn.fc1.weight"] = _w(cfg.dim_ffn, cfg.dim)
        sd[f"{b}.ffn.fc2.weight"] = _w(cfg.dim, cfg.dim_ffn)
        sd[f"{b}.pos_embedding.embedding.weight"] = _w(
            cfg.num_buckets, cfg.num_heads, dtype=torch.float32)
    return sd


# ---------------------------------------------------------------------------
# Wan 2.1 VAE (wan/modules/vae.py layout; torch pickle)
# ---------------------------------------------------------------------------


def synth_vae(cfg) -> dict:
    sd: dict = {}

    def conv3(name, cin, cout, k=(3, 3, 3)):
        sd[f"{name}.weight"] = _w(cout, cin, *k, dtype=torch.float32)
        sd[f"{name}.bias"] = _zeros(cout, dtype=torch.float32)

    def conv2(name, cin, cout, k=(3, 3)):
        sd[f"{name}.weight"] = _w(cout, cin, *k, dtype=torch.float32)
        sd[f"{name}.bias"] = _zeros(cout, dtype=torch.float32)

    def res(base, cin, cout):
        sd[f"{base}.residual.0.gamma"] = _ones(cin, 1, 1, dtype=torch.float32)
        conv3(f"{base}.residual.2", cin, cout)
        sd[f"{base}.residual.3.gamma"] = _ones(cout, 1, 1, dtype=torch.float32)
        conv3(f"{base}.residual.6", cout, cout)
        if cin != cout:
            conv3(f"{base}.shortcut", cin, cout, k=(1, 1, 1))

    def attn(base, c):
        sd[f"{base}.norm.gamma"] = _ones(c, 1, 1, dtype=torch.float32)
        sd[f"{base}.to_qkv.weight"] = _w(3 * c, c, 1, 1, dtype=torch.float32)
        sd[f"{base}.to_qkv.bias"] = _zeros(3 * c, dtype=torch.float32)
        sd[f"{base}.proj.weight"] = _w(c, c, 1, 1, dtype=torch.float32)
        sd[f"{base}.proj.bias"] = _zeros(c, dtype=torch.float32)

    def stage(prefix, plan, upsample: bool):
        for i, spec in enumerate(plan):
            base = f"{prefix}.{i}"
            if spec[0] == "res":
                res(base, spec[1], spec[2])
            else:
                mode, dim = spec[1], spec[2]
                if upsample:
                    conv2(f"{base}.resample.1", dim, dim // 2)
                    if mode == "upsample3d":
                        conv3(f"{base}.time_conv", dim, dim * 2, k=(3, 1, 1))
                else:
                    conv2(f"{base}.resample.1", dim, dim)
                    if mode == "downsample3d":
                        conv3(f"{base}.time_conv", dim, dim, k=(3, 1, 1))

    enc_dims, enc_plan = _encoder_plan(cfg)
    dec_dims, dec_plan = _decoder_plan(cfg)
    z2 = 2 * cfg.z_dim

    conv3("encoder.conv1", 3, enc_dims[0])
    stage("encoder.downsamples", enc_plan, upsample=False)
    res("encoder.middle.0", enc_dims[-1], enc_dims[-1])
    attn("encoder.middle.1", enc_dims[-1])
    res("encoder.middle.2", enc_dims[-1], enc_dims[-1])
    sd["encoder.head.0.gamma"] = _ones(enc_dims[-1], 1, 1, dtype=torch.float32)
    conv3("encoder.head.2", enc_dims[-1], z2)

    conv3("decoder.conv1", cfg.z_dim, dec_dims[0])
    res("decoder.middle.0", dec_dims[0], dec_dims[0])
    attn("decoder.middle.1", dec_dims[0])
    res("decoder.middle.2", dec_dims[0], dec_dims[0])
    stage("decoder.upsamples", dec_plan, upsample=True)
    sd["decoder.head.0.gamma"] = _ones(dec_dims[-1], 1, 1, dtype=torch.float32)
    conv3("decoder.head.2", dec_dims[-1], 3)

    conv3("conv1", z2, z2, k=(1, 1, 1))
    conv3("conv2", cfg.z_dim, cfg.z_dim, k=(1, 1, 1))
    return sd


# ---------------------------------------------------------------------------
# verify: round-trip through the converters, compare to init_* trees
# ---------------------------------------------------------------------------


def tree_leaves(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{"a/b/0/c": leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(tree_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def verify(dit_sd, t5_sd, vae_sd, wan_cfg, t5_cfg, vae_cfg) -> bool:
    """Each converted tree against the port's init tree (the DiT's with q/k/v
    fused, as the converter fuses them): the same leaf names, shapes and
    dtypes. Prints one line per tree; returns whether all three hold."""
    from realtime_video_tpu_torch.models.t5 import init_t5_encoder_params
    from realtime_video_tpu_torch.models.vae import init_vae_params
    from realtime_video_tpu_torch.models.wan_dit import fuse_qkv_params, init_wan_params
    from realtime_video_tpu_torch.utils import checkpoint as ckpt

    gen = torch.Generator().manual_seed(0)
    pairs = [
        ("dit", ckpt.convert_wan_dit(dit_sd, wan_cfg),
         fuse_qkv_params(init_wan_params(wan_cfg, gen, "cpu", torch.bfloat16))),
        ("t5", ckpt.convert_t5_encoder(t5_sd, t5_cfg),
         init_t5_encoder_params(t5_cfg, gen, "cpu", torch.bfloat16)),
        ("vae", ckpt.convert_vae(vae_sd, vae_cfg),
         init_vae_params(vae_cfg, gen, "cpu", torch.float32)),
    ]
    ok = True
    for name, got, want in pairs:
        gs = {k: (tuple(v.shape), v.dtype) for k, v in tree_leaves(got).items()}
        ws = {k: (tuple(v.shape), v.dtype) for k, v in tree_leaves(want).items()}
        missing = sorted(set(ws) - set(gs))
        extra = sorted(set(gs) - set(ws))
        bad = sorted(k for k in set(gs) & set(ws) if gs[k] != ws[k])
        if missing or extra or bad:
            ok = False
            print(f"[{name}] MISMATCH:")
            for k in missing[:10]:
                print(f"  missing from converted: {k} {ws[k]}")
            for k in extra[:10]:
                print(f"  unexpected in converted: {k} {gs[k]}")
            for k in bad[:10]:
                print(f"  shape/dtype: {k} converted={gs[k]} init={ws[k]}")
        else:
            print(f"[{name}] round-trip OK ({len(gs)} leaves)")
    return ok


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.getenv("MODEL_FOLDER", os.path.expanduser("~/models")))
    ap.add_argument("--t5", choices=("tiny", "full"), default="full",
                    help="umT5 size: full=5.7B params (~11 GB), tiny=dev")
    ap.add_argument("--verify", action="store_true",
                    help="tiny-config converter round-trip check, no files")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.verify:
        wan_cfg = WAN_CONFIGS["t2v-tiny"]
        t5_cfg = T5_CONFIGS["t5-tiny"]
        vae_cfg = VAE_CONFIGS["vae-tiny"]
        ok = verify(synth_dit(wan_cfg), synth_t5(t5_cfg), synth_vae(vae_cfg),
                    wan_cfg, t5_cfg, vae_cfg)
        return 0 if ok else 1

    from safetensors.torch import save_file

    os.makedirs(args.out, exist_ok=True)
    dit_path = os.path.join(args.out, DIT_NAME)
    print("synthesizing 1.3B DiT ->", dit_path, flush=True)
    save_file(synth_dit(WAN_CONFIGS["t2v-1.3B"]), dit_path)

    base = os.path.join(args.out, "Wan2.1-T2V-1.3B")
    os.makedirs(base, exist_ok=True)
    vae_path = os.path.join(base, "Wan2.1_VAE.pth")
    print("synthesizing VAE ->", vae_path, flush=True)
    torch.save(synth_vae(VAE_CONFIGS["wan2.1"]), vae_path)

    t5_cfg = T5_CONFIGS["umt5-xxl" if args.t5 == "full" else "t5-tiny"]
    t5_path = os.path.join(base, "models_t5_umt5-xxl-enc-bf16.safetensors")
    print(f"synthesizing umT5 ({args.t5}) ->", t5_path, flush=True)
    save_file(synth_t5(t5_cfg), t5_path)

    print("done. run: MODEL_FOLDER=%s python -m "
          "realtime_video_tpu_torch.scripts.run_real_checkpoint" % args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
