"""Block-causal Wan DiT in PyTorch, bf16 tier (port of realtime_video_tpu/models/wan_dit.py).

Parameters are a plain nested dict of tensors in the JAX package's layout:
transformer blocks stacked on a leading layer axis, linear weights `w` as
[in, out], so a JAX parameter tree converts leaf by leaf
(`utils/convert.py`). The forward is a Python loop over layers; the serving KV cache
(`ops/kv_cache.py`) is written in place, the training cache keeps each
write's tensors. Attention modes:

  * "decode": RoPE offset current_start // fsl; K/V appended at the
    reference's local indices; attention over the window
    [local_end - max_attention_size, local_end) (causal_model.py:349-392);
  * "prefill": K/V written at [0, L), blockwise-causal attention over the
    input (causal_model.py:305-348 + the serving recompute path);
  * "train": no cache; full attention over the input (the 50-step teacher
    and the bidirectional samplers, text2video.py's generate;
    image2video.py's; DMD's score networks), block-causal attention with
    `block_tokens` (the causal losses), or a dense `attn_mask` on the CPU.

An i2v model (`model_type` "i2v") adds the image branch of
WanI2VCrossAttention (model.py:258-300): `img_emb` projects CLIP features
[B, 257, 1280], each layer's `k_img` / `v_img` (and `norm_k_img`) turn them
into cached K/V, and the cross attention adds attn(q, k_img, v_img) to
attn(q, k_txt, v_txt) before its output projection.

The GAN critic's classify forward (`dit_classify`, model.py:775-795) is a
train-mode forward with `gan_classify`: at each tapped layer a register
token cross-attends to the layer's output tokens (`gan_block_apply`; its
Lq = 1 attention in torch ops, `register_attention`, as the JAX package
leaves it to XLA), and a small MLP maps the gathered tokens to logits.

AdaLN modulation is per frame ([B, F, 6, C], causal_model.py:463-491).
Numerics as in the JAX package: params and activations bf16, norms, RoPE and
the time MLP in f32. Attention goes through `ops/attention.py`. A layer's
norm sites (`norm_site`: the residual, LayerNorm and AdaLN or the affine;
the q/k RMSNorm with RoPE) run `ops/hopper_dit_norm.py`'s row kernels where
`hopper_dit_norm.engages` (a bf16 forward on a card with no gradient, and
no tp for q/k), the plain functions below otherwise: the same roundings.

Two tiers of block linears, chosen by the parameters:
  * bf16 (`w`): plain `torch.matmul`, as the JAX package leaves them to `jnp.dot`;
  * int8 (`w_q` [in, out] s8, stored [out, in] so that the kernel reads it
    K-major (`hopper_int8_mm.k_major`), `scale` [out] f32 per output
    channel, `a_scale` a static per-tensor activation scale, or none for a
    per-call amax):
    `quantize_wan_linears` makes them, `calibrate_wan_act_scales` folds the
    calibration records that `dit_forward(act_calib=...)` collects, and
    `linear` runs them through the fused int8 kernel
    (`ops/hopper_int8_mm.py`) on a card, or its plain version on the CPU.

Tensor parallelism (`mesh` with a "tp" axis of size > 1; the tree and the
caches are this rank's slices, `parallel/sharding.py`): a rank attends over
num_heads / tp heads, and the collectives GSPMD places in the JAX package
are explicit (`parallel/collectives.py`):
  * a replicated activation enters the column-parallel linears (q / k / v
    or qkv, cross q, fc1; the text K/V) through `copy_to_tp`;
  * the row-parallel linears (o, cross o, fc2) sum their partial products
    with `reduce_from_tp` and add their bias once, after the sum
    (`row_linear`); an int8 one without a static scale quantises with the
    tp group's MAX of its shards' amax, the scale one device would take;
  * the q/k RMSNorm normalises over the whole width: each rank's sum of
    squares is summed over tp (`rms_norm_tp`), not averaged over its shard;
  * the attention's static logit bound (K1's pre-pass) is MAX-reduced over
    tp before the launch, so every rank runs one device's function.
With tp = 1 (or no mesh) none of this runs.

Sequence parallelism (`sp_attn`, train mode): each rank holds a contiguous
1/sp of the tokens from the patch embedding to the head; `sp_attn` is the
self-attention over the sharded sequence (`parallel/sequence.py`), the
per-frame modulation reads each token's frame index, the RoPE tables are
sliced at the rank's token offset, the cross-attention stays local (every
rank holds the whole text K/V), and the head's tokens are all-gathered.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models.rope import (
    RopeTables,
    rope_apply_fused,
    sinusoidal_embedding_1d,
)
from realtime_video_tpu_torch.ops import attention as attn_ops
from realtime_video_tpu_torch.ops import hopper_dit_norm
from realtime_video_tpu_torch.ops import hopper_int8_mm
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.parallel import collectives as coll
from realtime_video_tpu_torch.parallel import mesh as mesh_mod
from realtime_video_tpu_torch.parallel import sharding
from realtime_video_tpu_torch.utils import trace

Params = Dict[str, Any]

#: width of the CLIP ViT-H/14 features that condition an i2v model
CLIP_DIM = 1280


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def linear(p: Params, x: torch.Tensor, record: Optional[list] = None) -> torch.Tensor:
    """x @ w + b. On int8 weights (`w_q`): quantise x per tensor with the
    static `a_scale`, or with max|x| / 127 taken on the device when there is
    none, then the s8 product and the dequantising epilogue in one kernel
    (wan_dit.py:84-126 of the JAX package). `record`, when given, collects
    max|x| of a float linear for activation calibration."""
    if record is not None and "w" in p:
        record.append(x.float().abs().amax())
    if "w_q" in p:
        a_scale = p["a_scale"] if "a_scale" in p else hopper_int8_mm.dynamic_scale(x)
        return hopper_int8_mm.int8_linear(x, p["w_q"], p["scale"], a_scale, p.get("b"))
    y = torch.matmul(x, p["w"].to(x.dtype))
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _calib_site_order(blocks: Params) -> List[Tuple[str, str]]:
    """The block-linear call order inside one layer of dit_forward (self-attn
    projection(s), o, cross q, cross o, ffn fc1, fc2)."""
    sa = blocks["self_attn"]
    sites = ([("self_attn", "qkv")] if "qkv" in sa else
             [("self_attn", "q"), ("self_attn", "k"), ("self_attn", "v")])
    sites += [("self_attn", "o"), ("cross_attn", "q"), ("cross_attn", "o"),
              ("ffn", "fc1"), ("ffn", "fc2")]
    return sites


def calibrate_wan_act_scales(records: List[torch.Tensor], blocks: Params,
                             num_layers: int) -> Dict[Tuple[str, str], torch.Tensor]:
    """Fold call-order calibration records (one per block linear per layer,
    over >= 1 forwards) into {(group, name): [L] amax}, float64 on the CPU;
    several forwards are max-reduced elementwise."""
    sites = _calib_site_order(blocks)
    per_fwd = num_layers * len(sites)
    if not records or len(records) % per_fwd:
        raise ValueError(f"{len(records)} calibration records do not tile "
                         f"{num_layers} layers x {len(sites)} sites")
    arr = torch.stack([r.reshape(()) for r in records]).double().cpu()
    amax = arr.reshape(-1, num_layers, len(sites)).amax(dim=0)  # [L, sites]
    return {site: amax[:, j] for j, site in enumerate(sites)}


def quantize_wan_linears(params: Params, act_scales: Optional[dict] = None,
                         margin: float = 1.5) -> Params:
    """int8-quantise the transformer block linears (self/cross attention
    projections and FFN) with per-output-channel weight scales, in torch on the
    parameters' device (wan_dit.py:182-242 of the JAX package). Sites in
    `act_scales` ({(group, name): [L] amax}) get a static per-layer activation
    scale amax * margin / 127; the rest quantise with a per-call amax.

    Each stacked weight is quantised a layer at a time: the f32 temporaries of
    a whole [L, in, out] stack (11 GB for the 14B's fc1) would not fit beside
    the model on an 80 GB card. The quanta are those of the whole-stack form.
    Each `w_q` is the [L, in, out] view of [L, out, in] storage, the fused
    int8 kernel's K-major layout (`hopper_int8_mm.k_major`)."""

    def quant(p, a_amax=None):
        w = p["w"]  # [L, in, out]
        wq = torch.empty((w.shape[0], w.shape[2], w.shape[1]), dtype=torch.int8,
                         device=w.device).transpose(1, 2)
        scale = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            wl = w[i].float()
            amax = torch.clamp(wl.abs().amax(dim=0), min=1e-8)
            # a tensor divisor: on a card PyTorch divides by a Python scalar as
            # a multiply by its reciprocal, not the IEEE quotient numpy gives
            scale[i] = amax / torch.full_like(amax, 127.0)
            wq[i] = torch.clamp(torch.round(wl / scale[i]), -127, 127)
        out = {"w_q": wq, "scale": scale}
        if a_amax is not None:
            # float64 on the host, as numpy computes the JAX package's scale
            a = torch.as_tensor(a_amax, dtype=torch.float64, device="cpu")
            out["a_scale"] = (torch.clamp(a, min=1e-6) * margin / 127.0).to(
                device=w.device, dtype=torch.float32)
        if "b" in p:
            out["b"] = p["b"]
        return out

    def is_linear(v):
        return isinstance(v, dict) and "w" in v and v["w"].dim() == 3

    def walk(node, group):
        if is_linear(node):
            return quant(node)
        if not isinstance(node, dict):
            return node
        return {k: quant(v, act_scales[(group, k)])
                if act_scales and (group, k) in act_scales and is_linear(v)
                else walk(v, group) for k, v in node.items()}

    blocks = params["blocks"]
    new_blocks = dict(blocks)
    for key in ("self_attn", "cross_attn", "ffn"):
        new_blocks[key] = walk(blocks[key], key)
    if act_scales and not any(isinstance(v, dict) and "a_scale" in v
                              for g in ("self_attn", "cross_attn", "ffn")
                              for v in new_blocks[g].values()):
        # calibrated on another layout (e.g. unfused q/k/v, then fused)
        raise ValueError("act_scales matched no linear: calibrate and quantise on the "
                         f"same param layout (scale keys: {sorted(act_scales)})")
    return dict(params, blocks=new_blocks)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """WanRMSNorm (model.py:69-85): stats in f32, then * weight."""
    xf = x.float()
    n = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return n.to(x.dtype) * p["scale"].to(x.dtype)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """A forward's tp group: its process group, its size and the heads this
    rank attends over."""

    group: Any
    size: int
    heads: int


def tensor_parallel(cfg: WanModelConfig, mesh) -> Optional[TensorParallel]:
    """The tp group of `mesh` for this model, or None where tp is 1."""
    size = mesh_mod.axis_size(mesh, "tp")
    if size == 1:
        return None
    return TensorParallel(mesh_mod.axis_group(mesh, "tp"), size,
                          sharding.local_heads(cfg.num_heads, mesh))


def rms_norm_tp(p: Params, x: torch.Tensor, dim: int, group, eps: float = 1e-5) -> torch.Tensor:
    """WanRMSNorm of a width-sharded x (this rank's heads of q or k): the
    sum of squares over the whole width `dim`, each rank's share summed over
    tp (a per-rank mean would be another model)."""
    xf = x.float()
    ss = coll.sum_over_tp(xf.square().sum(dim=-1, keepdim=True), group)
    n = xf * torch.rsqrt(ss / dim + eps)
    return n.to(x.dtype) * p["scale"].to(x.dtype)


def row_linear(p: Params, x: torch.Tensor, tp: TensorParallel, lin: Callable) -> torch.Tensor:
    """A row-parallel linear (o, cross o, fc2): x holds this rank's rows of
    the input, the partial products are summed over tp and the bias is added
    once, after the sum. An int8 one without a static activation scale
    quantises with the MAX over tp of its shards' scales, one device's."""
    part = {k: v for k, v in p.items() if k != "b"}
    if "w_q" in part and "a_scale" not in part:
        part["a_scale"] = coll.all_reduce_max_(hopper_int8_mm.dynamic_scale(x).detach(),
                                               tp.group)
    y = coll.reduce_from_tp(lin(part, x), tp.group)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, scale: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """WanLayerNorm (model.py:88-98): f32 stats, optional affine."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    if scale is not None:
        y = y * scale.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def modulate(x: torch.Tensor, num_frames, shift: torch.Tensor,
             scale: torch.Tensor) -> torch.Tensor:
    """Per-frame AdaLN: x [B, L, D] viewed as [B, F, L/F, D];
    x * (1 + scale) + shift (causal_model.py:471). `num_frames` may be each
    token's frame index ([L] long: a sequence-parallel shard of tokens)."""
    if isinstance(num_frames, torch.Tensor):
        return x * (1.0 + scale[:, num_frames].to(x.dtype)) + shift[:, num_frames].to(x.dtype)
    b, L, d = x.shape
    xf = x.reshape(b, num_frames, L // num_frames, d)
    y = xf * (1.0 + scale[:, :, None, :].to(x.dtype)) + shift[:, :, None, :].to(x.dtype)
    return y.reshape(b, L, d)


def gate(x: torch.Tensor, num_frames, g: torch.Tensor) -> torch.Tensor:
    if isinstance(num_frames, torch.Tensor):  # each token's frame index
        return x * g[:, num_frames].to(x.dtype)
    b, L, d = x.shape
    xf = x.reshape(b, num_frames, L // num_frames, d)
    return (xf * g[:, :, None, :].to(x.dtype)).reshape(b, L, d)


def norm_site(tokens: torch.Tensor, f, eps: float, y: Optional[torch.Tensor] = None,
              g: Optional[torch.Tensor] = None, shift: Optional[torch.Tensor] = None,
              scale: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              norm: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One norm site of a layer: (tokens, out), tokens + gate(y, f, g) (+ y
    without g, tokens itself without y), and out = modulate(layer_norm(
    tokens), f, shift, scale), or layer_norm with the affine weight / bias
    (None with norm=False). One launch of `hopper_dit_norm.add_ln_modulate`
    where it engages, else these functions."""
    if hopper_dit_norm.engages("add_ln_modulate", tokens, y, g, shift, scale, weight, bias,
                               frames=f):
        return hopper_dit_norm.add_ln_modulate(tokens, f, y, g, shift, scale, weight, bias,
                                               eps=eps, norm=norm)
    if y is not None:
        tokens = tokens + (y if g is None else gate(y, f, g))
    if not norm:
        return tokens, None
    out = layer_norm(tokens, weight, bias, eps=eps)
    return tokens, (out if shift is None else modulate(out, f, shift, scale))


# ---------------------------------------------------------------------------
# parameter init / structure
# ---------------------------------------------------------------------------


def _init_linear(gen, shape_in_out, dtype, device, init="xavier", bias=True,
                 layers: Optional[int] = None) -> Params:
    d_in, d_out = shape_in_out
    shape = (d_in, d_out) if layers is None else (layers, d_in, d_out)
    if init == "xavier":
        lim = math.sqrt(6.0 / (d_in + d_out))
        w = torch.empty(shape, dtype=torch.float32, device=device).uniform_(
            -lim, lim, generator=gen)
    elif init == "normal02":
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * 0.02
    elif init == "zeros":
        w = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        raise ValueError(init)
    p = {"w": w.to(dtype)}
    if bias:
        bshape = (d_out,) if layers is None else (layers, d_out)
        p["b"] = torch.zeros(bshape, dtype=dtype, device=device)
    return p


def init_wan_params(cfg: WanModelConfig, generator: torch.Generator, device=None,
                    dtype=torch.bfloat16) -> Params:
    """Random init with the structure and distributions of the JAX package's
    init_wan_params (causal_model.py:1151-1173), drawn from `generator` and
    made directly on `device`. An i2v model also gets the image branch:
    `cross_attn.k_img` / `v_img` / `norm_k_img` per layer and the top-level
    `img_emb` (the JAX package's shapes: fc1 1280 -> dim, fc2 dim -> dim)."""
    if cfg.model_type not in ("t2v", "i2v"):
        raise ValueError(f"model_type {cfg.model_type!r}: 't2v' or 'i2v'")
    d, ffn, nl = cfg.dim, cfg.ffn_dim, cfg.num_layers
    pt, ph, pw = cfg.patch_size
    g, dev = generator, device

    def lin(din, dout, **kw):
        return _init_linear(g, (din, dout), dtype, dev, layers=nl, **kw)

    def ones(n):
        return {"scale": torch.ones((nl, n), dtype=dtype, device=dev)}

    def attn_block():
        return {"q": lin(d, d), "k": lin(d, d), "v": lin(d, d), "o": lin(d, d),
                "norm_q": ones(d), "norm_k": ones(d)}

    cross = attn_block()
    if cfg.model_type == "i2v":
        cross.update(k_img=lin(d, d), v_img=lin(d, d), norm_k_img=ones(d))
    blocks = {
        "self_attn": attn_block(),
        "cross_attn": cross,
        "ffn": {"fc1": lin(d, ffn), "fc2": lin(ffn, d)},
        "modulation": torch.randn((nl, 1, 6, d), generator=g, dtype=torch.float32,
                                  device=dev) / d**0.5,
    }
    if cfg.cross_attn_norm:
        blocks["norm3"] = {"scale": torch.ones((nl, d), dtype=dtype, device=dev),
                           "bias": torch.zeros((nl, d), dtype=dtype, device=dev)}
    params = {
        "patch_embedding": _init_linear(g, (cfg.in_dim * pt * ph * pw, d), dtype, dev),
        "text_embedding": {
            "fc1": _init_linear(g, (cfg.text_dim, d), dtype, dev, "normal02"),
            "fc2": _init_linear(g, (d, d), dtype, dev, "normal02"),
        },
        "time_embedding": {
            "fc1": _init_linear(g, (cfg.freq_dim, d), torch.float32, dev, "normal02"),
            "fc2": _init_linear(g, (d, d), torch.float32, dev, "normal02"),
        },
        "time_projection": {"fc": _init_linear(g, (d, 6 * d), torch.float32, dev)},
        "blocks": blocks,
        "head": {
            "head": _init_linear(g, (d, math.prod(cfg.patch_size) * cfg.out_dim),
                                 dtype, dev, "zeros"),
            "modulation": torch.randn((1, 2, d), generator=g, dtype=torch.float32,
                                      device=dev) / d**0.5,
        },
    }
    if cfg.model_type == "i2v":
        def affine(n):
            return {"scale": torch.ones((n,), dtype=dtype, device=dev),
                    "bias": torch.zeros((n,), dtype=dtype, device=dev)}

        params["img_emb"] = {"norm1": affine(CLIP_DIM),
                             "fc1": _init_linear(g, (CLIP_DIM, d), dtype, dev),
                             "fc2": _init_linear(g, (d, d), dtype, dev),
                             "norm2": affine(d)}
    return params


def fuse_qkv_params(params: Params) -> Params:
    """Fuse self-attention q/k/v into one [L, D, 3D] projection (reference
    fuse_projections, causal_model.py:203-216); the split weights are dropped."""
    sa = params["blocks"]["self_attn"]
    if "qkv" in sa:
        return params
    fused = {
        "w": torch.cat([sa["q"]["w"], sa["k"]["w"], sa["v"]["w"]], dim=-1),
        "b": torch.cat([sa["q"]["b"], sa["k"]["b"], sa["v"]["b"]], dim=-1),
    }
    new_sa = {k: v for k, v in sa.items() if k not in ("q", "k", "v")}
    new_sa["qkv"] = fused
    return dict(params, blocks=dict(params["blocks"], self_attn=new_sa))


def _layer_views(tree, num_layers: int) -> list:
    """A layer-stacked tree as one tree per layer (views, no copies). Each
    leaf is unbound once, so the gradient of every layer's view reaches the
    stacked leaf through one stacking backward, not one full-size select
    backward a layer."""
    if isinstance(tree, dict):
        per_key = {k: _layer_views(v, num_layers) for k, v in tree.items()}
        return [{k: per_key[k][i] for k in tree} for i in range(num_layers)]
    return list(tree.unbind(0))


def layer_params(params: Params, num_layers: int) -> List[Params]:
    return _layer_views(params["blocks"], num_layers)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def patchify(cfg: WanModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, F, C, H, W] latents -> [B, F*h*w, D] tokens (the (1,2,2) Conv3d
    patch embedding as reshape + matmul)."""
    pt, ph, pw = cfg.patch_size
    if pt != 1:
        raise ValueError("temporal patch size must be 1 (Wan uses (1,2,2))")
    b, f, c, H, W = x.shape
    h, w = H // ph, W // pw
    xt = x.reshape(b, f, c, h, ph, w, pw).permute(0, 1, 3, 5, 2, 4, 6)
    tokens = xt.reshape(b, f * h * w, c * ph * pw)
    return linear(params["patch_embedding"], tokens)


def unpatchify(cfg: WanModelConfig, x: torch.Tensor,
               grid: Tuple[int, int, int]) -> torch.Tensor:
    """[B, L, prod(patch)*out] -> [B, F, out, H, W] (causal_model.py:1126-1149)."""
    f, h, w = grid
    pt, ph, pw = cfg.patch_size
    c = cfg.out_dim
    b = x.shape[0]
    y = x.reshape(b, f, h, w, pt, ph, pw, c).permute(0, 1, 4, 7, 2, 5, 3, 6)
    return y.reshape(b, f * pt, c, h * ph, w * pw)


def time_embeddings(cfg: WanModelConfig, params: Params,
                    t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """t [B, F] -> (e [B, F, D] f32, e0 [B, F, 6, D] f32)."""
    b, f = t.shape
    sin = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1))
    te = params["time_embedding"]
    e = linear(te["fc2"], F.silu(linear(te["fc1"], sin)))
    e0 = linear(params["time_projection"]["fc"], F.silu(e))
    return e.reshape(b, f, cfg.dim), e0.reshape(b, f, 6, cfg.dim)


def text_embedding(cfg: WanModelConfig, params: Params, context: torch.Tensor) -> torch.Tensor:
    """[B, T, text_dim] -> [B, T, D] (causal_model.py:616-618, 897-902)."""
    te = params["text_embedding"]
    return linear(te["fc2"], gelu_tanh(linear(te["fc1"], context)))


def img_embedding(params: Params, clip_fea: torch.Tensor) -> torch.Tensor:
    """MLPProj for i2v CLIP features [B, 257, 1280] -> [B, 257, D]
    (model.py:503-515, in the JAX package's form: gelu_tanh between fc1 and fc2)."""
    p = params["img_emb"]
    x = layer_norm(clip_fea, p["norm1"]["scale"], p["norm1"]["bias"])
    x = linear(p["fc2"], gelu_tanh(linear(p["fc1"], x)))
    return layer_norm(x, p["norm2"]["scale"], p["norm2"]["bias"])


def compute_crossattn_cache(cfg: WanModelConfig, params: Params, context: torch.Tensor,
                            clip_fea: Optional[torch.Tensor] = None,
                            mesh=None) -> Dict[str, torch.Tensor]:
    """Per-layer text K/V [L, B, T, N, Dh], computed once per prompt. An i2v
    model given `clip_fea` [B, 257, 1280] also caches the image K/V
    `k_img` / `v_img` [L, B, 257, N, Dh] of its projected features. Under
    tp (`mesh`; `params` this rank's slice) the cache holds this rank's
    N / tp heads, the norm over the whole width."""
    tp = tensor_parallel(cfg, mesh)
    ctx = text_embedding(cfg, params, context)  # [B, T, D]
    ca = params["blocks"]["cross_attn"]
    n, dh, nl = cfg.num_heads if tp is None else tp.heads, cfg.head_dim, cfg.num_layers
    norm = rms_norm if tp is None else functools.partial(rms_norm_tp, dim=cfg.dim, group=tp.group)

    def project(pp, src):
        """src @ w for every layer, a layer at a time: int8 weights are
        dequantised for this once-per-prompt product, and a whole 14B stack
        in f32 would take 8 GB."""
        def dense_w(i):
            if "w_q" in pp:
                return (pp["w_q"][i].float() * pp["scale"][i]).to(src.dtype)
            return pp["w"][i].to(src.dtype)
        y = torch.stack([torch.matmul(src, dense_w(i)) for i in range(nl)])
        return y + pp["b"].to(src.dtype)[:, None, None, :]

    def kv(src, k_name, v_name, norm_name):
        b, T, _ = src.shape
        if tp is not None:
            src = coll.copy_to_tp(src, tp.group)
        k = norm({"scale": ca[norm_name]["scale"][:, None, None, :]},
                 project(ca[k_name], src))
        v = project(ca[v_name], src)
        return k.reshape(nl, b, T, n, dh).contiguous(), v.reshape(nl, b, T, n, dh).contiguous()

    cache = dict(zip(("k", "v"), kv(ctx, "k", "v", "norm_k")))
    if clip_fea is not None and cfg.model_type == "i2v":
        img_ctx = img_embedding(params, clip_fea.to(ctx.dtype))  # [B, 257, D]
        cache["k_img"], cache["v_img"] = kv(img_ctx, "k_img", "v_img", "norm_k_img")
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block(cfg: WanModelConfig, bp: Params, tokens: torch.Tensor, f,
           e0: torch.Tensor, rope: Tuple[torch.Tensor, torch.Tensor],
           cross: Tuple[torch.Tensor, ...], attend: Callable, lin: Callable,
           tp: Optional[TensorParallel] = None):
    """One transformer layer (causal_model.py:436-493): returns (tokens, k, v),
    k and v the layer's roped self-attention keys and values. `attend(q, k,
    v)` is the self-attention of the mode (it may write a cache); `cross` is
    the layer's text K/V, and an i2v model's image K/V after them. `f` is
    the frame count, or each token's frame index (see `modulate`). With `tp`
    the layer runs on this rank's heads and FFN columns (module note)."""
    b, L, _ = tokens.shape
    n, dh = cfg.num_heads if tp is None else tp.heads, cfg.head_dim
    if tp is None:
        enter, norm, out_lin, bound = (lambda x: x), rms_norm, lin, None
    else:
        enter = functools.partial(coll.copy_to_tp, group=tp.group)
        norm = functools.partial(rms_norm_tp, dim=cfg.dim, group=tp.group)
        out_lin = functools.partial(row_linear, tp=tp, lin=lin)
        bound = tp.group
    em = bp["modulation"][None].float() + e0  # [B, F, 6, D]
    sh_msa, sc_msa, g_msa = em[:, :, 0], em[:, :, 1], em[:, :, 2]
    sh_ffn, sc_ffn, g_ffn = em[:, :, 3], em[:, :, 4], em[:, :, 5]

    def qk_norm(q, k, p_q, p_k=None, tables=None):
        """The q (and k) RMSNorm over the whole width, then RoPE with
        `tables` (none without), as [B, L, N, Dh]: one launch of
        `hopper_dit_norm.qk_norm_rope` where it engages."""
        w_q, w_k = p_q["scale"], None if p_k is None else p_k["scale"]
        if hopper_dit_norm.engages("qk_norm_rope", q, k, w_q, w_k, tp=tp, head_dim=dh):
            return hopper_dit_norm.qk_norm_rope(q, k, w_q, w_k, tables, dh, eps=cfg.eps)

        def one(x, p):
            x = norm(p, x, eps=cfg.eps).reshape(b, L, n, dh)
            return x if tables is None else rope_apply_fused(x, *tables)

        return one(q, p_q), None if k is None else one(k, p_k)

    # ---- self attention ----
    _, xn = norm_site(tokens, f, cfg.eps, shift=sh_msa, scale=sc_msa)
    xn = enter(xn)
    sa = bp["self_attn"]
    if "qkv" in sa:
        q, k, v = lin(sa["qkv"], xn).chunk(3, dim=-1)
    else:
        q, k, v = lin(sa["q"], xn), lin(sa["k"], xn), lin(sa["v"], xn)
    q, k = qk_norm(q, k, sa["norm_q"], sa["norm_k"], rope)
    v = v.reshape(b, L, n, dh)
    y = attend(q, k, v)
    y = out_lin(sa["o"], y.reshape(b, L, n * dh))

    # ---- cross attention over the cached text K/V ----
    ca = bp["cross_attn"]
    n3 = bp["norm3"] if cfg.cross_attn_norm else {}
    tokens, xc = norm_site(tokens, f, cfg.eps, y, g_msa, weight=n3.get("scale"),
                           bias=n3.get("bias"), norm=cfg.cross_attn_norm)
    qc, _ = qk_norm(lin(ca["q"], enter(tokens if xc is None else xc)), None, ca["norm_q"])
    yc = attn_ops.attention(qc, cross[0].to(qc.dtype), cross[1].to(qc.dtype), bound_group=bound)
    if len(cross) == 4:  # i2v: the image tokens, before o
        yc = yc + attn_ops.attention(qc, cross[2].to(qc.dtype), cross[3].to(qc.dtype),
                                     bound_group=bound)

    # ---- ffn ----
    tokens, xf2 = norm_site(tokens, f, cfg.eps, out_lin(ca["o"], yc.reshape(b, L, n * dh)),
                            shift=sh_ffn, scale=sc_ffn)
    ff = bp["ffn"]
    y = out_lin(ff["fc2"], gelu_tanh(lin(ff["fc1"], enter(xf2))))
    tokens, _ = norm_site(tokens, f, cfg.eps, y, g_ffn, norm=False)
    return tokens, k, v


def register_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of a few query tokens (the GAN register token, Lq =
    1) over every key, in torch ops: f32 logits and softmax, the
    probabilities cast to v's dtype, f32 sums (`xla_attention`,
    ops/attention.py:72-95 of the JAX package, which runs no Pallas kernel
    here). q [B, Lq, N, D], k/v [B, Lk, N, D]."""
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def gan_block_apply(cfg: WanModelConfig, p: Params, x: torch.Tensor,
                    register: torch.Tensor) -> torch.Tensor:
    """GanAttentionBlock (model.py:391-470): the register token cross-attends
    to a layer's output tokens; token = reg + attn(norm3(x), reg), then
    ffn(layer_norm(token)) + token. x [B, L, D]; register [B, 1, D]; returns
    [B, 1, D]."""
    b, L, d = x.shape
    n, dh = cfg.num_heads, cfg.head_dim
    xn = layer_norm(x, p["norm3"]["scale"], p["norm3"]["bias"], eps=cfg.eps)
    ca = p["cross_attn"]
    q = rms_norm(ca["norm_q"], linear(ca["q"], register), eps=cfg.eps).reshape(b, 1, n, dh)
    k = rms_norm(ca["norm_k"], linear(ca["k"], xn), eps=cfg.eps).reshape(b, L, n, dh)
    v = linear(ca["v"], xn).reshape(b, L, n, dh)
    y = register_attention(q, k, v)
    token = register + linear(ca["o"], y.reshape(b, 1, d))
    tn = layer_norm(token, eps=cfg.eps)
    ff = p["ffn"]
    return linear(ff["fc2"], gelu_tanh(linear(ff["fc1"], tn))) + token


def dit_forward(
    cfg: WanModelConfig,
    params: Params,
    x: torch.Tensor,  # [B, F, C, H, W]
    t: torch.Tensor,  # [B, F] float32 timesteps
    rope_tables: RopeTables,
    crossattn_cache: Dict[str, torch.Tensor],
    mode: str = "decode",
    kv_cache: Optional[Dict] = None,
    current_start: int = 0,
    max_attention_size: Optional[int] = None,
    sink_tokens: int = 0,
    rolling: bool = False,
    prefill_block_tokens: Optional[int] = None,
    layers: Optional[List[Params]] = None,
    act_calib: Optional[list] = None,
    attn_mask: Optional[torch.Tensor] = None,
    block_tokens: Optional[int] = None,
    gan_classify: Optional[Params] = None,
    tf_concat: bool = False,
    mesh=None,
    sp_attn=None,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One transformer forward. Returns (flow_pred [B, F, C, H, W], kv_cache),
    the cache updated (None in train mode); with `gan_classify` (taps,
    registers, blocks, cls_head, concat_time: `dit_classify` builds it),
    (flow_pred, logits [B, num_class]) instead. `layers` may carry precomputed
    per-layer views of params["blocks"] (`layer_params`). `act_calib`, when
    given, receives max|input| of every block linear, layer by layer in
    `_calib_site_order`.

    Train mode takes no cache. Its self-attention is unmasked by default
    (K1's window over every key on a card); `block_tokens` makes it
    block-causal (key < ends[q] | q == key, the JAX package's
    `blockwise_causal_mask` given as structure: K2's block-causal mode);
    `attn_mask` ([L, L] bool, True = attend) is the dense form, CPU only.

    `tf_concat` (train mode only) is teacher forcing (causal_model.py:
    1060-1108): x is [clean | noisy] along frames and t [B, 2F]; RoPE runs
    on F frames and repeats its positions for the two halves; the
    self-attention is `teacher_forcing_attention` over blocks of
    `block_tokens` (the kernel's mode 2 on a card), or the dense
    `attn_mask` (CPU only); the head keeps the noisy half, so the flow is
    [B, F, C, H, W].

    Decode mode takes the serving cache (`kv_cache.init_kv_cache`, written
    in place, no gradient through it) or the training cache
    (`kv_cache.init_train_kv_cache`, which keeps each write's K/V tensors and
    attends over their concatenation, so the gradient flows into the cached
    K/V). With grad enabled, a layer whose input carries a graph runs under
    `torch.utils.checkpoint` (non-reentrant): the same values and gradients,
    its activations recomputed in the backward, so that a full-width
    training step fits one card; under tp the recompute issues the layer's
    collectives again, in the same order on every rank.

    `mesh` with a "tp" axis of size > 1 runs the tensor-parallel forward on
    this rank's slice of the tree (`params`, `layers`, the caches: see the
    module note); `sp_attn` (train mode, no mask) the sequence-parallel one:
    x and t whole on every rank, this rank's tokens through the layers,
    the flow whole again after the head."""
    tp = tensor_parallel(cfg, mesh)
    if tp is not None and (act_calib is not None or gan_classify is not None):
        raise ValueError("tensor parallelism runs the decode, prefill and train forwards; "
                         "calibrate and classify on one device")
    if sp_attn is not None and (mode != "train" or attn_mask is not None or tf_concat
                                or block_tokens is not None or gan_classify is not None
                                or tp is not None):
        raise ValueError("sp_attn is the unmasked train-mode forward's self-attention, "
                         "without tp")
    train_cache = kv_cache is not None and kvc.is_train_cache(kv_cache)
    if mode == "train":
        if kv_cache is not None:
            raise ValueError("train mode takes no kv_cache")
        if attn_mask is not None and block_tokens is not None:
            raise ValueError("give attn_mask or block_tokens, not both")
    elif kv_cache is None:
        raise ValueError(f"{mode!r} mode needs a kv_cache")
    elif attn_mask is not None or block_tokens is not None:
        raise ValueError("attn_mask and block_tokens apply in train mode only")
    elif train_cache and mode != "decode":
        raise ValueError("the training cache takes decode mode only")
    b, f, c, H, W = x.shape
    if tf_concat:
        if mode != "train":
            raise ValueError(f"tf_concat is a train-mode forward, not {mode!r}")
        if f % 2:
            raise ValueError(f"tf_concat needs [clean | noisy] frames, got {f}")
        if attn_mask is None and block_tokens is None:
            raise ValueError("tf_concat needs block_tokens (or a dense attn_mask on the CPU)")
    pt, ph, pw = cfg.patch_size
    # teacher forcing: RoPE positions repeat for the two halves
    grid = (f // 2 if tf_concat else f, H // ph, W // pw)
    fsl = grid[1] * grid[2]
    L = f * fsl
    current_start = int(current_start)

    tokens = patchify(cfg, params, x)
    e, e0 = time_embeddings(cfg, params, t)
    frames = f
    if sp_attn is not None:
        # this rank's contiguous share of the tokens (xdit_context_parallel.py:130-133)
        if L % sp_attn.size:
            raise ValueError(f"{L} tokens do not split over sp={sp_attn.size}")
        share = L // sp_attn.size
        offset = sp_attn.rank * share
        tokens = tokens[:, offset:offset + share].contiguous()
        frames = torch.arange(offset, offset + share, device=tokens.device) // fsl

    cache_size = 0 if kv_cache is None else kvc.cache_size(kv_cache)
    if mode == "decode":
        if max_attention_size is None:
            raise ValueError("decode mode needs max_attention_size")
        start_frame = current_start // fsl
        win = min(max_attention_size, cache_size)
        if train_cache:
            new_global_end = new_local_end = current_start + L
        else:
            shift, write_start, new_global_end, new_local_end = kvc.plan_kv_update(
                kv_cache, current_start, L, cache_size, sink_tokens, rolling)
            win_start = min(max(new_local_end - win, 0), cache_size - win)
            dec_lo = max(new_local_end - max_attention_size, 0) - win_start
            dec_hi = new_local_end - win_start
    elif mode == "prefill":
        if prefill_block_tokens is None:
            raise ValueError("prefill mode needs prefill_block_tokens")
        start_frame, write_start, shift = 0, 0, 0
        new_global_end = new_local_end = L
    elif mode == "train":
        start_frame = 0
    else:
        raise ValueError(f"mode {mode!r}: the port runs 'decode', 'prefill' and 'train'")
    if mode != "train" and not train_cache and (write_start < 0 or write_start + L > cache_size):
        raise ValueError(f"cache write [{write_start}, {write_start + L}) outside "
                         f"the {cache_size}-token cache")

    rope = rope_tables.fused(*grid, start_frame)
    if tf_concat:
        rope = tuple(torch.cat([r, r]) for r in rope)
    if sp_attn is not None:
        rope = tuple(r[offset:offset + share] for r in rope)
    if layers is None:
        layers = layer_params(params, cfg.num_layers)
    lin = linear if act_calib is None else functools.partial(linear, record=act_calib)
    bound = None if tp is None else tp.group

    def train_attend(q, k, v):
        if sp_attn is not None:
            return sp_attn(q, k, v)
        if tf_concat and attn_mask is None:
            return attn_ops.teacher_forcing_attention(q, k.contiguous(), v.contiguous(),
                                                      L // 2, block_tokens)
        if block_tokens is not None:
            return attn_ops.block_causal_attention(q, k.contiguous(), v.contiguous(),
                                                   block_tokens)
        mask = None if attn_mask is None else attn_mask[None, None]
        return attn_ops.attention(q, k.contiguous(), v.contiguous(), mask=mask,
                                  bound_group=bound)

    def prefix_attend(prefix_k, prefix_v, q, k, v):
        wk = torch.cat([*prefix_k, k.to(q.dtype)], 1)
        wv = torch.cat([*prefix_v, v.to(q.dtype)], 1)
        return attn_ops.decode_attention(q, wk, wv, 0, wk.shape[1], bound_group=bound)

    def cache_attend(lid, q, k, v):
        if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
            raise RuntimeError("the serving KV cache is written in place and carries no "
                               "gradient: decode with kv_cache.init_train_kv_cache to train")
        ck, cv = kv_cache["k"][lid], kv_cache["v"][lid]  # [B, S, N, Dh] views
        if mode == "decode" and rolling and shift:
            ck.copy_(kvc.shift_layer_cache(ck, shift, sink_tokens))
            cv.copy_(kvc.shift_layer_cache(cv, shift, sink_tokens))
        ck[:, write_start:write_start + L] = k.to(ck.dtype)
        cv[:, write_start:write_start + L] = v.to(cv.dtype)
        if mode == "prefill":
            return attn_ops.block_causal_attention(q, k.contiguous(), v.contiguous(),
                                                   prefill_block_tokens)
        wk = ck[:, win_start:win_start + win].to(q.dtype).contiguous()
        wv = cv[:, win_start:win_start + win].to(q.dtype).contiguous()
        return attn_ops.decode_attention(q, wk, wv, dec_lo, dec_hi, bound_group=bound)

    cross_names = ("k", "v") + (("k_img", "v_img") if "k_img" in crossattn_cache else ())
    tap_out: Dict[int, torch.Tensor] = {}
    for lid, bp in enumerate(layers):
        if mode == "train":
            attend = train_attend
        elif train_cache:
            attend = functools.partial(prefix_attend, *kvc.train_cache_prefix(
                kv_cache, lid, current_start, win - L))
        else:
            attend = functools.partial(cache_attend, lid)
        cross = tuple(crossattn_cache[name][lid] for name in cross_names)
        run = functools.partial(_block, cfg, bp, f=frames, e0=e0, rope=rope, cross=cross,
                                attend=attend, lin=lin, tp=tp)
        if torch.is_grad_enabled() and tokens.requires_grad:
            tokens, k, v = torch.utils.checkpoint.checkpoint(run, tokens, use_reentrant=False)
        else:
            tokens, k, v = run(tokens)
        if train_cache:
            kvc.train_cache_write(kv_cache, lid, current_start, k, v, win)
        if gan_classify is not None and lid in gan_classify["taps"]:
            # the critic's feature tap (model.py:785-789) reads the layer's
            # output, outside the layer's checkpoint; a repeated tap takes the
            # last of its register tokens, as the JAX package's switch does
            i = len(gan_classify["taps"]) - 1 - gan_classify["taps"][::-1].index(lid)
            reg = gan_classify["registers"][i][None, None].to(tokens.dtype).expand(
                b, 1, cfg.dim)
            tap_out[lid] = gan_block_apply(cfg, gan_classify["blocks"][i], tokens, reg)

    if kv_cache is not None:
        kv_cache["global_end"] = new_global_end
        kv_cache["local_end"] = new_local_end

    # ---- head (CausalHead, causal_model.py:495-523) ----
    if tf_concat:  # the noisy half (causal_model.py:1104-1108)
        tokens, e, f = tokens[:, L // 2:], e[:, f // 2:], f // 2
    hp = params["head"]
    eh = hp["modulation"][None].float() + e[:, :, None, :]  # [B, F, 2, D]
    _, yh = norm_site(tokens, frames if sp_attn is not None else f, cfg.eps,
                      shift=eh[:, :, 0], scale=eh[:, :, 1])
    out = linear(hp["head"], yh)
    if sp_attn is not None and sp_attn.size > 1:
        # the head is per token, so its output is gathered, not its 1536-wide
        # input (xdit_context_parallel.py:141-142)
        out = coll.all_gather(out, 1, sp_attn.gather_group)
    flow = unpatchify(cfg, out, grid)
    if gan_classify is None:
        return flow, kv_cache
    # the class head over the gathered taps (model.py:790-795)
    flat = torch.cat([tap_out[tl] for tl in gan_classify["taps"]], dim=1).reshape(b, -1)
    if gan_classify.get("concat_time", False):
        flat = torch.cat([flat, 10.0 * e[:, 0].to(flat.dtype)], dim=-1)
    cp = gan_classify["cls_head"]
    hcls = layer_norm(flat, cp["norm"]["scale"], cp["norm"]["bias"], eps=1e-5)
    return flow, linear(cp["fc2"], F.silu(linear(cp["fc1"], hcls)))


def context_prefill(
    cfg: WanModelConfig,
    params: Params,
    clean_ctx: torch.Tensor,  # [B, F_ctx, C, H, W]
    rope_tables: RopeTables,
    crossattn_cache: Dict[str, torch.Tensor],
    kv_cache: Dict,
    block_tokens: int,
    layers: Optional[List[Params]] = None,
    mesh=None,
) -> Dict:
    """Write clean-context K/V into a freshly reset cache (the serving
    recompute path, release_server.py:588-633), always through the
    block-causal kernel.

    The JAX package takes a decode-mode forward at current_start=0 when the
    context fits in one block, because that compiled program is faster on the
    TPU. The math is the same: over one block the block-causal mask is dense,
    and both forms write K/V at [0, L) and leave both cache ends at L. Its
    span: `dit.prefill`."""
    with trace.span("dit.prefill"):
        b, f = clean_ctx.shape[:2]
        t0 = torch.zeros((b, f), dtype=torch.float32, device=clean_ctx.device)
        _, kv = dit_forward(cfg, params, clean_ctx, t0, rope_tables, crossattn_cache,
                            mode="prefill", kv_cache=kv_cache,
                            prefill_block_tokens=block_tokens, layers=layers, mesh=mesh)
    return kv


def dit_classify(cfg: WanModelConfig, params: Params, noisy: torch.Tensor, t: torch.Tensor,
                 rope_tables: RopeTables, crossattn_cache: Dict[str, torch.Tensor],
                 gan_params: Params, taps: Tuple[int, ...] = (13, 21, 29),
                 concat_time: bool = False) -> torch.Tensor:
    """Discriminator logits [B, num_class] (the classify-mode forward,
    model.py:775-795): a train-mode forward with no mask, no cache, whose
    tapped layers feed the register tokens (rms-normed, eps 1e-6)."""
    registers = rms_norm(gan_params["register_norm"], gan_params["register_tokens"], eps=1e-6)
    _, logits = dit_forward(
        cfg, params, noisy, t.float(), rope_tables, crossattn_cache, mode="train",
        gan_classify={"taps": tuple(taps), "registers": registers,
                      "blocks": gan_params["blocks"], "cls_head": gan_params["cls_head"],
                      "concat_time": concat_time})
    return logits
