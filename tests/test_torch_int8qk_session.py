"""A session step of a small DiT with the int8 QK^T attention (INT8_QK) on in
both packages, on the CPU in f32: reset, block-causal prefill of 3 clean
frames, then a decode forward of a noisy block over the 6-frame window, as
`GenerationSession.block_step` runs them. Every attention call (self, cross,
prefill) takes the int8 mode: on the JAX side through the Pallas kernel in
TPU interpret mode (`attn_ops._use_pallas` set to True for the test; nothing
in the JAX package changes), on the port's through the plain int8 version.
The JAX package prefills one block of context with a decode-mode forward
over the cache window, the port with its block-causal kernel: over a freshly
zeroed cache the two mean the same segments (rows past the context are
zeros in the one and the zero pad in the other), so the results agree.

Tolerance: relative Frobenius error 1e-4 on the flow and on the KV cache,
at least 10 times below the flow's int8-vs-float gap (1.3e-3 here: the
attention is a small part of each residual update), which the test measures
on the JAX side; the port sits at 4e-5, the rare quantum that the segment
means' summation order moves. Heads are 128 wide, as in every Wan DiT."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.rope import RopeTables as JRope
from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu.ops import kv_cache as jkvc
from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.config import WanModelConfig as TCfg
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.rope import RopeTables as TRope
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.ops import kv_cache as tkvc
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

DIMS = dict(dim=256, ffn_dim=512, num_heads=2, num_layers=2)
LAT = 8
REL_FRO = 1e-4


def rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_step(cfg, params, cross, ctx, x, t, fsl):
    kv = jkvc.init_kv_cache(cfg.num_layers, 1, 6 * fsl, cfg.num_heads, cfg.head_dim,
                            jnp.float32)
    rope = JRope.create(cfg.head_dim)
    kv = jdit.context_prefill(cfg, params, jnp.asarray(ctx), rope, cross, kv,
                              block_tokens=3 * fsl, max_attention_size=6 * fsl)
    flow, kv = jdit.dit_forward(cfg, params, jnp.asarray(x), jnp.asarray(t), rope, cross,
                                mode="decode", kv_cache=kv, current_start=3 * fsl,
                                max_attention_size=6 * fsl)
    return np.asarray(flow), np.asarray(kv["k"])


@pytest.fixture(scope="module")
def small():
    jcfg, tcfg = JCfg(**DIMS), TCfg(**DIMS)
    jp = jdit.init_wan_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    jp["head"]["head"]["w"] = jnp.asarray(rng.normal(0, 0.05, jp["head"]["head"]["w"].shape),
                                          jnp.float32)
    jp = jdit.fuse_qkv_params(jp)
    tp = wan_params_from_jax(jax.device_get(jp))
    ctx_emb = rng.normal(size=(1, 16, jcfg.text_dim)).astype(np.float32)
    fsl = jcfg.frame_seq_length(LAT, LAT)
    clean = rng.normal(size=(1, 3, jcfg.in_dim, LAT, LAT)).astype(np.float32)
    noisy = rng.normal(size=(1, 3, jcfg.in_dim, LAT, LAT)).astype(np.float32)
    t = np.full((1, 3), 937.5, np.float32)
    return jcfg, tcfg, jp, tp, ctx_emb, fsl, clean, noisy, t


def test_session_step_int8qk_matches_jax(monkeypatch, small):
    jcfg, tcfg, jp, tp, ctx_emb, fsl, clean, noisy, t = small
    monkeypatch.setattr(jattn, "_use_pallas", lambda: True)
    monkeypatch.setattr(jattn, "_strict", lambda: True)  # no silent XLA fallback
    monkeypatch.setattr(jattn, "KERNEL_PATHS", {})
    jcross = jdit.compute_crossattn_cache(jcfg, jp, jnp.asarray(ctx_emb))
    with pltpu.force_tpu_interpret_mode():
        float_flow, _ = jax_step(jcfg, jp, jcross, clean, noisy, t, fsl)
        monkeypatch.setattr(pat, "INT8_QK", True)
        want_flow, want_k = jax_step(jcfg, jp, jcross, clean, noisy, t, fsl)
    # one block of context: the JAX package prefills with its decode form
    assert jattn.KERNEL_PATHS == {"attention": "pallas", "decode": "pallas"}

    monkeypatch.setattr(hk, "INT8_QK", True)
    tcross = tdit.compute_crossattn_cache(tcfg, tp, torch.from_numpy(ctx_emb))
    kv = tkvc.init_kv_cache(tcfg.num_layers, 1, 6 * fsl, tcfg.num_heads, tcfg.head_dim,
                            torch.float32)
    rope = TRope.create(tcfg.head_dim)
    tdit.context_prefill(tcfg, tp, torch.from_numpy(clean), rope, tcross, kv,
                         block_tokens=3 * fsl)
    flow, kv = tdit.dit_forward(tcfg, tp, torch.from_numpy(noisy), torch.from_numpy(t), rope,
                                tcross, mode="decode", kv_cache=kv, current_start=3 * fsl,
                                max_attention_size=6 * fsl)
    err = rel_fro(flow.numpy(), want_flow)
    gap = rel_fro(float_flow, want_flow)
    assert err <= REL_FRO, err
    assert gap >= 10 * REL_FRO, gap
    assert rel_fro(kv["k"].numpy(), want_k) <= REL_FRO
