"""The port's int8 DiT tier against the JAX package's on the CPU, at tiny dims
in f32: the activation calibration (`WanDiffusion.calibrate_act_scales`, eager
form), the quantised tree (`quantize_wan_linears`), the cross-attention cache
built from dequantised k/v weights, and whole int8 forwards in decode and
prefill mode on the same quantised parameters.

Inputs: the JAX calibration draws its noisy latents and text context with
`jax.random` in bf16, which would run its whole forward in bf16, where XLA
and torch round at different places. The test draws the same keys in f32
instead (it wraps `jax.random.normal`) and hands the port those same arrays,
so both sides compute in f32.

Bounds: calibration maxima rtol 1e-5 per site and layer (f32 summation
order); w_q equal bit for bit, scales rtol 1e-6; the forwards' relative
Frobenius error <= 1e-3, which leaves room for a rare one-LSB quantum flip
where upstream f32 sums, taken in another order, land on the other side of a
rounding boundary."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import WAN_CONFIGS
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.rope import RopeTables as JRope
from realtime_video_tpu.ops import kv_cache as jkvc
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.rope import RopeTables as TRope
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
from realtime_video_tpu_torch.ops import kv_cache as tkvc
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

CFG = WAN_CONFIGS["t2v-tiny"]
LAT, KV_FRAMES, NFPB = 8, 6, 3
FSL = CFG.frame_seq_length(LAT, LAT)
STEPS = (1000.0, 625.0)
SEED = 0


def rel_fro(t, j):
    t, j = t.detach().float().numpy(), np.asarray(j, np.float32)
    return float(np.linalg.norm(t - j) / np.linalg.norm(j))


def jax_draws(n_steps):
    """The keys and shapes of the JAX calibration's draws, in f32."""
    rngs = jax.random.split(jax.random.PRNGKey(SEED), n_steps + 1)
    noisy = [np.asarray(jax.random.normal(rngs[i], (1, NFPB, CFG.in_dim, LAT, LAT),
                                          jnp.float32)) for i in range(n_steps)]
    ctx = np.asarray(jax.random.normal(rngs[-1], (1, 512, CFG.text_dim), jnp.float32))
    return noisy, ctx


@pytest.fixture(scope="module")
def models():
    p = jdit.init_wan_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    rng = np.random.default_rng(0)  # the head is zero-initialised; give it weights
    p["head"]["head"]["w"] = jnp.asarray(rng.normal(0, 0.05, p["head"]["head"]["w"].shape),
                                         jnp.float32)
    jp = jdit.fuse_qkv_params(p)
    jgen = JGen(cfg=CFG, params=jp)
    tgen = TGen(cfg=CFG, params=wan_params_from_jax(jax.device_get(jp)))

    normal = jax.random.normal
    mp = pytest.MonkeyPatch()
    mp.setenv("RTV_CAL_JIT", "0")  # the eager form
    mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: normal(
        key, shape, jnp.float32))
    try:
        jscales = jgen.calibrate_act_scales(STEPS, lat_h=LAT, lat_w=LAT,
                                            kv_frames=KV_FRAMES, nfpb=NFPB, seed=SEED)
    finally:
        mp.undo()
    noisy, ctx = jax_draws(len(STEPS) + 1)  # + the t=0 refresh pass
    tscales = tgen.calibrate_act_scales(STEPS, lat_h=LAT, lat_w=LAT, kv_frames=KV_FRAMES,
                                        nfpb=NFPB,
                                        noisy=[torch.from_numpy(a.copy()) for a in noisy],
                                        context=torch.from_numpy(ctx.copy()))
    jq = jdit.quantize_wan_linears(jp, act_scales=jscales)
    return jp, jgen, tgen, jscales, tscales, jq


def test_calibration_matches_jax(models):
    _, _, _, jscales, tscales, _ = models
    assert set(tscales) == set(jscales) and len(tscales) == 6
    for site, amax in jscales.items():
        assert tscales[site].shape == (CFG.num_layers,)
        np.testing.assert_allclose(tscales[site].numpy(), np.asarray(amax), rtol=1e-5,
                                   err_msg=str(site))


@pytest.mark.parametrize("static", [True, False])
def test_quantized_tree_matches_jax(models, static):
    jp, _, tgen, jscales, _, _ = models
    scales = jscales if static else None
    jq = jax.device_get(jdit.quantize_wan_linears(jp, act_scales=scales))
    tq = tdit.quantize_wan_linears(
        tgen.params, act_scales=None if scales is None else
        {k: torch.from_numpy(np.asarray(v)) for k, v in scales.items()})
    for group in ("self_attn", "cross_attn", "ffn"):
        for name, jnode in jq["blocks"][group].items():
            tnode = tq["blocks"][group][name]
            if "w_q" not in jnode:
                continue
            assert set(tnode) == set(jnode), (group, name)
            assert tnode["w_q"].dtype == torch.int8 and tnode["scale"].dtype == torch.float32
            np.testing.assert_array_equal(tnode["w_q"].numpy(), np.asarray(jnode["w_q"]))
            np.testing.assert_allclose(tnode["scale"].numpy(), np.asarray(jnode["scale"]),
                                       rtol=1e-6)
            if "a_scale" in jnode:
                assert tnode["a_scale"].dtype == torch.float32
                np.testing.assert_allclose(tnode["a_scale"].numpy(),
                                           np.asarray(jnode["a_scale"]), rtol=1e-6)
    # cross-attn k/v (used once per prompt) are quantised but not static-scaled
    assert "a_scale" not in tq["blocks"]["cross_attn"]["k"]


def test_calibration_refuses_quantised_params(models):
    *_, jq = models
    gen = TGen(cfg=CFG, params=wan_params_from_jax(jax.device_get(jq)))
    with pytest.raises(ValueError, match="float params"):
        gen.calibrate_act_scales(STEPS, lat_h=LAT, lat_w=LAT)


@pytest.mark.parametrize("static", [True, False])
def test_int8_forward_decode_and_prefill_match_jax(models, static, monkeypatch):
    jp, _, _, jscales, _, _ = models
    linear, calls = hm.int8_linear, []

    def checked(x, w_q, w_scale, a_scale, bias=None):
        # what the card's kernel requires of its operands
        assert x.is_contiguous() and a_scale.numel() == 1
        hm.check_weight_layout(w_q)  # the K-major view: strides (1, K)
        calls.append(1)
        return linear(x, w_q, w_scale, a_scale, bias)

    monkeypatch.setattr(hm, "int8_linear", checked)
    jq = jdit.quantize_wan_linears(jp, act_scales=jscales if static else None)
    tq = wan_params_from_jax(jax.device_get(jq))
    ctx = np.random.default_rng(1).normal(size=(1, 16, CFG.text_dim)).astype(np.float32)
    jcross = jdit.compute_crossattn_cache(CFG, jq, jnp.asarray(ctx))
    tcross = tdit.compute_crossattn_cache(CFG, tq, torch.from_numpy(ctx))
    assert rel_fro(tcross["k"], jcross["k"]) < 1e-5
    assert rel_fro(tcross["v"], jcross["v"]) < 1e-5

    def kv():
        return (jkvc.init_kv_cache(CFG.num_layers, 1, 6 * FSL, CFG.num_heads, CFG.head_dim,
                                   jnp.float32),
                tkvc.init_kv_cache(CFG.num_layers, 1, 6 * FSL, CFG.num_heads, CFG.head_dim,
                                   torch.float32))

    rope_j, rope_t = JRope.create(CFG.head_dim), TRope.create(CFG.head_dim)
    rng = np.random.default_rng(2)
    clean = rng.normal(size=(1, 3, CFG.in_dim, LAT, LAT)).astype(np.float32)
    x = rng.normal(size=(1, 3, CFG.in_dim, LAT, LAT)).astype(np.float32)

    # prefill over the clean context (block-causal), then a decode step
    jkv, tkv = kv()
    t0 = np.zeros((1, 3), np.float32)
    jflow, jkv = jdit.dit_forward(CFG, jq, jnp.asarray(clean), jnp.asarray(t0), rope_j, jcross,
                                  mode="prefill", kv_cache=jkv, prefill_block_tokens=3 * FSL)
    tflow, tkv = tdit.dit_forward(CFG, tq, torch.from_numpy(clean), torch.from_numpy(t0),
                                  rope_t, tcross, mode="prefill", kv_cache=tkv,
                                  prefill_block_tokens=3 * FSL)
    assert rel_fro(tflow, jflow) < 1e-3
    assert rel_fro(tkv["k"][:, :, :3 * FSL], jkv["k"][:, :, :3 * FSL]) < 1e-3

    t = np.full((1, 3), 937.5, np.float32)
    jflow, jkv = jdit.dit_forward(CFG, jq, jnp.asarray(x), jnp.asarray(t), rope_j, jcross,
                                  mode="decode", kv_cache=jkv, current_start=3 * FSL,
                                  max_attention_size=6 * FSL)
    tflow, tkv = tdit.dit_forward(CFG, tq, torch.from_numpy(x), torch.from_numpy(t), rope_t,
                                  tcross, mode="decode", kv_cache=tkv, current_start=3 * FSL,
                                  max_attention_size=6 * FSL)
    assert float(np.abs(np.asarray(jflow)).max()) > 1e-2
    assert rel_fro(tflow, jflow) < 1e-3
    assert rel_fro(tkv["v"], jkv["v"]) < 1e-3
    assert len(calls) == 2 * CFG.num_layers * 6
