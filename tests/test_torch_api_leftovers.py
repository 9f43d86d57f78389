"""The last scheduler, solver, RoPE and session API of the JAX package, held
by the port on the CPU:

  * `FlowMatchSchedule.step` (Euler; `to_final`, and past the last index
    sigma_next = 0), `x0_to_flow`, `x0_to_noise` and `noise_to_x0` against
    the JAX package's at rtol 1e-5, atol 1e-6 (f32 arithmetic,
    tests/test_torch_scheduler_rope.py's bar);
  * the solvers' `scale_noise`, the same bar;
  * RIFLEx tables (`riflex_k` 0 and 4) and their fused grid, the same bar;
  * `GenerationSession.recompute_kv_cache` against the JAX session's cache
    (k and v at relative Frobenius 1e-3, both ends equal), with a 3-frame
    clean context and without one, on tiny f32 models with the same weights,
    context latents and prompt (the JAX session's bf16 cache and latents are
    lifted to f32, since the port's session takes the model's dtype);
  * `generate_blocks(n)` gives the frames of n `generate_block` calls, bit
    for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import load_server_config
from realtime_video_tpu.models import rope as jrope
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.pipelines import CausalInferencePipeline as JPipe
from realtime_video_tpu.scheduler import FlowMatchSchedule as JSched
from realtime_video_tpu.serving.models import Models as JModels
from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu.serving.session import GenerationSession as JSession
from realtime_video_tpu.solvers import FlowDPMSolverMultistep as JDPM
from realtime_video_tpu.solvers import FlowUniPCMultistep as JUniPC
from realtime_video_tpu_torch.models import rope as trope
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline as TPipe
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule as TSched
from realtime_video_tpu_torch.serving.models import Models as TModels
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession as TSession
from realtime_video_tpu_torch.solvers import FlowDPMSolverMultistep as TDPM
from realtime_video_tpu_torch.solvers import FlowUniPCMultistep as TUniPC
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax, wan_params_from_jax
from test_torch_session import REQ, VAEC, WAN, numpy_tree, stacks  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)


def _rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _arrays(seed, n, shape=(2, 3, 4, 4, 4)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def scheds():
    kw = dict(shift=5.0, sigma_min=0.0, extra_one_step=True)
    return JSched.create(**kw), TSched.create(**kw)


@pytest.mark.parametrize("ts,to_final", [
    ([[937.5, 833.3, 0.0], [500.0, 250.0, 999.0]], False),
    ([[937.5, 833.3, 0.0], [500.0, 250.0, 999.0]], True),
    ([[1.0, 0.5, 0.0], [0.2, 3.0, 0.0]], False),  # the last indices: sigma_next = 0
])
def test_euler_step_matches(scheds, ts, to_final):
    js, tsch = scheds
    flow, sample = _arrays(0, 2)
    t = np.asarray(ts, np.float32)
    want = np.asarray(js.step(jnp.asarray(flow), jnp.asarray(t), jnp.asarray(sample),
                              to_final=to_final))
    got = tsch.step(torch.from_numpy(flow), torch.from_numpy(t), torch.from_numpy(sample),
                    to_final=to_final)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if to_final:  # x + v (0 - sigma) = x0
        x0 = tsch.flow_to_x0(torch.from_numpy(flow), torch.from_numpy(sample),
                             torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), x0.numpy(), **TOL)
    # bf16 in, bf16 out (f32 arithmetic)
    got16 = tsch.step(torch.from_numpy(flow).bfloat16(), torch.from_numpy(t),
                      torch.from_numpy(sample).bfloat16(), to_final=to_final)
    assert got16.dtype == torch.bfloat16


def test_x0_flow_noise_conversions_match(scheds):
    js, tsch = scheds
    x0, xt, other = _arrays(1, 3)
    t = np.asarray([[900.0, 500.0, 10.0], [700.0, 300.0, 100.0]], np.float32)
    for name, a, b in (("x0_to_flow", x0, xt), ("x0_to_noise", x0, xt),
                       ("noise_to_x0", other, xt)):
        want = np.asarray(getattr(js, name)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
        got = getattr(tsch, name)(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5, err_msg=name)
    # the round trips of tests/test_scheduler.py
    tt = torch.from_numpy(t)
    xt_ = tsch.add_noise(torch.from_numpy(x0), torch.from_numpy(other), tt)
    np.testing.assert_allclose(tsch.x0_to_noise(torch.from_numpy(x0), xt_, tt).numpy(), other,
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tsch.noise_to_x0(torch.from_numpy(other), xt_, tt).numpy(), x0,
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("jcls,tcls", [(JUniPC, TUniPC), (JDPM, TDPM)])
def test_scale_noise_matches(jcls, tcls):
    js, ts = jcls(shift=5.0), tcls(shift=5.0)
    js.set_timesteps(8)
    ts.set_timesteps(8)
    sample, noise = _arrays(2, 2)
    for i in (0, 3, 7, 8):
        want = np.asarray(js.scale_noise(jnp.asarray(sample), jnp.asarray(noise), i))
        got = ts.scale_noise(torch.from_numpy(sample), torch.from_numpy(noise), i)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the last index (sigma 0) returns the sample
    np.testing.assert_allclose(ts.scale_noise(torch.from_numpy(sample), torch.from_numpy(noise),
                                              8).numpy(), sample, **TOL)


@pytest.mark.parametrize("riflex_k", [0, 4])
def test_riflex_tables_match(riflex_k):
    kw = dict(riflex_k=riflex_k, riflex_L_test=30)
    jt, tt = jrope.RopeTables.create(128, **kw), trope.RopeTables.create(128, **kw)
    for name in ("cos_t", "sin_t", "cos_h", "sin_h", "cos_w", "sin_w"):
        np.testing.assert_allclose(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    jc, js = jt.fused(3, 4, 5, 7)
    tc, ts = tt.fused(3, 4, 5, 7)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    plain = trope.RopeTables.create(128)
    pinned = torch.equal(tt.cos_t, plain.cos_t)
    assert pinned == (riflex_k == 0)  # k > 0 moves one temporal frequency
    if riflex_k:
        np.testing.assert_allclose(
            np.arctan2(tt.sin_t[1, riflex_k - 1].item(), tt.cos_t[1, riflex_k - 1].item()),
            0.9 * 2 * np.pi / 30, rtol=1e-6)


class _Encoder:
    """One bf16-representable embedding for every prompt."""

    def __init__(self, to_tensor):
        e = np.random.default_rng(5).normal(size=(1, 16, WAN.text_dim)).astype(np.float32)
        self.emb = to_tensor(np.asarray(jnp.asarray(e, jnp.bfloat16).astype(jnp.float32)))

    def __call__(self, text_prompts):
        return {"prompt_embeds": self.emb}


@pytest.fixture(scope="module")
def f32_sessions():
    """A JAX and a port session on tiny f32 models with the same weights and
    prompt; the JAX pipeline's cache lifted to f32."""
    config = load_server_config(num_frame_per_block=3)
    dit_np, _ = numpy_tree(lambda k: jdit.init_wan_params(k, WAN, jnp.bfloat16), 0)
    vae_np, _ = numpy_tree(lambda k: jvae.init_vae_params(k, VAEC, jnp.bfloat16), 1)
    jgen = JGen(cfg=WAN, params=jax_tree(dit_np))
    jv = JVAE(cfg=VAEC, params=jax_tree(vae_np))
    jpipe = JPipe(config, jgen, text_encoder=None, vae=jv)
    init = jpipe._initialize_kv_cache
    jpipe._initialize_kv_cache = lambda b, fsl, dtype=None: init(b, fsl, jnp.float32)
    jm = JModels(_Encoder(jnp.asarray), jgen, jpipe, jv, jv)
    tgen = TGen(cfg=WAN, params=wan_params_from_jax(dit_np, dtype=torch.float32),
                fuse_qkv=False)
    tv = TVAE(VAEC, vae_params_from_jax(vae_np, dtype=torch.float32))
    tm = TModels(_Encoder(torch.from_numpy), tgen, TPipe(config, tgen), tv, tv)
    js = JSession(JParams(**REQ), config, models=jm, frame_callback=lambda *a: None)
    ts = TSession(TParams(**REQ), config, models=tm, frame_callback=lambda *a: None)
    emb = np.asarray(jm.text_encoder(["a cat"])["prompt_embeds"])
    jm.pipeline._initialize_crossattn_cache(jnp.asarray(emb))
    tm.pipeline._initialize_crossattn_cache(torch.from_numpy(emb))
    return jm, tm, js, ts


def jax_tree(tree):
    import jax

    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)


@pytest.mark.parametrize("with_context", [True, False])
def test_recompute_kv_cache_matches_jax(f32_sessions, with_context):
    jm, tm, js, ts = f32_sessions
    ctx = np.asarray(jnp.asarray(np.random.default_rng(7).normal(
        size=(1, 3, 16, 8, 8)), jnp.bfloat16).astype(jnp.float32))
    for s in (js, ts):
        s.block_idx = 1 if with_context else 0
        s.current_start_frame = 3 if with_context else 0
    # the JAX session keeps bf16 latents, and its forward computes in its
    # input's dtype: lifted to f32 here, as the port's f32 session holds them
    js.all_latents = jnp.zeros(js.all_latents.shape, jnp.float32).at[:, :3].set(ctx)
    ts.all_latents[:, :3] = torch.from_numpy(ctx)
    tm.pipeline.kv_cache["k"].fill_(1.0)  # the recompute starts from zeros
    want_start = js.recompute_kv_cache(jm)
    got_start = ts.recompute_kv_cache(tm)
    assert got_start == want_start == (3 if with_context else 0)
    jkv, tkv = jm.pipeline.kv_cache, tm.pipeline.kv_cache
    for name in ("k", "v"):
        want, got = np.asarray(jkv[name]), tkv[name].numpy()
        assert got.shape == want.shape
        if with_context:
            assert np.abs(want).sum() > 0 and _rel_fro(got, want) < 1e-3, name
        else:
            assert not got.any() and not want.any(), name
    ends = (3 * 16, 3 * 16) if with_context else (0, 0)  # 3 frames of 16 tokens
    assert (int(tkv["global_end"]), int(tkv["local_end"])) == \
        (int(jkv["global_end"]), int(jkv["local_end"])) == ends


def test_generate_blocks_equals_generate_block_calls(stacks):  # noqa: F811
    config, _, tm = stacks
    frames = {}
    for how in ("blocks", "block"):
        got = frames.setdefault(how, [])
        s = TSession(TParams(**dict(REQ, num_blocks=2)), config, models=tm,
                     frame_callback=lambda px, ids, ev: got.append(px.clone()))
        if how == "blocks":
            s.generate_blocks(2, tm)
        else:
            s.generate_block(tm)
            s.generate_block(tm)
        assert s.block_idx == 2 and s.total_frames_sent == 18
    assert len(frames["blocks"]) == len(frames["block"])
    for a, b in zip(frames["blocks"], frames["block"]):
        assert torch.equal(a, b)
