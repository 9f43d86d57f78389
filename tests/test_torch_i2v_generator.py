"""`WanI2V.generate` against the JAX package's `WanI2V` on the CPU: a tiny
i2v DiT (dim 64, 2 layers, in_dim 36, the head random), the tiny VAE and a
CLIP tower of ViT-H's width (1280) at 2 blocks on a 28x28 resize, the same
numpy weights on both sides; 2 UniPC steps at guidance 5 over 9 frames of
32x32 (3 latents); the port's torch noise replayed into JAX's
`jax.random.normal` draw.

JAX's generator casts its noise, its conditioning pixels, its y channels
and its prompt embeddings to bf16, and its DiT, VAE and solver compute in
their input's dtype: with f32 weights its whole loop still runs in bf16,
and its latents keep bf16 between steps. The port takes each of those
roundings and then computes in its DiT's and VAE's dtype, as its pipelines
do (bf16 on a card, f32 here). So:

  * against JAX with those four casts lifted to f32 (the text K/V from the
    bf16-rounded embeddings, the DiT input, the VAE encoder's input and the
    solver's sample), latents and video agree at relative Frobenius 1e-3,
    with and without the CLIP encoder (UniPC), and with DPM++;
  * against the unmodified JAX generator the gap is JAX's own bf16
    rounding: measured 2.2e-2 on the latents and 6-7e-3 on the video, as
    far as JAX's f32 form lies from it. The port must lie no further than
    1.1x that distance + 1e-3, and ten times closer to JAX's f32 form than
    to this bf16 one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_session import numpy_tree

from realtime_video_tpu import generators as jgens
from realtime_video_tpu import solvers as jsolvers
from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.config import WanModelConfig as JWanConfig
from realtime_video_tpu.models import clip as jclip
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu_torch.config import VAEConfig, WanModelConfig
from realtime_video_tpu_torch.generators import WanI2V, first_frame_mask
from realtime_video_tpu_torch.models import clip as tclip
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.utils.convert import (
    clip_params_from_jax,
    vae_params_from_jax,
    wan_params_from_jax,
)

REL = 1e-3
DIT = dict(model_type="i2v", dim=64, ffn_dim=128, num_heads=2, num_layers=2, in_dim=36)
VAE = dict(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
VIT = dict(image_size=28, patch_size=14, dim=1280, mlp_ratio=1, num_heads=16, num_layers=2,
           norm_eps=1e-5)
FRAMES, SEED, STEPS = 9, 3, 2
NOISE_SHAPE = (1, 3, 16, 4, 4)


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class Encoder:
    """Prompt -> a fixed random embedding per prompt, the same numbers on
    both sides (JAX's generator calls it positionally, the port by name)."""

    def __init__(self, to_tensor):
        self.to_tensor = to_tensor
        self.embs = {}

    def __call__(self, text_prompts):
        prompt = text_prompts[0]
        if prompt not in self.embs:
            rng = np.random.default_rng(50 + len(self.embs))
            self.embs[prompt] = rng.normal(size=(1, 16, 4096)).astype(np.float32)
        return {"prompt_embeds": self.to_tensor(self.embs[prompt])}


@pytest.fixture(scope="module")
def sides():
    as_jax = lambda tree, shapes: jax.tree.map(  # noqa: E731
        lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    dit_np, dit_s = numpy_tree(lambda k: jdit.init_wan_params(k, JWanConfig(**DIT),
                                                              jnp.float32), 40)
    vae_np, vae_s = numpy_tree(lambda k: jvae.init_vae_params(k, JVAEConfig(**VAE),
                                                              jnp.float32), 41)
    vit_np, vit_s = numpy_tree(lambda k: jclip.init_vit_params(k, VIT), 42)
    jv = JVAE(cfg=JVAEConfig(**VAE), params=as_jax(vae_np, vae_s))
    jclip_enc = jclip.CLIPVisionEncoder(params=as_jax(vit_np, vit_s))
    jclip_enc.cfg = VIT  # read when its jitted forward is traced
    jax_side = (JGen(cfg=JWanConfig(**DIT), params=as_jax(dit_np, dit_s)), jv, jclip_enc)
    torch_side = (TGen(cfg=WanModelConfig(**DIT), params=wan_params_from_jax(dit_np),
                       device="cpu"),
                  TVAE(VAEConfig(**VAE), vae_params_from_jax(vae_np)),
                  tclip.CLIPVisionEncoder(params=clip_params_from_jax(vit_np), cfg=VIT))
    img = (np.random.default_rng(43).normal(size=(3, 32, 32)) * 0.3).astype(np.float32)
    return jax_side, torch_side, img


def run_port(sides, with_clip, solver="unipc"):
    _, (gen, vae, clip), img = sides
    i2v = WanI2V(gen, Encoder(torch.from_numpy), vae, clip if with_clip else None,
                 sampling_steps=STEPS)
    video, lat = i2v.generate("a cat", torch.from_numpy(img), frame_num=FRAMES, seed=SEED,
                              sample_solver=solver, return_latents=True, profile=True)
    assert set(i2v.last_profile) == {"clip_ms", "encode_ms", "cross_ms", "step_ms",
                                     "decode_ms"}
    assert len(i2v.last_profile["step_ms"]) == STEPS
    return video.numpy(), lat.numpy()


def run_jax(sides, with_clip, monkeypatch, lifted, solver="unipc"):
    """JAX's WanI2V on the port's noise; with `lifted`, its bf16 casts lifted
    to f32. Returns (video, the latents it decodes)."""
    (gen, vae, clip), _, img = sides
    noise = torch.randn(NOISE_SHAPE, generator=torch.Generator().manual_seed(SEED)).numpy()
    normal = jax.random.normal
    caught = {}
    decode = vae.decode_to_pixel

    def replay(key, shape, dtype=jnp.float32):
        if tuple(shape) == NOISE_SHAPE:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    def decode_spy(z):
        caught["lat"] = np.asarray(z, np.float32)
        return decode(z)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", replay)
        m.setattr(vae, "decode_to_pixel", decode_spy)
        if lifted:
            cache, fwd, encode = jdit.compute_crossattn_cache, jdit.dit_forward, \
                vae.encode_to_latent
            m.setattr(jdit, "compute_crossattn_cache", lambda cfg, p, ctx, clip_fea=None:
                      cache(cfg, p, ctx.astype(jnp.float32), clip_fea=clip_fea))
            m.setattr(jdit, "dit_forward", lambda cfg, p, x, *a, **k:
                      fwd(cfg, p, x.astype(jnp.float32), *a, **k))
            m.setattr(vae, "encode_to_latent", lambda px: encode(px.astype(jnp.float32)))
            for cls in (jsolvers.FlowUniPCMultistep, jsolvers.FlowDPMSolverMultistep):
                m.setattr(cls, "step", lambda self, flow, t, sample, _step=cls.step:
                          _step(self, flow, t, sample.astype(jnp.float32)))
        i2v = jgens.WanI2V(gen, Encoder(jnp.asarray), vae, clip if with_clip else None,
                           sampling_steps=STEPS)
        video = i2v.generate("a cat", img, frame_num=FRAMES, seed=SEED, sample_solver=solver)
    return np.asarray(video), caught["lat"]


@pytest.mark.parametrize("with_clip", [True, False], ids=["clip", "no_clip"])
def test_generate_matches_jax_in_f32(sides, with_clip, monkeypatch):
    tvid, tlat = run_port(sides, with_clip)
    jvid, jlat = run_jax(sides, with_clip, monkeypatch, lifted=True)
    assert tvid.shape == jvid.shape == (FRAMES, 3, 32, 32)
    assert tlat.shape == jlat.shape == NOISE_SHAPE
    assert np.isfinite(tvid).all()
    assert rel_fro(tlat, jlat) < REL
    assert rel_fro(tvid, jvid) < REL


def test_generate_dpm_matches_jax_in_f32(sides, monkeypatch):
    """DPM++ on the ladder the JAX generator sets (no explicit sigmas)."""
    tvid, tlat = run_port(sides, True, "dpm++")
    jvid, jlat = run_jax(sides, True, monkeypatch, lifted=True, solver="dpm++")
    assert rel_fro(tlat, jlat) < REL
    assert rel_fro(tvid, jvid) < REL


def test_generate_against_unmodified_jax(sides, monkeypatch):
    tvid, tlat = run_port(sides, True)
    jvid, jlat = run_jax(sides, True, monkeypatch, lifted=False)
    fvid, flat = run_jax(sides, True, monkeypatch, lifted=True)
    floor_lat, floor_vid = rel_fro(flat, jlat), rel_fro(fvid, jvid)
    assert 1e-3 < floor_lat < 5e-2 and floor_vid < 2e-2  # JAX's own bf16 rounding
    assert rel_fro(tlat, jlat) <= 1.1 * floor_lat + 1e-3
    assert rel_fro(tvid, jvid) <= 1.1 * floor_vid + 1e-3
    # the port computes JAX's f32 function, not its bf16 rounding of it
    assert rel_fro(tlat, flat) < 0.1 * rel_fro(tlat, jlat)
    assert rel_fro(tvid, fvid) < 0.1 * rel_fro(tvid, jvid)


def test_clip_features_condition_the_clip(sides):
    """The CLIP encoder moves the latents; the first-frame mask is 1 on the 4
    copies of the conditioning frame (the first latent) and 0 elsewhere."""
    _, with_clip = run_port(sides, True)
    _, without = run_port(sides, False)
    assert rel_fro(with_clip, without) > 1e-3
    msk = first_frame_mask(FRAMES, 4, 4)
    assert tuple(msk.shape) == (1, 3, 4, 4, 4)
    assert msk[0, 0].eq(1).all() and msk[0, 1:].eq(0).all()


def test_i2v_refuses_a_t2v_model(sides):
    _, (_, vae, _), _ = sides
    t2v = TGen(cfg=WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=1),
               device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="i2v model"):
        WanI2V(t2v, Encoder(torch.from_numpy), vae)
