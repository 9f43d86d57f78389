"""The offline block-causal sampler: the port's `CausalInferencePipeline.inference`
against the JAX pipeline's on the CPU, on the tests/test_pipeline.py tiny
models in f32 (the same numpy weights on both sides, converted with
`wan_params_from_jax` / `vae_params_from_jax`), with the JAX loop's renoise
draws (its `jax.random` key split once a step) replayed through `noise_fn`.

Latents agree at relative Frobenius 1e-3 in every mode: t2v (its video too),
extension from `initial_latent`, `independent_first_frame`,
`warp_denoising_step` and `context_noise` > 0 (the cache refresh at that
timestep; at 0 it runs at t = 0); the VAE's whole-clip pair
`encode_to_latent` / `decode_to_pixel` agrees with JAX's `VAEWrapper` at the
same bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.config import WanModelConfig as JWanConfig
from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.pipelines import CausalInferencePipeline as JPipe
from realtime_video_tpu_torch.config import VAEConfig, WanModelConfig, load_server_config
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline as TPipe
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax, wan_params_from_jax
from test_torch_session import numpy_tree

REL = 1e-3
JWAN = JWanConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
JVAEC = JVAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
WAN = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
VAEC = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
H = W = 4  # latents 4x4 -> 32x32 pixels
BASE = dict(denoising_step_list=[1000, 750, 500], num_frame_per_block=3, context_noise=0,
            warp_denoising_step=False)


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models():
    dit_np, dit_shapes = numpy_tree(
        lambda k: jdit.fuse_qkv_params(jdit.init_wan_params(k, JWAN, jnp.float32)), 10)
    vae_np, vae_shapes = numpy_tree(lambda k: jvae.init_vae_params(k, JVAEC, jnp.float32), 11)
    as_jax = lambda tree, shapes: jax.tree.map(  # noqa: E731
        lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    jgen = JGen(cfg=JWAN, params=as_jax(dit_np, dit_shapes))
    jv = JVAE(cfg=JVAEC, params=as_jax(vae_np, vae_shapes))
    tgen = TGen(cfg=WAN, params=wan_params_from_jax(dit_np))
    tv = TVAE(VAEC, vae_params_from_jax(vae_np))
    emb = np.random.default_rng(12).normal(size=(1, 16, WAN.text_dim)).astype(np.float32)
    return jgen, jv, tgen, tv, emb


def jax_key_noise(seed: int):
    """noise_fn replaying the JAX block loop's draws: one key split a step."""
    key = {"k": jax.random.PRNGKey(seed)}

    def draw(shape, dtype, device):
        key["k"], sub = jax.random.split(key["k"])
        nz = np.array(jax.random.normal(sub, shape, jnp.float32))
        return torch.from_numpy(nz).to(device, dtype)

    return draw


def _noise(seed: int, frames: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, frames, 16, H, W)).astype(np.float32)


CASES = {
    # name: (config overrides, noise frames, initial latent frames, with the VAE)
    "t2v": ({}, 6, 0, True),
    "extension": ({}, 3, 3, False),
    "independent_first_frame": ({"independent_first_frame": True}, 4, 0, False),
    "warp_denoising_step": ({"warp_denoising_step": True,
                             "denoising_step_list": [1000, 750, 500, 250]}, 3, 0, False),
    "context_noise": ({"context_noise": 250}, 6, 0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_inference_matches_jax(models, case):
    jgen, jv, tgen, tv, emb = models
    overrides, frames, n_init, with_vae = CASES[case]
    cfg = {**BASE, **overrides}
    jp = JPipe(jconfig(**cfg), jgen, vae=jv if with_vae else None)
    tp = TPipe(load_server_config(**cfg), tgen, vae=tv if with_vae else None)
    assert tp.denoising_step_list == pytest.approx(jp.denoising_step_list, rel=1e-6)
    noise = _noise(frames, frames)
    init = _noise(100 + n_init, n_init) if n_init else None
    seed = 3
    jvid, jlat = jp.inference(jnp.asarray(noise), prompt_embeds=jnp.asarray(emb),
                              initial_latent=None if init is None else jnp.asarray(init),
                              return_latents=True, seed=seed)
    tvid, tlat = tp.inference(torch.from_numpy(noise), prompt_embeds=torch.from_numpy(emb),
                              initial_latent=None if init is None else torch.from_numpy(init),
                              return_latents=True, seed=seed, noise_fn=jax_key_noise(seed))
    jlat = np.asarray(jlat)
    assert tuple(tlat.shape) == jlat.shape == (1, frames + n_init, 16, H, W)
    assert rel_fro(tlat.numpy(), jlat) < REL
    if init is not None:  # the initial latents pass through unchanged
        assert torch.equal(tlat[:, :n_init], torch.from_numpy(init))
    if with_vae:
        jvid = np.asarray(jvid)
        assert tuple(tvid.shape) == jvid.shape == (1, 1 + 4 * (frames - 1), 3, 8 * H, 8 * W)
        assert float(tvid.min()) >= 0.0 and float(tvid.max()) <= 1.0
        assert rel_fro(tvid.numpy(), jvid) < REL
    else:
        assert tvid is None


def test_refresh_rewrites_the_cache(models):
    """The refresh forward is what context_noise changes: the next block's
    latents move with it."""
    _, _, tgen, _, emb = models
    noise = torch.from_numpy(_noise(6, 6))
    lat = {}
    for cn in (0, 500):
        tp = TPipe(load_server_config(**{**BASE, "context_noise": cn}), tgen)
        _, lat[cn] = tp.inference(noise, prompt_embeds=torch.from_numpy(emb),
                                  return_latents=True, seed=1)
    assert torch.equal(lat[0][:, :3], lat[500][:, :3])
    assert rel_fro(lat[500][:, 3:].numpy(), lat[0][:, 3:].numpy()) > 1e-3


def test_a_sessions_window_does_not_leak_into_inference(models, capsys):
    """A session sets pipeline.local_attn_size to its own window; inference on
    the same pipeline still attends over the global window. `profile` prints
    the reference's report and keeps its numbers."""
    _, _, tgen, tv, emb = models
    noise = torch.from_numpy(_noise(9, 9))
    fresh = TPipe(load_server_config(**BASE), tgen)
    _, want = fresh.inference(noise, prompt_embeds=torch.from_numpy(emb), return_latents=True,
                              seed=2)
    used = TPipe(load_server_config(**BASE), tgen, vae=tv)
    used.local_attn_size = 6  # what a session with 3 KV frames leaves
    used._initialize_kv_cache(1, 4, tgen.dtype)
    _, got = used.inference(noise, prompt_embeds=torch.from_numpy(emb), return_latents=True,
                            seed=2, profile=True)
    assert torch.equal(got, want)
    assert used.kv_cache["k"].shape[2] == 21 * 4
    out = capsys.readouterr().out
    assert "Profiling results" in out and "VAE decoding time" in out
    assert len(used.last_profile["block_ms"]) == 3


def test_vae_clip_api_matches_jax(models):
    """encode_to_latent (9 frames -> 3 latents) and decode_to_pixel (3 latents
    -> 9 frames, a fresh decode) against JAX's VAEWrapper, f32."""
    _, jv, _, tv, _ = models
    rng = np.random.default_rng(13)
    px = rng.uniform(-1, 1, size=(1, 9, 3, 32, 32)).astype(np.float32)
    z = rng.normal(size=(1, 3, 16, H, W)).astype(np.float32)
    jz = np.asarray(jv.encode_to_latent(jnp.asarray(px)))
    tz = tv.encode_to_latent(torch.from_numpy(px))
    assert tuple(tz.shape) == jz.shape == (1, 3, 16, H, W)
    assert rel_fro(tz.numpy(), jz) < REL
    jpx = np.asarray(jv.decode_to_pixel(jnp.asarray(z)))
    tpx = tv.decode_to_pixel(torch.from_numpy(z))
    assert tuple(tpx.shape) == jpx.shape == (1, 9, 3, 32, 32)
    assert rel_fro(tpx.numpy(), jpx) < REL
