"""The teacher and bidirectional sampling path: the port's train-mode
forward and its three pipelines against the JAX package's on the CPU in
f32, on the tests/test_torch_causal_inference.py tiny models (the same numpy
weights on both sides, the head's included, so that no flow is zero).

At relative Frobenius 1e-3 on latents and video:
  * `dit_forward(mode="train")` with no mask against JAX's with none and
    with an all-true [L, L] mask, and under a block-causal dense mask;
  * `CausalDiffusionInferencePipeline` with UniPC and DPM++, with an
    `initial_latent`, with `context_noise` > 0, one case decoded;
  * `BidirectionalDiffusionInferencePipeline` with both solvers;
  * `BidirectionalInferencePipeline` (no mask here, JAX's all-true one
    there), JAX's `jax.random.split` draws replayed through `noise_fn`.
`WanT2V.generate` draws its noise from torch, so it is held to the port's
own pipeline on that noise: equal, [T, 3, H, W] in [-1, 1].

The JAX pipelines round the prompt embeddings to bf16, and JAX's `linear`
then computes the text cross-attention K/V in bf16, with XLA's excess
precision between ops; the port rounds them alike and computes in the DiT's
dtype. Guidance multiplies the cond / uncond difference by up to 9, so those
bf16 roundings alone move the guided latents by ~2.7e-3. To hold the
pipelines in f32, the JAX generator here (`F32CrossGen`) computes its K/V
from the same bf16-rounded embeddings in f32; nothing else of it changes.
tests/test_torch_teacher_unmodified_jax.py holds each pipeline against the
unmodified JAX generator, at 5e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.pipelines.bidirectional_diffusion_inference import (
    BidirectionalDiffusionInferencePipeline as JBiDiff,
)
from realtime_video_tpu.pipelines.bidirectional_inference import (
    BidirectionalInferencePipeline as JBiFew,
)
from realtime_video_tpu.pipelines.causal_diffusion_inference import (
    CausalDiffusionInferencePipeline as JCausalDiff,
)
from realtime_video_tpu_torch.config import SAMPLE_NEG_PROMPT, load_server_config
from realtime_video_tpu_torch.generators import WanT2V
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.text_encoder import SeededTextEncoder
from realtime_video_tpu_torch.ops import attention as attn_ops
from realtime_video_tpu_torch.pipelines import (
    BidirectionalDiffusionInferencePipeline,
    BidirectionalInferencePipeline,
    CausalDiffusionInferencePipeline,
)
from test_torch_causal_inference import H, W, jax_key_noise, models, rel_fro  # noqa: F401

REL = 1e-3


class F32CrossGen(JGen):
    """The JAX generator with its text K/V computed in f32 from the
    bf16-rounded embeddings its pipelines pass."""

    def __init__(self, jgen):
        super().__init__(cfg=jgen.cfg, params=jgen.params)

    def compute_crossattn_cache(self, params, prompt_embeds):
        return super().compute_crossattn_cache(params, prompt_embeds.astype(jnp.float32))


def _noise(seed: int, frames: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, frames, 16, H, W)).astype(np.float32)


def _emb(seed: int, text_dim: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(1, 16, text_dim)).astype(np.float32)


def _check(tout, jout, shape):
    """(video, latents) of both sides: shapes, the [0, 1] range, 1e-3."""
    (tvid, tlat), (jvid, jlat) = tout, jout
    jlat = np.asarray(jlat)
    assert tuple(tlat.shape) == jlat.shape == shape
    assert rel_fro(tlat.numpy(), jlat) < REL
    if jvid is None:
        assert tvid is None
        return
    jvid = np.asarray(jvid)
    assert tuple(tvid.shape) == jvid.shape == (1, 1 + 4 * (shape[1] - 1), 3, 8 * H, 8 * W)
    assert float(tvid.min()) >= 0.0 and float(tvid.max()) <= 1.0
    assert rel_fro(tvid.numpy(), jvid) < REL


def test_train_forward_matches_jax(models):
    """No mask against JAX's none and its all-true mask; a block-causal
    dense mask (the CPU-only masked route) against JAX's under it."""
    jgen, _, tgen, _, emb = models
    x = _noise(30, 3)
    t = np.asarray([[937.0, 500.0, 120.0]], np.float32)
    jcross = jgen.compute_crossattn_cache(jgen.params, jnp.asarray(emb))
    tcross = tgen.compute_crossattn_cache(torch.from_numpy(emb))
    L = 3 * tgen.cfg.frame_seq_length(H, W)

    def jax_flow(mask):
        flow, x0, kv = jgen.forward(jgen.params, jnp.asarray(x), jcross, jnp.asarray(t),
                                    mode="train", attn_mask=mask)
        assert kv is None
        return np.asarray(flow), np.asarray(x0)

    flow, x0, kv = tgen.forward(torch.from_numpy(x), tcross, torch.from_numpy(t), mode="train")
    assert kv is None and tuple(flow.shape) == x.shape
    want_flow, want_x0 = jax_flow(None)
    assert rel_fro(flow.numpy(), want_flow) < REL and rel_fro(x0.numpy(), want_x0) < REL
    assert rel_fro(flow.numpy(), jax_flow(jnp.ones((L, L), bool))[0]) < REL

    mask = attn_ops.blockwise_causal_mask(3, L // 3, 1)
    masked, _, _ = tgen.forward(torch.from_numpy(x), tcross, torch.from_numpy(t), mode="train",
                                attn_mask=mask)
    assert rel_fro(masked.numpy(), jax_flow(jnp.asarray(mask.numpy()))[0]) < REL
    assert rel_fro(masked.numpy(), flow.numpy()) > 1e-2  # the mask does change the flow


def test_train_mode_takes_no_cache_and_masks_only_in_train_mode(models):
    _, _, tgen, _, emb = models
    cross = tgen.compute_crossattn_cache(torch.from_numpy(emb))
    x, t = torch.from_numpy(_noise(31, 3)), torch.full((1, 3), 500.0)
    kv = {"k": torch.zeros(1), "v": torch.zeros(1)}
    with pytest.raises(ValueError, match="train mode takes no kv_cache"):
        tgen.forward(x, cross, t, kv, mode="train")
    with pytest.raises(ValueError, match="needs a kv_cache"):
        tgen.forward(x, cross, t, None, mode="decode")
    with pytest.raises(ValueError, match="train mode only"):
        wan_dit.dit_forward(tgen.cfg, tgen.params, x, t, tgen.rope, cross, "decode", kv, 0,
                            12, attn_mask=torch.ones((12, 12), dtype=torch.bool))


BASE = dict(num_frame_per_block=3, guidance_scale=5.0, sampling_steps=3, timestep_shift=5.0,
            context_noise=0)

CAUSAL_CASES = {
    # name: (config overrides, noise frames, initial latent frames, VAE, negative embeds)
    "unipc": ({"sample_solver": "unipc"}, 3, 0, True, False),
    "dpm++": ({"sample_solver": "dpm++"}, 6, 0, False, True),
    "unipc_initial_latent": ({"sample_solver": "unipc"}, 3, 3, False, False),
    "dpm++_context_noise": ({"sample_solver": "dpm++", "context_noise": 250}, 6, 0, False,
                            False),
}


@pytest.fixture(scope="module")
def jax_causal(models):
    """One JAX pipeline for every case, so that its jitted forwards compile
    once; each case sets the solver, the refresh timestep and the VAE."""
    return JCausalDiff(jconfig(**BASE), F32CrossGen(models[0]))


@pytest.mark.parametrize("case", sorted(CAUSAL_CASES))
def test_causal_diffusion_matches_jax(models, jax_causal, case):
    _, jv, tgen, tv, emb = models
    overrides, frames, n_init, with_vae, with_neg = CAUSAL_CASES[case]
    cfg = {**BASE, **overrides}
    jp = jax_causal
    jp.sample_solver, jp.context_noise = cfg["sample_solver"], float(cfg["context_noise"])
    jp.vae = jv if with_vae else None
    tp = CausalDiffusionInferencePipeline(load_server_config(**cfg), tgen,
                                          vae=tv if with_vae else None)
    noise = _noise(40 + frames, frames)
    init = _noise(50 + n_init, n_init) if n_init else None
    neg = _emb(13, tgen.cfg.text_dim) if with_neg else None
    jout = jp.inference(jnp.asarray(noise), prompt_embeds=jnp.asarray(emb),
                        neg_prompt_embeds=None if neg is None else jnp.asarray(neg),
                        initial_latent=None if init is None else jnp.asarray(init),
                        return_latents=True)
    tout = tp.inference(torch.from_numpy(noise), prompt_embeds=torch.from_numpy(emb),
                        neg_prompt_embeds=None if neg is None else torch.from_numpy(neg),
                        initial_latent=None if init is None else torch.from_numpy(init),
                        return_latents=True)
    _check(tout, jout, (1, frames + n_init, 16, H, W))
    if init is not None:  # the initial latents pass through unchanged
        assert torch.equal(tout[1][:, :n_init], torch.from_numpy(init))
    size = 21 * tgen.cfg.frame_seq_length(H, W)
    assert tp.kv_cache_pos["k"].shape[2] == tp.kv_cache_neg["k"].shape[2] == size
    assert tp.kv_cache_pos["local_end"] == (frames + n_init) * size // 21


@pytest.mark.parametrize("solver, with_vae", [("unipc", True), ("dpm++", False)])
def test_bidirectional_diffusion_matches_jax(models, solver, with_vae):
    jgen, jv, tgen, tv, emb = models
    jgen = F32CrossGen(jgen)
    cfg = {**BASE, "sample_solver": solver}
    jp = JBiDiff(jconfig(**cfg), jgen, vae=jv if with_vae else None)
    tp = BidirectionalDiffusionInferencePipeline(load_server_config(**cfg), tgen,
                                                 vae=tv if with_vae else None)
    noise = _noise(60, 3)
    jout = jp.inference(jnp.asarray(noise), prompt_embeds=jnp.asarray(emb), return_latents=True)
    tout = tp.inference(torch.from_numpy(noise), prompt_embeds=torch.from_numpy(emb),
                        return_latents=True)
    _check(tout, jout, (1, 3, 16, H, W))


def test_bidirectional_few_step_matches_jax(models):
    """The default config's step list, [1000, 937, 833, 625, 0]: its last
    forward runs at t = 0. JAX attends under its all-true mask, the port
    under none; the draws are JAX's key splits, one a step but the last."""
    jgen, jv, tgen, tv, emb = models
    jp = JBiFew(jconfig(), F32CrossGen(jgen), vae=jv)
    tp = BidirectionalInferencePipeline(load_server_config(), tgen, vae=tv)
    steps = tp.denoising_step_list
    assert steps == jp.denoising_step_list and len(steps) == 5 and steps[-1] == 0.0
    noise = _noise(70, 3)
    draws = []
    replay = jax_key_noise(9)

    def counted(*a):
        draws.append(a[0])
        return replay(*a)

    jout = jp.inference(jnp.asarray(noise), prompt_embeds=jnp.asarray(emb), return_latents=True,
                        seed=9)
    tout = tp.inference(torch.from_numpy(noise), prompt_embeds=torch.from_numpy(emb),
                        return_latents=True, noise_fn=counted)
    _check(tout, jout, (1, 3, 16, H, W))
    assert len(draws) == len(steps) - 1


class PromptEncoder(SeededTextEncoder):
    """The seeded encoder at the tiny model's width (16 tokens), recording
    the prompts it is given."""

    def __init__(self, text_dim: int):
        super().__init__("cpu", 16, text_dim)
        self.prompts = []

    def __call__(self, text_prompts):
        self.prompts += list(text_prompts)
        return super().__call__(text_prompts)


def test_wan_t2v_generate_is_the_pipeline_on_torch_noise(models):
    _, _, tgen, tv, _ = models
    enc = PromptEncoder(tgen.cfg.text_dim)
    wan = WanT2V(tgen, enc, tv, sample_solver="unipc", sampling_steps=3)
    video = wan.generate("a cat", size=(8 * W, 8 * H), frame_num=9, seed=4)
    assert enc.prompts == [SAMPLE_NEG_PROMPT, "a cat"]
    assert tuple(video.shape) == (9, 3, 8 * H, 8 * W)
    assert float(video.min()) >= -1.0 and float(video.max()) <= 1.0
    assert torch.isfinite(video).all() and float(video.std()) > 0

    noise = torch.randn(WanT2V.latent_shape((8 * W, 8 * H), 9),
                        generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    cfg = load_server_config(sample_solver="unipc", sampling_steps=3, guidance_scale=5.0,
                             timestep_shift=5.0)
    pipe = BidirectionalDiffusionInferencePipeline(cfg, tgen, enc, tv)
    want = pipe.inference(noise, text_prompts=["a cat"],
                          neg_prompt_embeds=enc([SAMPLE_NEG_PROMPT])["prompt_embeds"])
    assert torch.equal(video, want[0] * 2.0 - 1.0)
    other = wan.generate("a cat", size=(8 * W, 8 * H), frame_num=9, n_prompt="blurry", seed=4)
    assert not torch.equal(other, video)  # the negative prompt guides
