"""The three teacher-path pipelines against the unmodified JAX generator on
the CPU in f32, one case each.

The JAX pipelines round the prompt embeddings to bf16 and then compute the
text cross-attention K/V in bf16; the port, in f32, computes them in f32
from the same bf16-rounded embeddings (tests/test_torch_teacher_pipelines.py
holds the pipelines at 1e-3 against a JAX generator that does the same). The
two caches differ by ~4.7e-3 (relative Frobenius), and guidance amplifies
that: the readings are 2.7e-3 for the guided pipelines and 5.6e-4 for the
few-step one, under a bar of 5e-3. Computing the port's K/V in bf16 does
not close the gap (3.4e-3 on the cache), since XLA keeps excess precision
between the ops that torch rounds one at a time."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import load_server_config as jconfig
from realtime_video_tpu.pipelines.bidirectional_diffusion_inference import (
    BidirectionalDiffusionInferencePipeline as JBiDiff,
)
from realtime_video_tpu.pipelines.bidirectional_inference import (
    BidirectionalInferencePipeline as JBiFew,
)
from realtime_video_tpu.pipelines.causal_diffusion_inference import (
    CausalDiffusionInferencePipeline as JCausalDiff,
)
from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.pipelines import (
    BidirectionalDiffusionInferencePipeline,
    BidirectionalInferencePipeline,
    CausalDiffusionInferencePipeline,
)
from test_torch_causal_inference import H, W, jax_key_noise, models, rel_fro  # noqa: F401

REL_BF16_CROSS = 5e-3
CFG = dict(num_frame_per_block=3, guidance_scale=5.0, sampling_steps=3, timestep_shift=5.0,
           context_noise=0, sample_solver="unipc")
PIPELINES = {  # name: (JAX pipeline, port pipeline, config)
    "causal_diffusion": (JCausalDiff, CausalDiffusionInferencePipeline, CFG),
    "bidirectional_diffusion": (JBiDiff, BidirectionalDiffusionInferencePipeline, CFG),
    "few_step": (JBiFew, BidirectionalInferencePipeline, {}),  # the default step list
}


@pytest.mark.parametrize("pipeline", sorted(PIPELINES))
def test_pipeline_matches_unmodified_jax(models, pipeline):
    jgen, _, tgen, _, emb = models
    jcls, tcls, cfg = PIPELINES[pipeline]
    noise = np.random.default_rng(80).normal(size=(1, 3, 16, H, W)).astype(np.float32)
    jkw, tkw = {}, {}
    if pipeline == "few_step":  # JAX's key splits replayed through noise_fn
        jkw, tkw = {"seed": 9}, {"noise_fn": jax_key_noise(9)}
    _, jlat = jcls(jconfig(**cfg), jgen).inference(
        jnp.asarray(noise), prompt_embeds=jnp.asarray(emb), return_latents=True, **jkw)
    _, tlat = tcls(load_server_config(**cfg), tgen).inference(
        torch.from_numpy(noise), prompt_embeds=torch.from_numpy(emb), return_latents=True,
        **tkw)
    assert tuple(tlat.shape) == (1, 3, 16, H, W)
    assert rel_fro(tlat.numpy(), np.asarray(jlat)) < REL_BF16_CROSS
