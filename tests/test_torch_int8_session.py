"""The int8 tier of the whole slice at tiny dims on the CPU: 3 blocks of the
port's GenerationSession against 3 blocks of the JAX GenerationSession, both
on the same int8 parameters (the JAX `quantize_wan_linears` and
`quantize_vae_params` trees with static activation scales, carried across),
the same text embeddings, initial noise and per-step renoise (the JAX
session's own `jax.random` stream, fed to the port through `noise_fn`).

Both sessions run bf16 as served, so they cover the int8 block linears in the
KV prefill and the 4-step denoise, the int8 streamed decode with the block-0
drop, the int8 anti-drift re-encode of block 2 and a prompt lerp. The bars
are those of tests/test_torch_session.py (latents atol 5e-2 with rtol 2e-2,
pixels mean abs difference < 3e-2): XLA and torch round bf16 at different
places on the CPU, and a bf16 difference that moves an activation across a
quantisation boundary moves one int8 quantum of that linear's input, and the
block carries the step on. So the latents take a looser elementwise bar than
the bf16 session's: a few of 3072 elements per block exceed atol 5e-2 + rtol
2e-2 here (the largest difference 0.125, four bf16 ulps at |x| near 5), so
the bar is atol 0.15 + rtol 2e-2 elementwise, with the bulk held by a mean
absolute difference < 2.5e-2 (about 0.015 here). Pixels keep the bf16 bar,
mean absolute difference < 3e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAEConfig, WanModelConfig, load_server_config
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.pipelines import CausalInferencePipeline as JPipe
from realtime_video_tpu.serving.models import Models as JModels
from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu.serving.session import GenerationSession as JSession
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline as TPipe
from realtime_video_tpu_torch.serving.models import Models as TModels
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession as TSession
from realtime_video_tpu_torch.utils.convert import vae_params_from_jax, wan_params_from_jax

WAN = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
VAEC = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
REQ = dict(prompt="a cat", width=64, height=64, seed=1, num_blocks=3,
           num_denoising_steps=4, kv_cache_num_frames=3)


def numpy_tree(init_fn, seed):
    """Random bf16-representable weights in the structure of a JAX init."""
    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key if hasattr(path[-1], "key") else ""
        if name in ("gamma", "scale"):
            arr = 1.0 + 0.1 * rng.normal(size=s.shape)
        else:
            fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
            arr = rng.normal(size=s.shape) / np.sqrt(fan_in)
        return np.asarray(jnp.asarray(arr, s.dtype).astype(jnp.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes), shapes


class Encoder:
    """Prompt -> a fixed random embedding, the same numbers on both sides."""

    def __init__(self, to_tensor):
        rng = np.random.default_rng(5)
        self.embs = {p: rng.normal(size=(1, 16, WAN.text_dim)).astype(np.float32)
                     for p in ("a cat", "a dog")}
        self.to_tensor = to_tensor

    def __call__(self, text_prompts):
        return {"prompt_embeds": self.to_tensor(self.embs[text_prompts[0]])}


@pytest.fixture(scope="module")
def stacks():
    config = load_server_config(num_frame_per_block=3)
    dit_np, dit_shapes = numpy_tree(
        lambda k: jdit.fuse_qkv_params(jdit.init_wan_params(k, WAN, jnp.bfloat16)), 0)
    vae_np, vae_shapes = numpy_tree(lambda k: jvae.init_vae_params(k, VAEC, jnp.bfloat16), 1)
    as_jax = lambda tree, shapes: jax.tree.map(  # noqa: E731
        lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)

    # static activation scales from the port's calibration (held to the JAX
    # calibration by tests/test_torch_int8_dit.py and _vae.py); the same
    # numbers quantise the JAX trees, which both sessions then serve
    tgen_f = TGen(cfg=WAN, params=wan_params_from_jax(dit_np, dtype=torch.bfloat16))
    dit_scales = {k: v.numpy() for k, v in tgen_f.calibrate_act_scales(
        (1000.0, 750.0, 500.0, 250.0), lat_h=8, lat_w=8).items()}
    rng = np.random.default_rng(9)
    zc = torch.from_numpy(rng.normal(size=(1, 2, 4, 4, VAEC.z_dim)).astype(np.float32))
    pxc = torch.from_numpy(rng.uniform(-1, 1, size=(1, 1, 32, 32, 3)).astype(np.float32))
    vae_scales = tvae.calibrate_vae_act_scales(
        VAEC, vae_params_from_jax(vae_np, dtype=torch.bfloat16), zc.to(torch.bfloat16),
        pxc.to(torch.bfloat16))
    jdit_q = jdit.quantize_wan_linears(as_jax(dit_np, dit_shapes), act_scales=dit_scales)
    jvae_q = jvae.quantize_vae_params(as_jax(vae_np, vae_shapes), act_scales=vae_scales)

    jgen = JGen(cfg=WAN, params=jdit_q)
    jv = JVAE(cfg=VAEC, params=jvae_q)
    jm = JModels(Encoder(lambda a: jnp.asarray(a, jnp.bfloat16)), jgen,
                 JPipe(config, jgen, text_encoder=None, vae=jv), jv, jv)
    tgen = TGen(cfg=WAN, params=wan_params_from_jax(jax.device_get(jdit_q),
                                                    dtype=torch.bfloat16))
    tv = TVAE(VAEC, vae_params_from_jax(jax.device_get(jvae_q), dtype=torch.bfloat16))
    tm = TModels(Encoder(lambda a: torch.from_numpy(a).to(torch.bfloat16)), tgen,
                 TPipe(config, tgen), tv, tv)
    return config, jm, tm


def test_three_block_int8_session_matches_jax(stacks):
    config, jm, tm = stacks
    sa = tm.transformer.params["blocks"]["self_attn"]["qkv"]
    assert sa["w_q"].dtype == torch.int8 and "a_scale" in sa
    assert "w_q" in tm.vae_decoder.params["decoder"]["conv1"]
    assert "w_q" in tm.vae_encoder.params["encoder"]["conv1"]

    jframes, tframes = [], []
    js = JSession(JParams(**REQ), config, models=jm,
                  frame_callback=lambda px, ids, ev: jframes.append(np.asarray(px, np.float32)))
    key = {"k": js.rng}

    def jax_stream_noise(shape, dtype, device):  # the JAX denoise loop's draws
        key["k"], sub = jax.random.split(key["k"])
        nz = jax.random.normal(sub, shape, jnp.float32).astype(jnp.bfloat16)
        return torch.from_numpy(np.array(nz.astype(jnp.float32))).to(dtype)

    ts = TSession(TParams(**REQ), config, models=tm,
                  noise=torch.from_numpy(np.array(js.noise.astype(jnp.float32))),
                  noise_fn=jax_stream_noise,
                  frame_callback=lambda px, ids, ev: tframes.append(px.float().numpy()))
    for b in range(3):
        js.generate_block_internal(jm)
        ts.generate_block_internal(tm)
        if b == 0:  # a live prompt change, lerped over the next 2 blocks
            js.interpolate_prompt_embeds(jm, "a dog", 2)
            ts.interpolate_prompt_embeds(tm, "a dog", 2)

    jl = np.asarray(js.all_latents.astype(jnp.float32))
    tl = ts.all_latents.float().numpy()
    for b in range(3):
        t_b, j_b = tl[:, 3 * b:3 * b + 3], jl[:, 3 * b:3 * b + 3]
        np.testing.assert_allclose(t_b, j_b, rtol=2e-2, atol=0.15, err_msg=f"block {b}")
        assert float(np.abs(t_b - j_b).mean()) < 2.5e-2, b
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 30, 3, 64, 64)
    assert np.isfinite(T).all()
    assert float(np.abs(J - T).mean()) < 3e-2
    assert ts.total_frames_sent == js.total_frames_sent == 30
