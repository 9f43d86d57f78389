"""The whole slice at tiny dims on the CPU: 3 blocks of the port's
GenerationSession against 3 blocks of the JAX GenerationSession, with the
same parameters (converted from the JAX tree), the same text embeddings,
the same initial noise and the same per-step renoise (the JAX session's own
`jax.random` stream, fed to the port through `noise_fn`).

Both sessions run bf16, as serving does, so they cover the block step (KV
reset, context prefill, 4-step denoise), the streamed decode with the block-0
drop, the anti-drift re-encode of block 2 and a prompt lerp. XLA and torch
round bf16 at different places on the CPU, so the bars are bf16 ones:
latents atol 5e-2 with rtol 2e-2 (a few bf16 ulps at |x| <= 4); pixels mean
abs difference < 3e-2, because the random-init VAE amplifies bf16 rounding
(the same decode agrees to 1e-5 in f32, tests/test_torch_vae.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import VAEConfig, WanModelConfig, load_server_config
from realtime_video_tpu.models import taehv as jtaehv
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.diffusion_wrapper import WanDiffusion as JGen
from realtime_video_tpu.models.vae_wrapper import VAEWrapper as JVAE
from realtime_video_tpu.pipelines import CausalInferencePipeline as JPipe
from realtime_video_tpu.serving.models import Models as JModels
from realtime_video_tpu.serving.params import GenerateParams as JParams
from realtime_video_tpu.serving.session import GenerationSession as JSession
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper as TVAE
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline as TPipe
from realtime_video_tpu_torch.serving.models import Models as TModels
from realtime_video_tpu_torch.serving.params import GenerateParams as TParams
from realtime_video_tpu_torch.serving.session import GenerationSession as TSession
from realtime_video_tpu_torch.utils.convert import (
    taehv_params_from_jax,
    vae_params_from_jax,
    wan_params_from_jax,
)

WAN = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
VAEC = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
REQ = dict(prompt="a cat", width=64, height=64, seed=1, num_blocks=3,
           num_denoising_steps=4, kv_cache_num_frames=3)


def numpy_tree(init_fn, seed):
    """Random bf16-representable weights in the structure of a JAX init
    (eval_shape: the eager JAX inits cost tens of seconds here)."""
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
    vae_np, vae_shapes = numpy_tree(
        lambda k: jvae.init_vae_params(k, VAEC, jnp.bfloat16), 1)
    as_jax = lambda tree, shapes: jax.tree.map(  # noqa: E731
        lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    jgen = JGen(cfg=WAN, params=as_jax(dit_np, dit_shapes))
    jv = JVAE(cfg=VAEC, params=as_jax(vae_np, vae_shapes))
    jm = JModels(Encoder(lambda a: jnp.asarray(a, jnp.bfloat16)), jgen,
                 JPipe(config, jgen, text_encoder=None, vae=jv), jv, jv)
    tgen = TGen(cfg=WAN, params=wan_params_from_jax(dit_np, dtype=torch.bfloat16))
    tv = TVAE(VAEC, vae_params_from_jax(vae_np, dtype=torch.bfloat16))
    tm = TModels(Encoder(lambda a: torch.from_numpy(a).to(torch.bfloat16)), tgen,
                 TPipe(config, tgen), tv, tv)
    return config, jm, tm


def run_sessions(config, jm, tm):
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
    encodes = []
    encode = tm.vae_encoder.encode_stream
    tm.vae_encoder.encode_stream = lambda *a: encodes.append(1) or encode(*a)
    try:
        for b in range(3):
            js.generate_block_internal(jm)
            ts.generate_block_internal(tm)
            if b == 0:  # a live prompt change, lerped over the next 2 blocks
                js.interpolate_prompt_embeds(jm, "a dog", 2)
                ts.interpolate_prompt_embeds(tm, "a dog", 2)
        assert ts.generate_block_internal(tm) is None  # the block budget is spent
    finally:
        tm.vae_encoder.encode_stream = encode
    return js, ts, jframes, tframes, encodes


def test_three_block_session_matches_jax(stacks):
    config, jm, tm = stacks
    js, ts, jframes, tframes, encodes = run_sessions(config, jm, tm)
    jl = np.asarray(js.all_latents.astype(jnp.float32))
    tl = ts.all_latents.float().numpy()
    for b in range(3):
        np.testing.assert_allclose(tl[:, 3 * b:3 * b + 3], jl[:, 3 * b:3 * b + 3],
                                   rtol=2e-2, atol=5e-2, err_msg=f"block {b}")
    # frames: block 0 decodes 1 + 4 + 4 and drops its first 3, then 12 per
    # block, sent per latent frame
    assert [f.shape[1] for f in tframes] == [2, 4] + [4] * 6
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 30, 3, 64, 64)
    assert np.isfinite(T).all()
    assert float(np.abs(J - T).mean()) < 3e-2
    assert ts.total_frames_sent == js.total_frames_sent == 30
    assert len(encodes) == 1  # the anti-drift re-encode runs from block 2 on


def test_taehv_session_matches_jax(stacks, monkeypatch):
    """The TAEHV preview tier (`use_taehv`): 3 blocks against the JAX
    session's eager TAEHV path (the JAX tests hold its fused path equal to
    it), with the same TAEHV weights (bf16) carried across. Each block is
    decoded whole: 12 frames, block 0 dropping its first 3, so 9 + 12 + 12;
    TAEHV's pixels feed block 2's anti-drift re-encode. Same bars as the Wan
    decode's session above."""
    config, jm, tm = stacks
    monkeypatch.setenv("RTV_SESSION_MEGAFUSE", "0")
    taehv_np, taehv_shapes = numpy_tree(lambda k: jtaehv.init_taehv_params(k, jnp.bfloat16), 4)
    # the init's spread (uniform +-1/sqrt(fan_in)), so that pixels stay near [-1, 1]
    taehv_np = jax.tree.map(lambda a: a / np.float32(np.sqrt(3.0)), taehv_np)
    monkeypatch.setattr(jm, "taehv_params", jax.tree.map(
        lambda a, s: jnp.asarray(a, s.dtype), taehv_np, taehv_shapes), raising=False)
    monkeypatch.setattr(tm, "taehv_params", taehv_params_from_jax(taehv_np, dtype=torch.bfloat16))
    taehv = load_server_config(num_frame_per_block=3, use_taehv=True)
    js, ts, jframes, tframes, encodes = run_sessions(taehv, jm, tm)
    jl = np.asarray(js.all_latents.astype(jnp.float32))
    np.testing.assert_allclose(ts.all_latents.float().numpy(), jl, rtol=2e-2, atol=5e-2)
    assert [f.shape[1] for f in tframes] == [f.shape[1] for f in jframes] == [9, 12, 12]
    J, T = np.concatenate(jframes, 1), np.concatenate(tframes, 1)
    assert J.shape == T.shape == (1, 33, 3, 64, 64)
    assert np.isfinite(T).all() and float(T.std()) > 1e-2
    assert float(np.abs(J - T).mean()) < 3e-2
    assert ts.total_frames_sent == js.total_frames_sent == 33
    assert len(encodes) == 1
    assert len(ts.decode_vae_cache) == 9  # one carried frame per MemBlock


def _png_bytes() -> bytes:
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(np.full((64, 64, 3), 90, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _npy_bytes(tz: int) -> bytes:
    from io import BytesIO

    buf = BytesIO()
    np.save(buf, np.zeros((tz, 16, 8, 8), np.float32))
    return buf.getvalue()


def _clip(path) -> str:
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 16, (64, 64))
    for i in range(13):
        writer.write(np.full((64, 64, 3), 10 * i, np.uint8))
    writer.release()
    return str(path)


@pytest.mark.parametrize("field", ["input_video", "webcam_mode", "start_frame",
                                   "resume_latents"])
def test_lifted_request_fields_are_served(stacks, field, tmp_path):
    """Each video-in field the port used to refuse now sets its session up:
    a clip's latents mixed into the noise (13 frames: 4 latents, so
    4 // 3 - 1 = 0 blocks by the reference's arithmetic), the webcam queue,
    a start frame's 3 resume latents, .npy resume latents."""
    config, _, tm = stacks
    value = {"input_video": lambda: _clip(tmp_path / "clip.avi"),
             "webcam_mode": lambda: True, "start_frame": _png_bytes,
             "resume_latents": lambda: _npy_bytes(3)}[field]()
    ts = TSession(TParams(**{**REQ, field: value, "strength": 0.5}), config, models=tm)
    if field == "input_video":
        assert ts.num_blocks == 0 and ts.params.strength == 0.5
        assert ts.generate_block_internal(tm) is None
    elif field == "webcam_mode":
        assert ts.params.strength == 0.5 and ts.frame_queue.empty()
    else:
        assert tuple(ts.resume_latents.shape) == (1, 3, 16, 8, 8)
        assert ts.params.strength == 1.0  # text-to-video from a start: pure noise
