"""The port's server warm-up on the CPU, on tests/test_torch_session.py's tiny
bf16 models:

  * `warmup_models` at shapes ((64, 64), (64, 32)) runs, once per shape,
    the session's `block_step` on block 0 (no context) and on a steady block
    (3 context frames), block 0's decode per latent (fresh, then with the
    cache), the steady block's per-latent decode continuing that cache (or,
    with `use_taehv`, TAEHV's whole-block decode, fresh then with state) and
    one frame of the stream encode, each at the shape's latent size, and it
    leaves the pipeline's caches as it found them; with the VAE split away
    from the DiT the steady block is decoded per latent too, in either
    session mode (RTV_SESSION_MEGAFUSE);
  * a session on warmed models gives frames bit-equal to one on fresh
    models;
  * `create_app` runs the warm-up under DO_COMPILE=1 and not without it;
  * `load_pipeline` builds the serving pipeline, and `load_all` builds it
    through `load_pipeline`.
"""
import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.config import load_server_config
from realtime_video_tpu_torch.models import taehv as taehv_mod
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline
from realtime_video_tpu_torch.serving import models as models_mod
from realtime_video_tpu_torch.serving import server as server_mod
from realtime_video_tpu_torch.serving import session as session_mod
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.serving.session import GenerationSession
from test_torch_session import REQ, one_torch_thread, stacks  # noqa: F401

SHAPES = ((64, 64), (64, 32))


def _spy(monkeypatch, obj, name, calls, key):
    real = getattr(obj, name)

    def wrapped(*a, **k):
        calls.append((key, a, k))
        return real(*a, **k)

    monkeypatch.setattr(obj, name, wrapped)


@pytest.mark.parametrize("use_taehv", [False, True])
def test_warmup_runs_each_shape_once(stacks, monkeypatch, use_taehv):  # noqa: F811
    config, _, tm = stacks
    config = load_server_config(num_frame_per_block=3, use_taehv=use_taehv)
    calls = []
    _spy(monkeypatch, session_mod, "block_step", calls, "block_step")
    _spy(monkeypatch, tm.vae_decoder, "decode_block", calls, "decode")
    _spy(monkeypatch, tm.vae_encoder, "encode_stream", calls, "encode")
    _spy(monkeypatch, taehv_mod, "taehv_decode", calls, "taehv")
    if use_taehv:
        monkeypatch.setattr(tm, "taehv_params", taehv_mod.init_taehv_params(
            torch.Generator().manual_seed(0), "cpu", torch.bfloat16))
    pipe = tm.pipeline
    before = (pipe.kv_cache, pipe.crossattn_cache, pipe.local_attn_size)
    out = models_mod.warmup_models(tm, config, shapes=SHAPES)
    assert set(out["shapes"]) == {"64x64", "64x32"}
    assert (pipe.kv_cache, pipe.crossattn_cache, pipe.local_attn_size) == before
    per_shape = len(calls) // 2
    for (w, h), shape_calls in zip(SHAPES, (calls[:per_shape], calls[per_shape:])):
        kinds = [c[0] for c in shape_calls]
        want = (["block_step", "decode", "decode", "block_step"]
                + (["taehv", "taehv"] if use_taehv else ["decode"] * 3) + ["encode"])
        assert kinds == want, kinds
        steps = [c for c in shape_calls if c[0] == "block_step"]
        assert steps[0][1][4] is None  # block 0: no context
        assert tuple(steps[1][1][4].shape) == (1, 3, 16, h // 8, w // 8)
        assert tuple(steps[1][1][5].shape) == (1, 3, 16, h // 8, w // 8)
        assert steps[1][1][6] == 3 * (h // 16) * (w // 16)  # the steady block's start
        decodes = [c for c in shape_calls if c[0] == "decode"]
        assert decodes[0][1][1:] == () and all(len(c[1]) == 2 for c in decodes[1:])
        assert all(tuple(c[1][0].shape) == (1, 1, 16, h // 8, w // 8) for c in decodes)
        enc = [c for c in shape_calls if c[0] == "encode"][0]
        assert tuple(enc[1][0].shape) == (1, 1, 3, h, w)
        if use_taehv:
            taehv = [c for c in shape_calls if c[0] == "taehv"]
            assert taehv[0][1][2] is None and taehv[1][1][2] is not None
            assert all(tuple(c[1][1].shape) == (1, 3, 16, h // 8, w // 8) for c in taehv)


@pytest.mark.parametrize("megafuse", ["1", "0"])
def test_warmup_decodes_as_a_session_with_the_vae_apart(stacks, monkeypatch,  # noqa: F811
                                                       megafuse):
    """With the VAE split over 2 row shards (away from the DiT), a session
    decodes a warm block per latent in either mode (throughput mode only
    sends its frames at once), so the warm-up does too: block 0's two
    per-latent decodes, then the steady block's 3, each continuing the
    cache."""
    from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper

    monkeypatch.setenv("RTV_SESSION_MEGAFUSE", megafuse)
    config, _, tm = stacks
    split = VAEWrapper(tm.vae_decoder.cfg, tm.vae_decoder.params, mesh=["cpu", "cpu"])
    models = models_mod.Models(tm.text_encoder, tm.transformer, tm.pipeline, split, split)
    calls = []
    _spy(monkeypatch, split, "decode_block", calls, "decode")
    models_mod.warmup_models(models, config, shapes=SHAPES[:1])
    latents = [c[1][0].shape[1] for c in calls]
    assert latents == [1] * 5
    assert calls[0][1][1:] == () and all(len(c[1]) == 2 for c in calls[1:])


def _session_frames(config, tm):
    frames = []
    s = GenerationSession(GenerateParams(**dict(REQ, num_blocks=2)), config, models=tm,
                          frame_callback=lambda px, ids, ev: frames.append(px.clone()))
    s.generate_block(tm)
    s.generate_block(tm)
    return frames


def test_warmed_session_equals_fresh_session(stacks):  # noqa: F811
    config, _, tm = stacks
    fresh = _session_frames(config, tm)
    models_mod.warmup_models(tm, config, shapes=SHAPES)
    warm = _session_frames(config, tm)
    assert len(fresh) == len(warm) == 3  # 2 + 4, then block 1's 12 in one callback
    for a, b in zip(fresh, warm):
        assert torch.equal(a, b)


@pytest.mark.parametrize("flag,runs", [("1", True), ("true", True), ("0", False), (None, False)])
def test_create_app_warms_up_under_do_compile(stacks, monkeypatch, flag, runs):  # noqa: F811
    config, _, tm = stacks
    seen = []
    monkeypatch.setattr(server_mod, "warmup_models",
                        lambda models, cfg: seen.append((models, cfg)) or {"build_s": 0.0})
    if flag is None:
        monkeypatch.delenv("DO_COMPILE", raising=False)
    else:
        monkeypatch.setenv("DO_COMPILE", flag)
    app = server_mod.create_app(config, tm)
    assert app["models"] is tm
    assert seen == ([(tm, config)] if runs else [])
    assert ("warmup" in app) == runs


def test_load_pipeline_and_load_all_use_it(stacks, monkeypatch):  # noqa: F811
    config, _, tm = stacks
    pipe = models_mod.load_pipeline(config, tm.transformer, tm.text_encoder, tm.vae_decoder)
    assert isinstance(pipe, CausalInferencePipeline)
    assert (pipe.generator, pipe.text_encoder, pipe.vae) == \
        (tm.transformer, tm.text_encoder, tm.vae_decoder)
    assert pipe.num_frame_per_block == 3
    built = []
    monkeypatch.setattr(models_mod, "load_transformer", lambda *a, **k: tm.transformer)
    monkeypatch.setattr(models_mod, "load_text_encoder", lambda *a, **k: tm.text_encoder)
    monkeypatch.setattr(models_mod, "load_vae", lambda *a, **k: tm.vae_decoder)
    real = models_mod.load_pipeline
    monkeypatch.setattr(models_mod, "load_pipeline",
                        lambda *a: built.append(a) or real(*a))
    m = models_mod.load_all(config, "cpu")
    assert built == [(config, tm.transformer, tm.text_encoder, tm.vae_decoder)]
    assert m.pipeline.generator is tm.transformer and m.vae_encoder is tm.vae_decoder
    assert np.array_equal(m.pipeline.denoising_step_list, pipe.denoising_step_list)
