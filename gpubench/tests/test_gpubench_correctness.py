"""`correct` at a size a CPU test run holds (the tiny cell of tiny.py, the
port's plain kernels): the program passes; the control (the int4 reference
in the program's place) fails; and each fault a serving cell can have,
planted in the timed path, makes the run's `correct` false."""
import os

import pytest
import torch

from gpubench import run
from gpubench.tests import tiny

#: limits of the tiny cell, between its readings at seed 2**31 + 11 (program:
#: x0 0.0064, pixels 0.076-0.088; control: x0 0.058, pixels 0.66-0.76)
TINY_LIMITS = {"x0_block0": 0.02, "x0_warm": 0.02, "px_block0": 0.3, "px_warm": 0.3}


@pytest.fixture
def cell(monkeypatch):
    """The tiny cell, the process's environment and the port's patched
    functions restored afterwards."""
    from realtime_video_tpu_torch.models import t5, vae, vae_wrapper, wan_dit
    from realtime_video_tpu_torch.serving import session

    monkeypatch.setattr(os, "environ", os.environ.copy())
    for mod, name in ((wan_dit, "init_wan_params"), (t5, "init_t5_encoder_params"),
                      (vae, "init_vae_params"), (session, "block_step"),
                      (wan_dit, "context_prefill"),
                      (vae_wrapper.VAEWrapper, "decode_block")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    cfg, mix, work = tiny.tiny_cell()
    cfg["limits"] = TINY_LIMITS
    tiny.use_tiny_port(monkeypatch, cfg)
    return cfg, mix, work


def _run(cell, control=False):
    cfg, mix, work = cell
    args = tiny.args()
    args.control = control
    return run.run(args, device="cpu", cfg=cfg, mix=mix, work=work)


def test_the_program_passes_and_the_control_fails(cell):
    program = _run(cell)
    assert program["correct"], program["checks"]
    assert set(program["checks"]) == set(TINY_LIMITS)
    control = _run(cell, control=True)
    checks = control["checks"]
    assert not control["correct"], checks
    for name, c in program["checks"].items():
        assert checks["program." + name]["value"] == c["value"]
        assert checks[name]["value"] >= 3 * c["value"], (name, checks[name], c)


def test_a_block_that_returns_its_input_is_not_correct(cell, monkeypatch):
    from realtime_video_tpu_torch.serving import session

    def unchanged(gen, kv_cache, cross, steps, clean_context, noisy, *args):
        return noisy, kv_cache

    monkeypatch.setattr(session, "block_step", unchanged)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["x0_block0"]["value"] > TINY_LIMITS["x0_block0"]


def test_a_cache_left_unfilled_is_not_correct(cell, monkeypatch):
    from realtime_video_tpu_torch.models import wan_dit

    monkeypatch.setattr(wan_dit, "context_prefill",
                        lambda cfg, params, ctx, rope, cross, kv, *a, **k: kv)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["x0_warm"]["value"] > TINY_LIMITS["x0_warm"]


def test_a_frame_altered_where_it_is_decoded_is_not_correct(cell, monkeypatch):
    from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper

    decode = VAEWrapper.decode_block

    def altered(self, latents, cache=None):
        px, cache = decode(self, latents, cache)
        px = px.clone()
        px[:, -1] = torch.flip(px[:, -1], dims=(-1,))  # the last frame mirrored
        return px, cache

    monkeypatch.setattr(VAEWrapper, "decode_block", altered)
    result = _run(cell)
    assert not result["correct"]
    assert result["checks"]["px_warm"]["value"] > TINY_LIMITS["px_warm"]
