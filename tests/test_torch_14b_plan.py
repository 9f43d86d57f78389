"""The port's serving memory plan against the JAX package's
`serving_memory_plan(cfg, tp=1)`, field for field, for t2v-1.3B and t2v-14B:
the JAX side counts its parameters with `jax.eval_shape`, the port's on the
meta device, so neither allocates. The 14B's plan fits one 80 GB H100 with
15% held back at the server's 6-frame window and at the reference's
worst-case 21, and does not fit a 16 GB v5e. The meta-device parameter count
equals a real init's bytes."""
import pytest
import torch

from realtime_video_tpu.config import WAN_CONFIGS as J_CONFIGS
from realtime_video_tpu.parallel.plan import serving_memory_plan as jax_plan
from realtime_video_tpu_torch.config import WAN_CONFIGS, WanModelConfig
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.parallel import plan as tplan

FIELDS = ("dit_params", "kv_cache", "crossattn_cache", "activations", "total")
H100_BUDGET = int(0.85 * 80 * 1024**3)
V5E_BYTES = 16 * 1024**3


@pytest.mark.parametrize("model", ["t2v-1.3B", "t2v-14B"])
@pytest.mark.parametrize("window_frames", [6, 21])
def test_plan_matches_jax_at_tp1(model, window_frames):
    want = jax_plan(J_CONFIGS[model], tp=1, window_frames=window_frames)
    got = tplan.serving_memory_plan(WAN_CONFIGS[model], window_frames=window_frames)
    assert {f: getattr(got, f) for f in FIELDS} == {f: getattr(want, f) for f in FIELDS}
    assert got.table() == want.table()


def test_14b_fits_one_h100_not_a_v5e():
    cfg = WAN_CONFIGS["t2v-14B"]
    for frames, total_gb in ((6, 38), (21, 58)):
        plan = tplan.serving_memory_plan(cfg, window_frames=frames)
        assert abs(plan.total / 1e9 - total_gb) < 1.0, plan.table()
        assert V5E_BYTES < plan.total <= H100_BUDGET, plan.table()
    assert 27e9 < tplan.dit_param_bytes(cfg) < 30e9  # ~28 GB of bf16 weights



def test_param_bytes_on_meta_equal_a_real_init():
    """The meta-device count equals the bytes of a real (small) init, its f32
    leaves included."""
    cfg = WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
    params = wan_dit.init_wan_params(cfg, torch.Generator().manual_seed(0), "cpu")
    total, stack = 0, [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    assert tplan.dit_param_bytes(cfg) == total
