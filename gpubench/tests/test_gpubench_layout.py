"""What a configuration file states about its layout, read the same way by
the run, the check and the count of work: today's draws and counts pinned,
the DiT's weights keyed by the generator the port passes, and the latent's
shape from the VAE's stride and channels."""
import hashlib
import json
from pathlib import Path

import pytest
import torch

from gpubench import check, layout, roofline, run, weights
from gpubench.reference.wan_dit import WanDiT
from gpubench.reference.wan_vae import frames_of_latents
from gpubench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11
#: sha256 of the tiny cell's draws at SEED, and of each configuration's
#: warm-block work, as the harness drew and counted them before a file could
#: state its layout
DRAWS = {"dit": "14dea91ec23ab4fd48905c279c6c2df5d7227db820a80f18905c9ef24a0ea6cd",
         "t5": "b21c64a914baceac34c39b587fb345c5cb2f1c4db291c5c535568b5f2628259a",
         "vae": "f60a82e9b7fa71474ffa612f858dd63f72f3b5ccc8497cf8aa21f122595db593"}
WORK = {"tiny": "629e5b8b28d7e4bb8dab1620de2828b65e72886288e8ecb6917b9e18840eb46d",
        "t2v-1.3b-int8": "e57b02b4ae8fa07f8d2bffba1b00b4a120b531f6570cf8f8fa2287785e78c844",
        "t2v-14b-int8qk": "a3dfe1b321a9ebe5b68296881c3d56889c9c0b04645babe0bc3022e51350efbe"}


def tree_hash(tree) -> str:
    """sha256 over every leaf's path, dtype, shape and bytes, in path order."""
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node, key=str):
                walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            h.update(repr(path).encode())
            h.update(str(node.dtype).encode())
            h.update(repr(tuple(node.shape)).encode())
            raw = node.detach().contiguous()
            raw = raw.view(torch.int16) if raw.dtype == torch.bfloat16 else raw.view(torch.uint8)
            h.update(raw.numpy().tobytes())

    walk(tree, ())
    return h.hexdigest()


def config(name: str) -> dict:
    if name == "tiny":
        return tiny.tiny_cell()[0]
    return json.loads((ROOT / f"gpubench/configs/{name}.json").read_text())


@pytest.fixture
def hooks(monkeypatch):
    """The port's init functions as the run replaces them, restored after."""
    from realtime_video_tpu_torch.models import t5, vae, wan_dit

    for mod, name in ((wan_dit, "init_wan_params"), (t5, "init_t5_encoder_params"),
                      (vae, "init_vae_params")):
        monkeypatch.setattr(mod, name, getattr(mod, name))
    cfg = tiny.tiny_cell()[0]
    tiny.use_tiny_port(monkeypatch, cfg)
    run.install_weight_hooks(cfg, SEED)
    return cfg


def test_todays_draws_and_counts_are_pinned(hooks):
    from realtime_video_tpu_torch.config import WAN_CONFIGS
    from realtime_video_tpu_torch.models import t5, vae, wan_dit

    cfg = hooks
    assert tree_hash(weights.dit_params(cfg, SEED, "cpu")) == DRAWS["dit"]
    assert tree_hash(weights.t5_params(cfg["text_encoder"], SEED, "cpu")) == DRAWS["t5"]
    assert tree_hash(weights.vae_params(cfg["vae"], SEED, "cpu")) == DRAWS["vae"]
    # the port's DiT, made from the run's seed, through the hook
    gen = torch.Generator().manual_seed(SEED)
    assert tree_hash(wan_dit.init_wan_params(WAN_CONFIGS["t2v-tiny"], gen, "cpu")) == DRAWS["dit"]
    assert tree_hash(t5.init_t5_encoder_params(None, gen, "cpu")) == DRAWS["t5"]
    assert tree_hash(vae.init_vae_params(None, gen, "cpu")) == DRAWS["vae"]
    for name, digest in WORK.items():
        work = layout.work(config(name))
        assert hashlib.sha256(json.dumps(work, sort_keys=True).encode()).hexdigest() == digest
        assert work == roofline.warm_block_work(config(name))


def test_two_dit_keys_draw_different_weights_and_the_reference_draws_each(hooks):
    from realtime_video_tpu_torch.config import WAN_CONFIGS
    from realtime_video_tpu_torch.models import wan_dit

    cfg = hooks
    port_cfg = WAN_CONFIGS["t2v-tiny"]
    first = wan_dit.init_wan_params(port_cfg, torch.Generator().manual_seed(SEED), "cpu")
    second = wan_dit.init_wan_params(port_cfg, torch.Generator().manual_seed(SEED + 1), "cpu")
    again = wan_dit.init_wan_params(port_cfg, torch.Generator().manual_seed(SEED + 1), "cpu")
    assert tree_hash(first) == DRAWS["dit"] != tree_hash(second) == tree_hash(again)
    assert tree_hash(second) == tree_hash(weights.dit_params(cfg, SEED, "cpu", key=1))
    for key, tree in ((0, first), (1, second)):
        ref = WanDiT(cfg, SEED, "cpu", qmax=None, key=key)
        layer = ref.float_layer(1)
        assert torch.equal(layer["fc1"][0], tree["blocks"]["ffn"]["fc1"]["w"][1].float())
        assert torch.equal(ref.top[("head", "head", "w")], tree["head"]["head"]["w"].float())


def test_the_latent_follows_the_vae_stride_and_channels():
    cfg = config("t2v-14b-int8qk")
    assert layout.latent_shape(cfg, 27) == (1, 27, 16, 60, 104)
    assert roofline.block_tokens(cfg) == 3 * 30 * 52
    wide = dict(cfg, vae=dict(cfg["vae"], z_dim=48, stride=[4, 16, 16]), in_dim=48, out_dim=48)
    assert layout.latent_shape(wide, 27) == (1, 27, 48, 30, 52)
    assert roofline.block_tokens(wide) == 3 * 15 * 26
    noise, draws = check.session_draws(tiny.tiny_cell()[0] | {"vae": dict(
        tiny.tiny_cell()[0]["vae"], z_dim=4, stride=[4, 16, 16])}, 1, 0, 2, 1, "cpu")
    assert noise.shape == (1, 6, 4, 4, 4) and draws[0][0].shape == (1, 3, 4, 4, 4)
    assert frames_of_latents(2, 1, 8) == list(range(9, 17))
    assert frames_of_latents(0, 2) == [0, 1, 2, 3, 4]
