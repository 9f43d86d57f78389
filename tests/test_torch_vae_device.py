"""Where the VAE runs (`serving/models.vae_placement`, `load_vae`, the
wrapper's `device=` / `mesh=` / `dit_device=`), held on the CPU with the card
count patched:

  * the choice: RTV_VAE_DEVICE before the config's `vae_device_index` (0 is
    a card, null none), RTV_VAE_SP_DEVICES before `vae_sp_devices`, a split
    of N >= 2 over cards 1..N that overrides a pin; a card that is not
    attached raises (the JAX loader warns and stays on the default chip);
  * `load_vae` builds the pinned and the split wrapper (bf16 and int8) from
    that choice, each decoding as the unpinned one does (f32, 1e-5);
  * RTV_VAE_CHUNK: latent frames per decoder pass, the same pixels;
  * every kernel binding makes its tensor's card current around its launch
    (the .cu side sets attributes on, and counts SMs of, the current
    device), each library keeps its SM count per device, and a bare "cuda"
    resolves to the current card's index.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

from realtime_video_tpu_torch.config import VAEConfig
from realtime_video_tpu_torch.models import vae as tvae
from realtime_video_tpu_torch.models import vae_wrapper as vw
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.serving import models as models_mod
from realtime_video_tpu_torch.utils import device as device_mod

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env, config, cards, want", [
    ({}, {}, 1, (None, ())),
    ({}, {"vae_device_index": None}, 2, (None, ())),
    ({}, {"vae_device_index": 0}, 1, (0, ())),
    ({}, {"vae_device_index": 1}, 2, (1, ())),
    ({"RTV_VAE_DEVICE": "0"}, {"vae_device_index": 1}, 2, (0, ())),
    ({"RTV_VAE_DEVICE": ""}, {"vae_device_index": 1}, 2, (1, ())),
    ({}, {"vae_sp_devices": 2}, 3, (None, (1, 2))),
    ({"RTV_VAE_SP_DEVICES": "4"}, {"vae_sp_devices": 2}, 8, (None, (1, 2, 3, 4))),
    ({"RTV_VAE_SP_DEVICES": "3", "RTV_VAE_DEVICE": "1"}, {}, 4, (None, (1, 2, 3))),
    ({"RTV_VAE_SP_DEVICES": "1"}, {"vae_device_index": 1}, 2, (1, ())),
    ({}, {"vae_sp_devices": None}, 1, (None, ())),
], ids=["none", "null_index", "index_0", "index_1", "env_before_config", "empty_env",
        "split_2", "env_split_before_config", "split_overrides_pin", "split_1_is_none",
        "null_split"])
def test_vae_placement(env, config, cards, want):
    assert models_mod.vae_placement(config, cards, env) == want


@pytest.mark.parametrize("env, config, cards, match", [
    ({"RTV_VAE_DEVICE": "1"}, {}, 1, "VAE device 1 requested"),
    ({}, {"vae_device_index": 2}, 2, "VAE device 2 requested"),
    ({}, {"vae_sp_devices": 2}, 2, "over 2 devices"),
    ({"RTV_VAE_SP_DEVICES": "4"}, {}, 4, "over 4 devices"),
], ids=["env_index", "config_index", "split_needs_n_plus_1", "env_split"])
def test_vae_placement_raises_for_missing_cards(env, config, cards, match):
    with pytest.raises(ValueError, match=match):
        models_mod.vae_placement(config, cards, env)


@pytest.fixture
def cpu_cards(monkeypatch):
    """load_vae on the CPU as if 3 cards were attached, each card the CPU,
    the Wan 2.1 VAE cut to the tiny config."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(models_mod, "_card", lambda i: torch.device("cpu"))
    monkeypatch.setattr(vw, "VAE_CONFIGS", {"wan2.1": CFG})
    monkeypatch.setenv("RTV_QUANT_CACHE", "0")
    for name in ("RTV_VAE_DEVICE", "RTV_VAE_SP_DEVICES", "RTV_VAE_FUSEUP", "RTV_VAE_CHUNK"):
        monkeypatch.delenv(name, raising=False)


def latents(t=2, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(1, t, CFG.z_dim, 8, 6)).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_load_vae_pins_and_splits(cpu_cards, monkeypatch, int8):
    config = {"enable_int8": int8}
    base = models_mod.load_vae(config, "cpu", seed=1)
    assert not base.split and base.devices == (torch.device("cpu"),)
    assert base.dit_device == torch.device("cpu")
    pinned = models_mod.load_vae(dict(config, vae_device_index=2), "cpu", seed=1)
    assert not pinned.split and pinned.devices == (torch.device("cpu"),)
    monkeypatch.setenv("RTV_VAE_SP_DEVICES", "2")
    split = models_mod.load_vae(config, "cpu", seed=1)
    assert split.split and split.devices == (torch.device("cpu"),) * 2
    assert len(split.shard_params) == 2
    assert models_mod.vae_devices(split) == split.devices
    assert models_mod._has_int8(split.shard_params) == int8
    z = latents()
    want, wc = base.decode_block(z)
    for vae in (pinned, split):
        got, gc = vae.decode_block(z)
        torch.testing.assert_close(got, want, **TOL)
        torch.testing.assert_close(vae.decode_block(z, gc)[0], base.decode_block(z, wc)[0],
                                   **TOL)
    px = torch.rand((1, 1, 3, 64, 48), generator=torch.Generator().manual_seed(2)) * 2 - 1
    torch.testing.assert_close(split.encode_stream(px.to(torch.bfloat16))[0],
                               base.encode_stream(px.to(torch.bfloat16))[0], **TOL)
    monkeypatch.setenv("RTV_VAE_SP_DEVICES", "3")
    with pytest.raises(ValueError, match="over 3 devices"):
        models_mod.load_vae(config, "cpu", seed=1)
    monkeypatch.setenv("RTV_VAE_SP_DEVICES", "")
    with pytest.raises(ValueError, match="VAE device 5 requested"):
        models_mod.load_vae(dict(config, vae_device_index=5), "cpu", seed=1)


def test_vae_chunk_and_dit_device(monkeypatch):
    params = tvae.init_vae_params(CFG, torch.Generator().manual_seed(3), "cpu", torch.float32)
    z = latents(3).float()
    want, _ = VAEWrapper(CFG, params).decode_block(z)
    monkeypatch.setenv("RTV_VAE_CHUNK", "2")
    vae = VAEWrapper(CFG, params)
    assert vae.chunk == 2
    torch.testing.assert_close(vae.decode_block(z)[0], want, **TOL)
    # offloaded wrappers send latents to the DiT's device; the default is
    # the current card, or the CPU for a CPU VAE
    assert VAEWrapper(CFG, params).dit_device is None
    assert VAEWrapper(CFG, params, device="cpu").dit_device == torch.device("cpu")
    assert VAEWrapper(CFG, params, mesh=["cpu"]).dit_device == torch.device("cpu")
    with pytest.raises(ValueError, match="names no device"):
        VAEWrapper(CFG, params, mesh=[])


def test_bare_cuda_resolves_to_the_current_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert device_mod.resolve_device() == torch.device("cuda", 1)
    assert device_mod.resolve_device("cuda") == torch.device("cuda", 1)
    assert device_mod.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert device_mod.indexed("cpu") == torch.device("cpu")


def _launches_outside_device_guard(path: pathlib.Path):
    """The `lib.rtv_*(...)` calls of a binding that no `with on_card(...)`
    block (`utils/device.on_card`) encloses."""
    tree = ast.parse(path.read_text())
    parents = {child: node for node in ast.walk(tree) for child in ast.iter_child_nodes(node)}

    def guarded(node):
        while node in parents:
            node = parents[node]
            if isinstance(node, ast.With) and any(
                    ast.unparse(item.context_expr).startswith("on_card(")
                    for item in node.items):
                return True
        return False

    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr.startswith("rtv_")]
    return len(calls), [ast.unparse(c.func) for c in calls if not guarded(c)]


@pytest.mark.parametrize("module, launches", [
    ("hopper_conv", 2), ("hopper_int8_mm", 1), ("hopper_attention", 5)])
def test_every_binding_launches_on_its_tensors_card(module, launches):
    n, unguarded = _launches_outside_device_guard(
        REPO / "realtime_video_tpu_torch" / "ops" / f"{module}.py")
    assert n == launches and unguarded == []


def test_on_card_switches_only_to_another_card(monkeypatch):
    """`on_card` enters `torch.cuda.device` only when the tensor's card is
    not the current one (the guard's host cost is paid across cards only)."""
    entered = []

    class Guard:
        def __init__(self, device):
            entered.append(device)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    for index, want in ((1, []), (0, [torch.device("cuda", 0)])):
        entered.clear()
        t = type("T", (), {"device": torch.device("cuda", index)})()
        with device_mod.on_card(t):
            pass
        assert entered == want


@pytest.mark.parametrize("source", ["conv_sm90.cu", "int8_mm.cu"])
def test_sm_count_is_kept_per_device(source):
    text = (REPO / "realtime_video_tpu_torch" / "csrc" / source).read_text()
    assert "[MAX_DEVICES]" in text and "cudaGetDevice(&dev)" in text
    assert "static int sms = 0;" not in text
