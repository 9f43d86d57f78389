"""The on-disk cache of quantised trees (`utils/qcache.py`, the port of the
JAX package's): miss, store, hit gives the tree that was built, bit for bit
and stride for stride (the K-major int8 weights the kernels' layout checks
require); a corrupt entry is rebuilt; a changed source hash misses;
RTV_QUANT_CACHE=0 writes nothing; and the int8 loaders at tiny dims give
bit-equal trees from a cold and a warm cache. Every test keeps its entries
in its own tmp_path (RTV_QUANT_CACHE_DIR)."""
import dataclasses
import os
import types

import pytest
import torch

from realtime_video_tpu_torch.config import VAEConfig, load_server_config
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.ops import hopper_conv, hopper_int8_mm
from realtime_video_tpu_torch.serving import models as serving_models
from realtime_video_tpu_torch.utils import qcache


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("RTV_QUANT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("RTV_QUANT_CACHE", "1")
    return tmp_path


def entries(path, prefix="test"):
    return sorted(f for f in os.listdir(path) if f.startswith(f".rtv_{prefix}_"))


@dataclasses.dataclass(frozen=True)
class Cfg:
    dim: int = 64


def int8_tree():
    g = torch.Generator().manual_seed(0)
    w_mm = torch.randint(-127, 128, (32, 48), generator=g, dtype=torch.int8)
    w_conv = torch.randint(-127, 128, (3, 3, 3, 8, 16), generator=g, dtype=torch.int8)
    return {"cfg": Cfg(), "steps": (1000.0, 750.0),
            "params": {"lin": {"w_q": hopper_int8_mm.k_major(w_mm),
                               "scale": torch.rand(48, generator=g)},
                       "conv": {"w_q": hopper_conv.k_major(w_conv),
                                "b": torch.rand(16, generator=g).to(torch.bfloat16)},
                       "blocks": [torch.ones(2, 3)[:, 1:], None]}}


def assert_same_tree(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype
        assert got.shape == want.shape and got.stride() == want.stride()
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_same_tree(a, b)
    else:
        assert got == want


def test_hit_gives_the_built_tree_with_its_strides(cache_dir):
    calls = []

    def build():
        calls.append(1)
        return int8_tree()

    built = qcache.cached_tree("test", "k1", build)
    hit = qcache.cached_tree("test", "k1", build)
    assert len(calls) == 1 and len(entries(cache_dir)) == 1
    assert_same_tree(hit, built)
    hopper_int8_mm.check_weight_layout(hit["params"]["lin"]["w_q"])
    hopper_conv.check_weight_layout(hit["params"]["conv"]["w_q"])
    qcache.cached_tree("test", "k2", build)  # another key misses
    assert len(calls) == 2


def test_corrupt_entry_is_rebuilt(cache_dir):
    calls = []

    def build():
        calls.append(1)
        return int8_tree()

    qcache.cached_tree("test", "kc", build)
    (name,) = entries(cache_dir)
    path = cache_dir / name
    path.write_bytes(path.read_bytes()[:100])  # a writer killed mid-write
    got = qcache.cached_tree("test", "kc", build)
    assert len(calls) == 2
    assert_same_tree(got, int8_tree())
    assert_same_tree(qcache.cached_tree("test", "kc", build), int8_tree())
    assert len(calls) == 2  # the rebuild stored a loadable entry
    assert not any(".tmp." in f for f in os.listdir(cache_dir))


def test_a_changed_source_hash_misses(cache_dir, tmp_path):
    src = tmp_path / "module_src.py"
    src.write_text("SCALE = 1\n")
    module = types.SimpleNamespace(__file__=str(src))
    calls = []

    def load():
        key = qcache.cache_key("random:t2v-tiny", 5.0, qcache.code_hash(module))
        return qcache.cached_tree("test", key, lambda: calls.append(1) or int8_tree())

    load()
    load()
    assert len(calls) == 1
    src.write_text("SCALE = 2\n")
    load()
    assert len(calls) == 2 and len(entries(cache_dir)) == 2


def test_disabled_cache_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("RTV_QUANT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("RTV_QUANT_CACHE", "0")
    calls = []
    qcache.cached_tree("test", "k1", lambda: calls.append(1) or int8_tree())
    qcache.cached_tree("test", "k1", lambda: calls.append(1) or int8_tree())
    assert len(calls) == 2 and os.listdir(tmp_path) == []


def test_int8_load_all_twice_gives_bit_equal_trees(cache_dir, monkeypatch):
    """load_all in the int8 tier at tiny dims (t2v-tiny, a tiny VAE, the static
    embedding): the second load hits both entries, quantises nothing, and
    hands back the trees the first built."""
    tiny_vae = VAEConfig(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
    monkeypatch.setattr(serving_models.VAEWrapper, "from_model_folder", classmethod(
        lambda cls, dtype, device, seed: VAEWrapper(tiny_vae, device=device, dtype=dtype,
                                                    seed=seed)))
    monkeypatch.setenv("USE_STATIC_ENCODER_COND_DICT", "1")
    quantised = []
    quantize = wan_dit.quantize_wan_linears
    monkeypatch.setattr(wan_dit, "quantize_wan_linears",
                        lambda *a, **k: quantised.append(1) or quantize(*a, **k))
    config = load_server_config(model_name="t2v-tiny", num_frame_per_block=3,
                                num_denoising_steps=2, enable_int8=True, enable_int8_dit=True,
                                int8_static_scales=True)
    cold = serving_models.load_all(config, "cpu", seed=0)
    assert len(entries(cache_dir, "dit_qparams")) == len(entries(cache_dir, "vae_qparams")) == 1
    warm = serving_models.load_all(config, "cpu", seed=0)
    assert len(quantised) == 1
    assert warm.transformer.cfg == cold.transformer.cfg
    assert_same_tree(warm.transformer.params, cold.transformer.params)
    assert_same_tree(warm.vae_decoder.params, cold.vae_decoder.params)
    qkv = warm.transformer.params["blocks"]["self_attn"]["qkv"]["w_q"]
    assert qkv.dtype == torch.int8
    other_seed = serving_models.load_transformer(config, "cpu", seed=1)  # another key
    assert len(quantised) == 2 and len(entries(cache_dir, "dit_qparams")) == 2
    assert not torch.equal(other_seed.params["blocks"]["self_attn"]["qkv"]["w_q"], qkv)
