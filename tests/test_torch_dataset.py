"""The port's copies of the training datasets (`utils/dataset.py`) and the
LMDB helpers (`utils/lmdb_io.py`) against the JAX package's originals, on the
same files: prompt lists, npz ODE shards, image/caption pairs, and LMDB rows
through an in-memory stand-in for an lmdb environment (the lmdb package is
not installed, and opening an LMDB dataset must say so when it is tried)."""
import sys

import numpy as np
import pytest

from realtime_video_tpu.utils import dataset as jds
from realtime_video_tpu.utils import lmdb_io as jlm
from realtime_video_tpu_torch.utils import dataset as tds
from realtime_video_tpu_torch.utils import lmdb_io as tlm


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype
            else:
                assert x[k] == y[k]


def test_text_dataset(tmp_path):
    (tmp_path / "p.txt").write_text("a cat surfing\n\n  a dog  \nrain on glass\n")
    (tmp_path / "e.txt").write_text("long cat\nlong dog\nlong rain\n")
    for ext in (None, str(tmp_path / "e.txt")):
        _same_items(tds.TextDataset(str(tmp_path / "p.txt"), ext),
                    jds.TextDataset(str(tmp_path / "p.txt"), ext))
    assert tds.TextDataset(str(tmp_path / "p.txt"))[1]["prompts"] == "  a dog"


def test_ode_npz_shards(tmp_path):
    rng = np.random.default_rng(0)
    recs = [{"ode_latent": rng.normal(size=(5, 3, 16, 4, 4)).astype(np.float16),
             "prompts": f"prompt {i}"} for i in range(3)]
    tds.save_ode_shard(str(tmp_path / "shard0.npz"), recs[:2])
    jds.save_ode_shard(str(tmp_path / "shard1.npz"), recs[2:])
    for max_pair in (int(1e8), 2):
        _same_items(tds.ODERegressionNpzDataset(str(tmp_path), max_pair),
                    jds.ODERegressionNpzDataset(str(tmp_path), max_pair))
    got = tds.ODERegressionNpzDataset(str(tmp_path))
    assert np.array_equal(got[2]["ode_latent"], recs[2]["ode_latent"])
    with pytest.raises(FileNotFoundError):
        tds.ODERegressionNpzDataset(str(tmp_path / "missing"))


def test_text_image_pairs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for i, ext in enumerate((".png", ".jpg")):
        Image.fromarray(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8)).save(
            tmp_path / f"im{i}{ext}")
    (tmp_path / "im0.txt").write_text(" a caption \n")
    got = tds.TextImagePairDataset(str(tmp_path))
    _same_items(got, jds.TextImagePairDataset(str(tmp_path)))
    # .jpg files are listed before .png ones
    assert got[1]["image"].shape == (3, 6, 8) and got[1]["prompts"] == "a caption"
    assert got[0]["prompts"] == ""


class _Txn:
    def __init__(self, store):
        self.store = store

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key):
        return self.store.get(key)

    def put(self, key, value):
        self.store[key] = value


class FakeEnv:
    """The part of an lmdb environment the helpers use."""

    def __init__(self):
        self.store = {}

    def begin(self, write=False):
        return _Txn(self.store)


def test_lmdb_rows_round_trip_as_in_jax():
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(3, 2, 4, 4)).astype(np.float16)
    envs = {}
    for name, mod in (("torch", tlm), ("jax", jlm)):
        env = FakeEnv()
        mod.store_arrays_to_lmdb(env, {"latents": lat, "prompts": ["a", "b", "c"]})
        with env.begin(write=True) as txn:
            txn.put(b"latents_shape", str(lat.shape).encode())
        envs[name] = env
    assert envs["torch"].store == envs["jax"].store
    env = envs["torch"]
    assert tlm.get_array_shape_from_lmdb(env, "latents") == lat.shape
    for i in range(3):
        assert np.array_equal(tlm.retrieve_row_from_lmdb(env, "latents", np.float16, i), lat[i])
        assert tlm.retrieve_row_from_lmdb(env, "prompts", str, i) == "abc"[i]


def test_lmdb_dataset_imports_lmdb_when_opened(tmp_path, monkeypatch):
    """Importing the module needs no lmdb; opening an LMDB dataset does."""
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError):
        tds.ShardingLMDBDataset(str(tmp_path))
