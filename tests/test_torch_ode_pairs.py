"""The port's ODE-pair data path on the CPU:

  * `generate_ode_pairs.ode_trajectory` against the JAX script's loop
    (scripts/generate_ode_pairs.py:75-92) rebuilt from JAX package functions
    (a non-causal tiny f32 teacher with a random head, its UniPC solver at
    4 steps, the conditional train-mode forward under an all-true mask), on
    the same weights, text K/V and injected noise: every step within
    relative Frobenius 1e-4, in f32 before the float16 cast;
  * the tiny script end to end (`--tiny --device cpu`, the static text
    embedding): its npz shard read by both packages' ODERegressionNpzDataset,
    the same arrays and prompts, float16 [steps + 1, 1, F, 16, 4, 4];
  * `create_shards` against the JAX scripts/create_shards.py on the same
    dumps: the same shard files holding the same arrays bit for bit;
  * `create_shards --lmdb` raises ImportError when `lmdb` cannot be
    imported.
"""
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.solvers import FlowUniPCMultistep as JUniPC
from realtime_video_tpu.utils.dataset import ODERegressionNpzDataset as JDataset
from realtime_video_tpu_torch.scripts import create_shards, generate_ode_pairs
from realtime_video_tpu_torch.solvers import FlowUniPCMultistep as TUniPC
from realtime_video_tpu_torch.utils.dataset import ODERegressionNpzDataset as TDataset
from test_torch_training import _noise, nets, rel_fro, t_  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_trajectory_matches_the_jax_loop(nets):  # noqa: F811
    jnets, tnets, jcross, tcross = nets
    jgen, tgen = jnets[1], tnets[1]  # the non-causal real score, random head
    assert not jgen.is_causal
    noise = _noise(21, (1, 3, 16, 4, 4))
    steps = 4
    # the JAX script's loop
    js = JUniPC(shift=5.0)
    js.set_timesteps(steps)
    fsl = jgen.cfg.frame_seq_length(4, 4)
    full_mask = jnp.ones((3 * fsl,) * 2, bool)
    fwd = jax.jit(lambda p, cr, x, t: jgen.forward(p, x, cr, t, mode="train",
                                                   attn_mask=full_mask)[0])
    latent, want = noise, [np.asarray(noise)]
    for t_val in js.timesteps:
        t = jnp.full((1, 3), float(t_val), jnp.float32)
        latent = js.step(fwd(jgen.params, jcross[0], latent, t), float(t_val), latent)
        want.append(np.asarray(latent))
    # the port's
    ts = TUniPC(shift=5.0)
    ts.set_timesteps(steps)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    got = generate_ode_pairs.ode_trajectory(tgen, tcross[0], t_(noise), ts)
    assert len(got) == len(want) == steps + 1
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and rel_fro(g.numpy(), w) < 1e-4, i
    assert rel_fro(got[-1].numpy(), want[0]) > 1e-2  # the trajectory moves


def test_tiny_script_shard_reads_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("USE_STATIC_ENCODER_COND_DICT", "1")
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat surfing\na red fox\na dog\n")
    out = tmp_path / "ode"
    written = generate_ode_pairs.main([
        "--prompts", str(prompts), "--out", str(out), "--steps", "2", "--num-frames", "3",
        "--shard-size", "2", "--tiny", "--device", "cpu"])
    assert [pathlib.Path(p).name for p in written] == ["shard_0_0000.npz", "shard_0_0001.npz"]
    tds, jds = TDataset(str(out)), JDataset(str(out))
    assert len(tds) == len(jds) == 3
    for i in range(3):
        t, j = tds[i], jds[i]
        assert t["prompts"] == j["prompts"] == prompts.read_text().splitlines()[i]
        assert t["ode_latent"].dtype == j["ode_latent"].dtype == np.float16
        assert t["ode_latent"].shape == (3, 1, 3, 16, 4, 4)
        np.testing.assert_array_equal(t["ode_latent"], j["ode_latent"])
    # the first step is prompt i's seeded noise
    np.testing.assert_array_equal(
        tds[1]["ode_latent"][0],
        torch.randn((1, 3, 16, 4, 4), generator=torch.Generator().manual_seed(1))
        .numpy().astype(np.float16))


def _jax_create_shards():
    spec = importlib.util.spec_from_file_location("jax_create_shards",
                                                  REPO / "scripts" / "create_shards.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_create_shards_matches_the_jax_script(tmp_path, monkeypatch):
    src = tmp_path / "dumps"
    src.mkdir()
    rng = np.random.default_rng(0)

    def lat():
        return rng.normal(size=(3, 1, 3, 16, 4, 4)).astype(np.float16)

    np.savez(src / "a.npz", ode_latent=lat(), prompts=np.asarray("one"))
    np.savez(src / "b.npz", num_items=np.asarray(2), ode_latent_0=lat(),
             prompts_0=np.asarray("two"), ode_latent_1=lat(), prompts_1=np.asarray("three"))
    np.savez(src / "c.npz", ode_latent=lat(), prompts=np.asarray("four"))
    assert create_shards.main(["--src", str(src), "--out", str(tmp_path / "port"),
                               "--shard-size", "3"]) == 2
    monkeypatch.setattr(sys, "argv", ["create_shards.py", "--src", str(src), "--out",
                                      str(tmp_path / "jax"), "--shard-size", "3"])
    _jax_create_shards().main()
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        ["shard_0000.npz", "shard_0001.npz"]
    for name in names:
        with np.load(tmp_path / "port" / name) as got, np.load(tmp_path / "jax" / name) as want:
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                a, b = got[key], want[key]
                assert a.dtype == b.dtype and a.shape == b.shape, key
                assert a.tobytes() == b.tobytes(), key
    # the count it returns is the shards written (the JAX script prints one
    # more when the records fill the last shard exactly)
    assert create_shards.main(["--src", str(src), "--out", str(tmp_path / "whole"),
                               "--shard-size", "4"]) == 1
    assert [p.name for p in (tmp_path / "whole").iterdir()] == ["shard_0000.npz"]


def test_create_shards_lmdb_needs_lmdb(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)  # `import lmdb` raises ImportError
    with pytest.raises(ImportError, match="lmdb"):
        create_shards.main(["--src", str(tmp_path), "--out", str(tmp_path / "out"), "--lmdb"])
