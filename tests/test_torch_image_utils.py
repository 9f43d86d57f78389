"""The port's image helpers (`utils/image.py`) against the JAX package's on
the cases of tests/test_utils.py: resize-and-crop and resize of float and
uint8 images equal to JAX's, the LoRA merge of a pair into a weight, and
`apply_lora_to_params` on the port's dict-of-tensor trees against JAX's on
numpy trees (the input tree left as it was); the JSON helpers and the
shared bicubic resize."""
import re

import jax
import numpy as np
import pytest
import torch

from realtime_video_tpu.utils import image as jimage
from realtime_video_tpu_torch.utils import image as timage


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_resize_and_crop_match_jax(dtype):
    rng = np.random.default_rng(60)
    img = rng.random((40, 60, 3)).astype(np.float32)
    if dtype == "uint8":
        img = (img * 255).astype(np.uint8)
    for size in ((32, 32), (48, 20)):
        got = timage.resize_and_center_crop(img, *size)
        want = jimage.resize_and_center_crop(img, *size)
        assert got.shape == want.shape == (size[1], size[0], 3) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    got = timage.resize_without_crop(img, 20, 24)
    want = jimage.resize_without_crop(img, 20, 24)
    assert got.shape == (24, 20, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_lora_merge_matches_jax():
    w = np.zeros((4, 4), np.float32)
    down, up = np.ones((4, 2), np.float32), np.ones((2, 4), np.float32)
    got = timage.merge_lora_delta(torch.from_numpy(w), down, up, alpha=0.5)
    np.testing.assert_allclose(got.numpy(), np.full((4, 4), 1.0))
    rng = np.random.default_rng(61)
    w, down, up = (rng.normal(size=s).astype(np.float32) for s in ((6, 5), (6, 3), (3, 5)))
    np.testing.assert_allclose(timage.merge_lora_delta(torch.from_numpy(w), down, up, 0.7)
                               .numpy(), jimage.merge_lora_delta(w, down, up, 0.7),
                               rtol=1e-6, atol=1e-6)


def test_apply_lora_to_params_matches_jax():
    rng = np.random.default_rng(62)
    tree = {"blocks": {"self_attn": {"q": {"w": rng.normal(size=(2, 8, 8)).astype(np.float32),
                                           "b": np.zeros((2, 8), np.float32)}},
                       "ffn": {"fc1": {"w": rng.normal(size=(8, 16)).astype(np.float32)}}},
            "head": {"w": rng.normal(size=(8, 4)).astype(np.float32)}}
    lora = {"blocks/ffn/fc1/w": (rng.normal(size=(8, 2)).astype(np.float32),
                                 rng.normal(size=(2, 16)).astype(np.float32)),
            "head/w": (rng.normal(size=(8, 1)).astype(np.float32),
                       rng.normal(size=(1, 4)).astype(np.float32))}
    want = jimage.apply_lora_to_params(tree, lora, alpha=0.25)
    ttree = jax.tree.map(torch.from_numpy, tree)
    before = jax.tree.map(torch.clone, ttree)
    got = timage.apply_lora_to_params(ttree, lora, alpha=0.25)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_allclose(leaf.numpy(), np.asarray(flat_want[path]), rtol=1e-6,
                                   atol=1e-6, err_msg=str(path))
    for (_, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(ttree),
                              jax.tree_util.tree_leaves_with_path(before)):
        assert torch.equal(a, b)  # the input tree is untouched
    assert got["blocks"]["self_attn"]["q"]["w"] is ttree["blocks"]["self_attn"]["q"]["w"]


def test_json_and_timestamp(tmp_path):
    path = str(tmp_path / "sub" / "a.json")
    timage.write_json(path, {"x": [1, 2]})
    assert timage.read_json(path) == jimage.read_json(path) == {"x": [1, 2]}
    assert re.fullmatch(r"\d{6}_\d{6}_\d{4}", timage.generate_timestamp())


def test_resize_bicubic_is_the_sessions():
    from realtime_video_tpu_torch.serving import session

    assert session.resize_bicubic is timage.resize_bicubic
    frames = torch.rand((2, 3, 20, 30))
    out = timage.resize_bicubic(frames, 10, 16)
    assert out.shape == (2, 3, 10, 16)
