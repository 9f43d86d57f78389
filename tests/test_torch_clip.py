"""The port's CLIP towers (`models/clip.py`) against the JAX package's on the
CPU in f32, at tiny dims, the same numpy weights on both sides (carried
across with `clip_params_from_jax`), at relative Frobenius 1e-4:

  * `vit_forward` with `use_31_block` on (the last block dropped) and off;
  * `xlm_roberta_forward` on ids with pad tokens (their position ids and
    the key mask);
  * `CLIPVisionEncoder` on [B, C, T, H, W] clips in [-1, 1], its bicubic
    resize (down and up) and the CLIP normalisation included.

`convert_clip_vision` on a synthetic `visual.*` state dict must give JAX's
converter's tree, carried across, bit for bit, in f32 and bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import assert_bit_equal
from test_torch_session import numpy_tree

from realtime_video_tpu.models import clip as jclip
from realtime_video_tpu_torch.models import clip as tclip
from realtime_video_tpu_torch.utils.convert import clip_params_from_jax

REL = 1e-4
VIT = dict(image_size=28, patch_size=14, dim=64, mlp_ratio=2, num_heads=2, num_layers=3,
           norm_eps=1e-5)
XLMR = dict(vocab_size=100, max_text_len=24, type_size=1, pad_id=1, dim=32, num_heads=2,
            num_layers=2, post_norm=True, norm_eps=1e-5)


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def vit():
    tree, shapes = numpy_tree(lambda k: jclip.init_vit_params(k, VIT), 31)
    jp = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    return jp, clip_params_from_jax(tree)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_vit_forward_matches_jax(vit, use_31_block):
    jp, tp = vit
    images = np.random.default_rng(32).normal(size=(2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jclip.vit_forward(jp, jnp.asarray(images), VIT, use_31_block))
    got = tclip.vit_forward(tp, torch.from_numpy(images), VIT, use_31_block).numpy()
    assert got.shape == want.shape == (2, 5, 64)  # 4 patches + the class token
    assert rel_fro(got, want) < REL


def test_use_31_block_drops_the_last_block(vit):
    _, tp = vit
    images = torch.from_numpy(np.random.default_rng(33).normal(size=(1, 3, 28, 28))
                              .astype(np.float32))
    two = tclip.vit_forward(tp, images, dict(VIT, num_layers=2), False)
    assert torch.equal(tclip.vit_forward(tp, images, VIT, True), two)


def test_xlm_roberta_forward_with_pads_matches_jax():
    jtree = jax.device_get(jclip.init_xlm_roberta_params(jax.random.PRNGKey(34), XLMR))
    rng = np.random.default_rng(35)
    # every float leaf moved off the init's ones and zeros, the pad id kept
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32) + np.float32(0.1) * rng.normal(
        size=np.shape(a)).astype(np.float32) if np.ndim(a) else a, jtree)
    tree["pad_id"] = XLMR["pad_id"]
    jp = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items() if k != "pad_id"})
    tp = clip_params_from_jax(tree)
    assert tp["pad_id"] == 1
    ids = rng.integers(2, XLMR["vocab_size"], size=(2, 12)).astype(np.int32)
    ids[0, 9:] = XLMR["pad_id"]  # a padded prompt beside a full one
    want = np.asarray(jclip.xlm_roberta_forward(jp, jnp.asarray(ids), XLMR))
    got = tclip.xlm_roberta_forward(tp, torch.from_numpy(ids).long(), XLMR).numpy()
    assert got.shape == want.shape == (2, 12, 32)
    assert rel_fro(got, want) < REL
    # the pad keys are masked out: the padded prompt's real tokens come out
    # as the unpadded prompt's do
    alone = tclip.xlm_roberta_forward(tp, torch.from_numpy(ids[:1, :9]).long(), XLMR).numpy()
    np.testing.assert_allclose(got[:1, :9], alone, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(40, 56), (20, 24)], ids=["down", "up"])
def test_vision_encoder_matches_jax(vit, hw):
    jp, tp = vit
    enc_j = jclip.CLIPVisionEncoder(params=jp)
    enc_j.cfg = VIT  # read when its jitted forward is traced, on the first call
    enc_t = tclip.CLIPVisionEncoder(params=tp, cfg=VIT)
    videos = np.random.default_rng(36).uniform(-1, 1, size=(1, 3, 2, *hw)).astype(np.float32)
    want = np.asarray(enc_j(jnp.asarray(videos)))
    got = enc_t(torch.from_numpy(videos)).numpy()
    assert got.shape == want.shape == (2, 5, 64)
    assert rel_fro(got, want) < REL


def test_vision_encoder_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tclip.CLIPVisionEncoder(cfg=VIT)
    enc = tclip.CLIPVisionEncoder(cfg=VIT, device="cpu")
    assert enc.params["blocks"]["attn"]["qkv"]["w"].shape == (3, 64, 192)
    feats = enc(torch.zeros((1, 3, 1, 28, 28)))
    assert feats.shape == (1, 5, 64) and torch.isfinite(feats).all()


def _visual_state_dict(seed: int, d: int = 64, layers: int = 2, mr: int = 2, tokens: int = 5):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    sd = {"visual.patch_embedding.weight": r(d, 3, 14, 14),
          "visual.cls_embedding": r(1, 1, d), "visual.pos_embedding": r(1, tokens, d),
          "visual.pre_norm.weight": r(d), "visual.pre_norm.bias": r(d)}
    for i in range(layers):
        b = f"visual.transformer.{i}"
        sd.update({f"{b}.norm1.weight": r(d), f"{b}.norm1.bias": r(d),
                   f"{b}.attn.to_qkv.weight": r(3 * d, d), f"{b}.attn.to_qkv.bias": r(3 * d),
                   f"{b}.attn.proj.weight": r(d, d), f"{b}.attn.proj.bias": r(d),
                   f"{b}.norm2.weight": r(d), f"{b}.norm2.bias": r(d),
                   f"{b}.mlp.0.weight": r(mr * d, d), f"{b}.mlp.0.bias": r(mr * d),
                   f"{b}.mlp.2.weight": r(d, mr * d), f"{b}.mlp.2.bias": r(d)})
    sd["textual.token_embedding.weight"] = r(4, d)  # the other tower's keys are ignored
    return sd


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_clip_vision_matches_jax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    sd = _visual_state_dict(37)
    want = clip_params_from_jax(jax.device_get(jclip.convert_clip_vision(sd, jdt)))
    got = tclip.convert_clip_vision(sd, tdt, "cpu")
    assert_bit_equal(got, want)
    assert got["blocks"]["attn"]["qkv"]["w"].shape == (2, 64, 192)
    # the converted tree runs
    images = torch.zeros((1, 3, 28, 28), dtype=tdt)
    assert tclip.vit_forward(got, images, dict(VIT, num_layers=2)).shape == (1, 5, 64)
