"""The port's umT5 encoder against the JAX package's on the CPU at t5-tiny, in
f32: the relative position buckets equal; `t5_encode` and `encode_prompts`
with ids and masks fed directly, the JAX params carried across by
`t5_params_from_jax`, within relative Frobenius error 1e-4 (both sides sum
in f32, in different orders); the whole `WanTextEncoder` (tokenise, encode,
zero the padding) with one tokenizer on both sides; and the random init's
distributions (the port draws its own numbers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import T5_CONFIGS as J_T5_CONFIGS
from realtime_video_tpu.models import t5 as jt5
from realtime_video_tpu.models.text_encoder import WanTextEncoder as JEncoder
from realtime_video_tpu_torch.config import T5_CONFIGS
from realtime_video_tpu_torch.models import t5 as tt5
from realtime_video_tpu_torch.models.text_encoder import WanTextEncoder as TEncoder
from realtime_video_tpu_torch.utils.convert import t5_params_from_jax
from realtime_video_tpu_torch.utils.tokenizer import FallbackTokenizer

CFG, JCFG = T5_CONFIGS["t5-tiny"], J_T5_CONFIGS["t5-tiny"]


def rel_fro(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def params():
    jp = jt5.init_t5_encoder_params(jax.random.PRNGKey(3), JCFG, jnp.float32)
    # unit norms would hide a scale applied to the wrong axis
    rng = np.random.default_rng(0)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a * jnp.asarray(1.0 + 0.2 * rng.normal(size=a.shape), a.dtype)
        if "scale" in str(path[-1]) else a, jp)
    return jp, t5_params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("lq, lk, bidirectional", [(7, 7, True), (40, 40, True),
                                                   (300, 300, True), (5, 200, False)])
def test_relative_position_buckets_equal(lq, lk, bidirectional):
    want = np.asarray(jt5.relative_position_buckets(lq, lk, 32, 128, bidirectional))
    got = tt5.relative_position_buckets(lq, lk, 32, 128, bidirectional).numpy()
    assert np.array_equal(got, want)


def _ids_mask(lengths, seq_len, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, CFG.vocab_size, size=(len(lengths), seq_len)).astype(np.int32)
    mask = (np.arange(seq_len)[None] < np.asarray(lengths)[:, None]).astype(np.int32)
    return ids, mask


@pytest.mark.parametrize("lengths, seq_len", [((24,), 24), ((5, 17), 24), ((1, 40), 64)])
def test_t5_encode_matches_jax(params, lengths, seq_len):
    jp, tp = params
    ids, mask = _ids_mask(lengths, seq_len, seed=seq_len)
    want = np.asarray(jt5.t5_encode(JCFG, jp, jnp.asarray(ids), jnp.asarray(mask)))
    got = tt5.t5_encode(CFG, tp, torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (len(lengths), seq_len, CFG.dim)
    assert rel_fro(got, want) <= 1e-4


def test_t5_encode_without_mask_matches_jax(params):
    jp, tp = params
    ids, _ = _ids_mask((16,), 16, seed=9)
    want = np.asarray(jt5.t5_encode(JCFG, jp, jnp.asarray(ids)))
    got = tt5.t5_encode(CFG, tp, torch.from_numpy(ids).long()).numpy()
    assert rel_fro(got, want) <= 1e-4


def test_encode_prompts_matches_jax_and_zeroes_padding(params):
    jp, tp = params
    ids, mask = _ids_mask((3, 11), 16, seed=4)
    want = np.asarray(jt5.encode_prompts(JCFG, jp, jnp.asarray(ids), jnp.asarray(mask)))
    got = tt5.encode_prompts(CFG, tp, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask)).numpy()
    assert rel_fro(got, want) <= 1e-4
    assert not got[0, 3:].any() and not got[1, 11:].any()
    assert np.abs(got[0, :3]).min() > 0


def test_wan_text_encoder_matches_jax(params):
    """The whole encoder at its 512 tokens, both sides tokenising with the
    port's fallback tokenizer (the JAX one's ids change per process)."""
    jp, tp = params
    tok = FallbackTokenizer(seq_len=CFG.text_len, vocab_size=CFG.vocab_size)
    je = JEncoder(cfg=JCFG, params=jp, tokenizer=tok)
    te = TEncoder(cfg=CFG, params=tp, tokenizer=tok)
    prompts = ["A red fox running through snow, cinematic."]
    want = np.asarray(je(text_prompts=prompts)["prompt_embeds"])
    got = te(text_prompts=prompts)["prompt_embeds"].numpy()
    assert got.shape == want.shape == (1, CFG.text_len, CFG.dim)
    assert rel_fro(got, want) <= 1e-4
    assert not got[0, 8:].any()  # 7 words and the end token


def test_random_init_keeps_the_jax_distributions():
    """Shapes, dtypes and each leaf's spread as JAX's init draws them (std
    within 15%, mean within a tenth of it, at these sizes; norms exactly one)."""
    import dataclasses

    from realtime_video_tpu.config import T5Config as JT5Config

    dims = dict(vocab_size=2048, dim=128, dim_attn=128, dim_ffn=256, num_heads=8,
                num_layers=2)
    cfg = dataclasses.replace(CFG, **dims)
    jp = jax.device_get(jt5.init_t5_encoder_params(jax.random.PRNGKey(0), JT5Config(**dims),
                                                   jnp.bfloat16))
    tp = tt5.init_t5_encoder_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                    torch.bfloat16)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert len(jl) == len(tl)
    for path, a in jl:
        b = tl[path]
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype), path
        a64, b64 = np.asarray(a, np.float64), b.double().numpy()
        if "scale" in str(path[-1]):
            assert (a64 == 1).all() and (b64 == 1).all(), path
        else:
            assert 0.85 < b64.std() / a64.std() < 1.15, path
            assert abs(b64.mean()) < 0.1 * a64.std(), path
