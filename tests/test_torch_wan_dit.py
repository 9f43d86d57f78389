"""The port's DiT against the JAX DiT at tiny dims on the CPU, in f32:
cross-attention cache, KV cache after context_prefill, decode and prefill
forwards, rolling eviction. Same parameters (converted from the JAX tree),
same numpy inputs. Tolerance: rtol 2e-3 (the reference-parity bar of
docs/PARITY.md) with atol 1e-4 for values near zero."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import WAN_CONFIGS
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.rope import RopeTables as JRope
from realtime_video_tpu.ops import kv_cache as jkvc
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.rope import RopeTables as TRope
from realtime_video_tpu_torch.ops import kv_cache as tkvc
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

CFG = WAN_CONFIGS["t2v-tiny"]
RTOL, ATOL = 2e-3, 1e-4
LAT = 8  # latent H = W -> 16 tokens per frame
FSL = CFG.frame_seq_length(LAT, LAT)


def jax_params(seed=0):
    p = jdit.init_wan_params(jax.random.PRNGKey(seed), CFG, jnp.float32)
    # the head is zero-initialised; give it weights so the flow is not 0
    rng = np.random.default_rng(seed)
    p["head"]["head"]["w"] = jnp.asarray(
        rng.normal(0, 0.05, p["head"]["head"]["w"].shape), jnp.float32)
    return jdit.fuse_qkv_params(p)


@pytest.fixture(scope="module")
def models():
    jp = jax_params()
    tp = wan_params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(1)
    ctx = rng.normal(size=(1, 16, CFG.text_dim)).astype(np.float32)
    jcross = jdit.compute_crossattn_cache(CFG, jp, jnp.asarray(ctx))
    tcross = tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx))
    return jp, tp, jcross, tcross


def close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def kv_pair(cache_frames):
    j = jkvc.init_kv_cache(CFG.num_layers, 1, cache_frames * FSL, CFG.num_heads,
                           CFG.head_dim, jnp.float32)
    t = tkvc.init_kv_cache(CFG.num_layers, 1, cache_frames * FSL, CFG.num_heads,
                           CFG.head_dim, torch.float32)
    return j, t


def latents(seed, frames):
    return np.random.default_rng(seed).normal(
        size=(1, frames, CFG.in_dim, LAT, LAT)).astype(np.float32)


def test_crossattn_cache_matches(models):
    _, _, jcross, tcross = models
    close(tcross["k"], jcross["k"])
    close(tcross["v"], jcross["v"])


def test_context_prefill_kv_and_decode_match(models):
    """The serving block step: reset, prefill 3 clean frames, decode a noisy
    block at current_start = 3 frames over a 6-frame window."""
    jp, tp, jcross, tcross = models
    jkv, tkv = kv_pair(6)
    ctx = latents(2, 3)
    jkv = jdit.context_prefill(CFG, jp, jnp.asarray(ctx), JRope.create(CFG.head_dim),
                               jcross, jkv, block_tokens=3 * FSL,
                               max_attention_size=6 * FSL)
    tkv = tdit.context_prefill(CFG, tp, torch.from_numpy(ctx), TRope.create(CFG.head_dim),
                               tcross, tkv, block_tokens=3 * FSL)
    close(tkv["k"], jkv["k"])
    close(tkv["v"], jkv["v"])
    assert tkv["global_end"] == int(jkv["global_end"]) == 3 * FSL
    assert tkv["local_end"] == int(jkv["local_end"]) == 3 * FSL

    x = latents(3, 3)
    t = np.full((1, 3), 937.5, np.float32)
    jflow, jkv = jdit.dit_forward(CFG, jp, jnp.asarray(x), jnp.asarray(t),
                                  JRope.create(CFG.head_dim), jcross, mode="decode",
                                  kv_cache=jkv, current_start=3 * FSL,
                                  max_attention_size=6 * FSL)
    tflow, tkv = tdit.dit_forward(CFG, tp, torch.from_numpy(x), torch.from_numpy(t),
                                  TRope.create(CFG.head_dim), tcross, mode="decode",
                                  kv_cache=tkv, current_start=3 * FSL,
                                  max_attention_size=6 * FSL)
    assert float(np.abs(np.asarray(jflow)).max()) > 1e-2
    close(tflow, jflow)
    close(tkv["k"], jkv["k"])
    close(tkv["v"], jkv["v"])
    assert tkv["local_end"] == int(jkv["local_end"]) == 6 * FSL


def test_prefill_mode_partial_block_matches(models):
    """Prefill over 4 frames with 3-frame blocks: block-causal with a partial
    trailing block."""
    jp, tp, jcross, tcross = models
    jkv, tkv = kv_pair(6)
    x = latents(4, 4)
    t = np.zeros((1, 4), np.float32)
    jflow, jkv = jdit.dit_forward(CFG, jp, jnp.asarray(x), jnp.asarray(t),
                                  JRope.create(CFG.head_dim), jcross, mode="prefill",
                                  kv_cache=jkv, prefill_block_tokens=3 * FSL)
    tflow, tkv = tdit.dit_forward(CFG, tp, torch.from_numpy(x), torch.from_numpy(t),
                                  TRope.create(CFG.head_dim), tcross, mode="prefill",
                                  kv_cache=tkv, prefill_block_tokens=3 * FSL)
    close(tflow, jflow)
    close(tkv["k"], jkv["k"])
    assert tkv["global_end"] == int(jkv["global_end"]) == 4 * FSL


def test_rolling_eviction_matches(models):
    """A decode write past a full cache shifts the non-sink region left."""
    jp, tp, jcross, tcross = models
    jkv, tkv = kv_pair(6)
    rope_j, rope_t = JRope.create(CFG.head_dim), TRope.create(CFG.head_dim)
    for start, seed in ((0, 5), (3 * FSL, 6), (6 * FSL, 7)):
        x = latents(seed, 3)
        t = np.full((1, 3), 500.0, np.float32)
        jflow, jkv = jdit.dit_forward(CFG, jp, jnp.asarray(x), jnp.asarray(t), rope_j,
                                      jcross, mode="decode", kv_cache=jkv,
                                      current_start=start, max_attention_size=6 * FSL,
                                      rolling=True, sink_tokens=FSL)
        tflow, tkv = tdit.dit_forward(CFG, tp, torch.from_numpy(x), torch.from_numpy(t),
                                      rope_t, tcross, mode="decode", kv_cache=tkv,
                                      current_start=start, max_attention_size=6 * FSL,
                                      rolling=True, sink_tokens=FSL)
        close(tflow, jflow)
        close(tkv["k"], jkv["k"])
        assert tkv["local_end"] == int(jkv["local_end"])
        assert tkv["global_end"] == int(jkv["global_end"])


@pytest.mark.parametrize("shift,sink", [(0, 0), (5, 0), (7, 3), (40, 2)])
def test_shift_layer_cache_matches(shift, sink):
    buf = np.random.default_rng(shift).normal(size=(1, 32, 2, 4)).astype(np.float32)
    j = jkvc.shift_layer_cache(jnp.asarray(buf), jnp.asarray(shift, jnp.int32), sink)
    t = tkvc.shift_layer_cache(torch.from_numpy(buf), shift, sink)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_patchify_unpatchify_roundtrip_matches(models):
    jp, tp, _, _ = models
    x = latents(8, 2)
    close(tdit.patchify(CFG, tp, torch.from_numpy(x)), jdit.patchify(CFG, jp, jnp.asarray(x)))
    y = np.random.default_rng(9).normal(size=(1, 2 * FSL, 64)).astype(np.float32)
    np.testing.assert_array_equal(
        tdit.unpatchify(CFG, torch.from_numpy(y), (2, LAT // 2, LAT // 2)).numpy(),
        np.asarray(jdit.unpatchify(CFG, jnp.asarray(y), (2, LAT // 2, LAT // 2))))
