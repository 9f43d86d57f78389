"""The i2v DiT: the port's image cross-attention branch against the JAX
package's on the CPU in f32, at tiny dims (dim 64, 2 heads, 2 layers, in_dim
36), the same numpy weights on both sides.

  * `init_wan_params` of an i2v config has JAX's structure (keys and shapes);
  * `compute_crossattn_cache(clip_fea=)` (the text and the image K/V) and the
    train-mode `dit_forward` with the image branch agree at relative
    Frobenius 1e-3, without a mask and under a block-causal dense mask;
  * the image branch moves the output;
  * `quantize_wan_linears` of an i2v tree gives JAX's quanta, `k_img` and
    `v_img` among them (no activation scale on them);
  * `convert_wan_dit` of an i2v state dict is bit-equal to JAX's converter
    carried across, in f32 and bf16;
  * `detect_wan_config` gives i2v-14B with in_dim 36 where JAX's gives
    t2v-14B, and the port's i2v-14B config has in_dim 36 where JAX's has 16
    (the two repaired faults of the JAX reference).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_checkpoint import DTYPES, _t, _wan_state_dict, assert_bit_equal
from test_torch_session import numpy_tree

from realtime_video_tpu.config import WAN_CONFIGS as J_WAN_CONFIGS
from realtime_video_tpu.config import WanModelConfig as JWanConfig
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.rope import RopeTables as JRope
from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu.utils import checkpoint as jckpt
from realtime_video_tpu_torch.config import WAN_CONFIGS, WanModelConfig
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion as TGen
from realtime_video_tpu_torch.models.rope import RopeTables
from realtime_video_tpu_torch.ops import attention as tattn
from realtime_video_tpu_torch.utils import checkpoint as tckpt
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

REL = 1e-3
DIMS = dict(model_type="i2v", dim=64, ffn_dim=128, num_heads=2, num_layers=2, in_dim=36)
CFG, JCFG = WanModelConfig(**DIMS), JWanConfig(**DIMS)
H = W = 8  # latents 8x8: 16 tokens a frame
FRAMES = 3


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


@pytest.fixture(scope="module")
def models():
    """(JAX params, port params, context, clip features, x, t): f32 numpy
    weights in the JAX init's structure, the head random so the flow is not 0."""
    tree, shapes = numpy_tree(lambda k: jdit.init_wan_params(k, JCFG, jnp.float32), 21)
    jp = jax.tree.map(lambda a, s: jnp.asarray(a, s.dtype), tree, shapes)
    tp = wan_params_from_jax(tree)
    rng = np.random.default_rng(22)
    ctx = rng.normal(size=(1, 16, CFG.text_dim)).astype(np.float32)
    clip = rng.normal(size=(1, 257, 1280)).astype(np.float32)
    x = rng.normal(size=(1, FRAMES, 36, H, W)).astype(np.float32)
    t = np.float32([[937.0, 500.0, 120.0]])
    return jp, tp, ctx, clip, x, t


def test_init_structure_matches_jax():
    shapes = jax.eval_shape(lambda k: jdit.init_wan_params(k, JCFG, jnp.float32),
                            jax.random.PRNGKey(0))
    want = {k: v for k, v in _shapes(shapes).items()}
    got = _shapes(tdit.init_wan_params(CFG, torch.Generator().manual_seed(0), "cpu",
                                       torch.float32))
    assert got == want
    assert "/img_emb/fc1/w" in got and "/blocks/cross_attn/k_img/w" in got
    assert got["/patch_embedding/w"] == (36 * 4, 64)


def _jax_cache(jp, ctx, clip):
    return jdit.compute_crossattn_cache(JCFG, jp, jnp.asarray(ctx),
                                        clip_fea=None if clip is None else jnp.asarray(clip))


def test_crossattn_cache_with_clip_matches_jax(models):
    jp, tp, ctx, clip, _, _ = models
    jc = _jax_cache(jp, ctx, clip)
    tc = tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx),
                                      clip_fea=torch.from_numpy(clip))
    assert set(tc) == set(jc) == {"k", "v", "k_img", "v_img"}
    for key in jc:
        assert tuple(tc[key].shape) == jc[key].shape
        assert rel_fro(tc[key].numpy(), jc[key]) < REL, key
    assert tuple(tc["k_img"].shape) == (2, 1, 257, 2, 32)
    # without CLIP features an i2v model caches the text K/V only, as JAX does
    assert set(tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx))) == {"k", "v"}


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "block_mask"])
def test_train_forward_with_image_branch_matches_jax(models, masked):
    jp, tp, ctx, clip, x, t = models
    fsl = H * W // 4
    jmask = jattn.blockwise_causal_mask(FRAMES, fsl, 1) if masked else None
    jflow, _ = jdit.dit_forward(JCFG, jp, jnp.asarray(x), jnp.asarray(t),
                                JRope.create(JCFG.head_dim), _jax_cache(jp, ctx, clip),
                                mode="train", attn_mask=jmask)
    tmask = tattn.blockwise_causal_mask(FRAMES, fsl, 1) if masked else None
    tcache = tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx),
                                          clip_fea=torch.from_numpy(clip))
    tflow, kv = tdit.dit_forward(CFG, tp, torch.from_numpy(x), torch.from_numpy(t),
                                 RopeTables.create(CFG.head_dim), tcache, mode="train",
                                 attn_mask=tmask)
    assert kv is None and tuple(tflow.shape) == (1, FRAMES, 16, H, W)
    assert rel_fro(tflow.numpy(), jflow) < REL


def test_image_branch_moves_the_output(models):
    _, tp, ctx, clip, x, t = models
    cache = tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx),
                                         clip_fea=torch.from_numpy(clip))
    rope = RopeTables.create(CFG.head_dim)
    args = (torch.from_numpy(x), torch.from_numpy(t), rope)
    flow, _ = tdit.dit_forward(CFG, tp, *args, cache, mode="train")
    zeroed = dict(cache, k_img=torch.zeros_like(cache["k_img"]),
                  v_img=torch.zeros_like(cache["v_img"]))
    flow0, _ = tdit.dit_forward(CFG, tp, *args, zeroed, mode="train")
    text_only, _ = tdit.dit_forward(CFG, tp, *args, {"k": cache["k"], "v": cache["v"]},
                                    mode="train")
    assert torch.isfinite(flow).all()
    assert rel_fro(flow0.numpy(), flow.numpy()) > 1e-2
    assert rel_fro(text_only.numpy(), flow.numpy()) > 1e-2


def test_quantized_i2v_tree_matches_jax(models):
    jp, tp, *_ = models
    jq = jax.device_get(jdit.quantize_wan_linears(jp))
    tq = tdit.quantize_wan_linears(tp)
    names = set()
    for group in ("self_attn", "cross_attn", "ffn"):
        for name, jnode in jq["blocks"][group].items():
            if "w_q" not in jnode:
                continue
            tnode = tq["blocks"][group][name]
            names.add(name)
            assert set(tnode) == set(jnode) == {"w_q", "scale", "b"}, (group, name)
            np.testing.assert_array_equal(tnode["w_q"].numpy(), np.asarray(jnode["w_q"]))
            np.testing.assert_allclose(tnode["scale"].numpy(), np.asarray(jnode["scale"]),
                                       rtol=1e-6)
    assert {"k_img", "v_img"} <= names
    assert "w" in tq["img_emb"]["fc1"]  # img_emb stays float, as in JAX
    # the quantised tree's cache and forward run (int8 weights dequantised)
    _, _, ctx, clip, x, t = models
    cache = tdit.compute_crossattn_cache(CFG, tq, torch.from_numpy(ctx),
                                         clip_fea=torch.from_numpy(clip))
    flow, _ = tdit.dit_forward(CFG, tq, torch.from_numpy(x), torch.from_numpy(t),
                               RopeTables.create(CFG.head_dim), cache, mode="train")
    assert torch.isfinite(flow).all()


def _i2v_state_dict(params, cfg):
    """The reference's i2v names: `_wan_state_dict`'s, the cross attention's
    image projections, and img_emb.proj.{0, 1, 3, 4}."""
    sd = _wan_state_dict(params, cfg)
    ca = params["blocks"]["cross_attn"]
    for i in range(cfg.num_layers):
        base = f"blocks.{i}.cross_attn"
        for n in ("k_img", "v_img"):
            sd[f"{base}.{n}.weight"] = _t(np.asarray(ca[n]["w"][i]).T)
            sd[f"{base}.{n}.bias"] = _t(ca[n]["b"][i])
        sd[f"{base}.norm_k_img.weight"] = _t(ca["norm_k_img"]["scale"][i])
    ie = params["img_emb"]
    for idx, norm in ((0, "norm1"), (4, "norm2")):
        sd[f"img_emb.proj.{idx}.weight"] = _t(ie[norm]["scale"])
        sd[f"img_emb.proj.{idx}.bias"] = _t(ie[norm]["bias"])
    for idx, fc in ((1, "fc1"), (3, "fc2")):
        sd[f"img_emb.proj.{idx}.weight"] = _t(np.asarray(ie[fc]["w"]).T)
        sd[f"img_emb.proj.{idx}.bias"] = _t(ie[fc]["b"])
    return sd


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_convert_i2v_checkpoint_matches_jax(models, dtype):
    jp, *_ = models
    jdt, tdt = DTYPES[dtype]
    sd = _i2v_state_dict(jax.device_get(jp), CFG)
    jtree = jdit.fuse_qkv_params(jckpt.convert_wan_dit(sd, JCFG, jdt))
    want = wan_params_from_jax(jax.device_get(jtree))
    got = tckpt.convert_wan_dit(sd, CFG, tdt, "cpu")
    assert_bit_equal(got, want)
    assert "k_img" in got["blocks"]["cross_attn"] and "img_emb" in got


def test_detect_i2v_config(models):
    jp, *_ = models
    sd = _i2v_state_dict(jax.device_get(jp), CFG)
    sd["patch_embedding.weight"] = torch.zeros((5120, 36, 1, 2, 2))
    got = tckpt.detect_wan_config(sd)
    assert got == WAN_CONFIGS["i2v-14B"]
    assert got.model_type == "i2v" and got.in_dim == 36 and got.dim == 5120
    # the JAX reference: its detect gives t2v-14B, its i2v-14B config in_dim 16
    assert jckpt.detect_wan_config(sd) == J_WAN_CONFIGS["t2v-14B"]
    assert J_WAN_CONFIGS["i2v-14B"].in_dim == 16
    assert dataclasses.replace(WAN_CONFIGS["i2v-14B"], in_dim=16) == \
        WanModelConfig(**dataclasses.asdict(J_WAN_CONFIGS["i2v-14B"]))
    # a t2v state dict still detects as t2v
    assert tckpt.detect_wan_config({"blocks.0.self_attn.k.weight": torch.zeros((1536, 1536))}) \
        == WAN_CONFIGS["t2v-1.3B"]


def test_i2v_calibration_draws_in_dim_channels(models):
    """The int8 calibration of an i2v model runs its decode forwards on 36
    channels and its cross attention with the image branch."""
    _, tp, *_ = models
    gen = TGen(cfg=CFG, params=tdit.fuse_qkv_params(tp), device="cpu")
    seen = []
    forward = gen.forward

    def spy(noisy, cross, *a, **k):
        seen.append((noisy.shape[2], "k_img" in cross))
        return forward(noisy, cross, *a, **k)

    gen.forward = spy
    scales = gen.calibrate_act_scales([1000.0, 500.0], lat_h=4, lat_w=4, kv_frames=3)
    assert seen and all(s == (36, True) for s in seen)
    q = tdit.quantize_wan_linears(gen.params, act_scales=scales)
    assert "a_scale" in q["blocks"]["cross_attn"]["o"]
    assert "a_scale" not in q["blocks"]["cross_attn"]["k_img"]
