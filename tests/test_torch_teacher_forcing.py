"""Teacher forcing in the port against the JAX package on the CPU, in f32:
the [clean | noisy] mask, the kernel mask's dense form, and
`dit_forward(tf_concat=True)` at tests/test_teacher_forcing.py's config
(dim 64, 2 layers, 6 frames of 16 tokens, blocks of 3 frames) on the same
numpy params, in the structure form (`block_tokens`: the route the card runs
through the kernel's mode 2, here its plain version) and the dense `attn_mask`
form, within relative Frobenius 1e-3 of JAX's; one gradient against
`jax.grad`, in the structure form, whose CPU backward is
`attention_backward_plain` under the mode-2 `Mask`; and JAX's two
causality assertions on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import WanModelConfig as JCfg
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.models.rope import RopeTables as JRope
from realtime_video_tpu.ops import attention as jattn
from realtime_video_tpu_torch.config import WanModelConfig
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.models.rope import RopeTables as TRope
from realtime_video_tpu_torch.ops import attention as tattn
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

DIMS = dict(dim=64, ffn_dim=128, num_heads=2, num_layers=2)
JCFG, CFG = JCfg(**DIMS), WanModelConfig(**DIMS)
F, C, H, W = 6, 16, 8, 8
FSL = 16
NFPB = 3
BLOCK = FSL * NFPB
REL = 1e-3


def rel_fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (frames, frame_seqlen, frames per block): the test config, blocks of 80 and
# 300 tokens (not multiples of 128), one-frame blocks, and a last block that
# is cut short (L not a multiple of the block)
MASK_CASES = [(6, 16, 3), (4, 40, 2), (3, 100, 3), (6, 60, 1), (5, 16, 2)]


@pytest.mark.parametrize("frames,fsl,nfpb", MASK_CASES)
def test_mask_matches_jax(frames, fsl, nfpb):
    got = tattn.teacher_forcing_mask(frames, fsl, nfpb).numpy()
    want = np.asarray(jattn.teacher_forcing_mask(frames, fsl, nfpb))
    assert got.shape == want.shape == (2 * frames * fsl,) * 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frames,fsl,nfpb", [c for c in MASK_CASES if c[0] % c[2] == 0])
def test_kernel_mask_dense_form(frames, fsl, nfpb):
    """Mask.teacher_forcing's dense form is the mask; its live pairs are
    `teacher_forcing_pairs`."""
    L, B = frames * fsl, fsl * nfpb
    mask = hk.Mask.teacher_forcing(L, B)
    assert mask.key == "teacher_forcing"
    assert mask.kernel_args() == (2, 0, 2 * L, B, L, -1)
    dense = mask.dense(2 * L, 2 * L, "cpu")
    assert torch.equal(dense, tattn.teacher_forcing_mask(frames, fsl, nfpb))
    assert int(dense.sum()) == hk.teacher_forcing_pairs(L, B)


def test_kernel_mask_refuses_a_cut_block():
    with pytest.raises(ValueError, match="multiple"):
        hk.Mask.teacher_forcing(80, 32)


def test_route_backward_matches_dense_autograd():
    """The route's CPU autograd (KernelAttention: the plain forward and
    `attention_backward_plain` under the mode-2 Mask) against autograd
    through the dense masked softmax."""
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 2 * 96, 2, 32)).astype(np.float32))
                   for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = tattn.teacher_forcing_attention(*leaves, 96, 48)
    grads = torch.autograd.grad(out, leaves, do)
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = tattn.plain_attention(*ref_leaves, mask=tattn.teacher_forcing_mask(6, 16, 3))
    ref_grads = torch.autograd.grad(ref, ref_leaves, do)
    assert rel_fro(out.detach(), ref.detach()) < 1e-6
    for g, r in zip(grads, ref_grads):
        assert rel_fro(g, r) < 1e-5


@pytest.fixture(scope="module")
def models():
    """JAX's test params (the head random, so the flow is not zero) on both
    sides, the text K/V, the RoPE tables and the clean / noisy inputs."""
    jp = jdit.init_wan_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    rng = np.random.default_rng(9)
    jp["head"]["head"]["w"] = jnp.asarray(
        rng.normal(0, 0.05, jp["head"]["head"]["w"].shape).astype(np.float32))
    tp = wan_params_from_jax(jax.device_get(jp))
    ctx = rng.normal(size=(1, 16, CFG.text_dim)).astype(np.float32)
    jcross = jdit.compute_crossattn_cache(JCFG, jp, jnp.asarray(ctx))
    tcross = tdit.compute_crossattn_cache(CFG, tp, torch.from_numpy(ctx))
    clean = rng.normal(size=(1, F, C, H, W)).astype(np.float32)
    noisy = rng.normal(size=(1, F, C, H, W)).astype(np.float32)
    t_cat = np.concatenate([np.zeros((1, F)), np.full((1, F), 700.0)], 1).astype(np.float32)
    return dict(jp=jp, tp=tp, jcross=jcross, tcross=tcross, jrope=JRope.create(JCFG.head_dim),
                trope=TRope.create(CFG.head_dim), clean=clean, noisy=noisy, t=t_cat)


def jax_flow(m, clean):
    x = jnp.asarray(np.concatenate([clean, m["noisy"]], 1))
    flow, _ = jdit.dit_forward(JCFG, m["jp"], x, jnp.asarray(m["t"]), m["jrope"], m["jcross"],
                               mode="train", attn_mask=jattn.teacher_forcing_mask(F, FSL, NFPB),
                               tf_concat=True)
    return np.asarray(flow)


def port_flow(m, clean, form="structure", params=None, x=None):
    if x is None:
        x = torch.from_numpy(np.concatenate([clean, m["noisy"]], 1))
    kw = (dict(block_tokens=BLOCK) if form == "structure"
          else dict(attn_mask=tattn.teacher_forcing_mask(F, FSL, NFPB)))
    flow, _ = tdit.dit_forward(CFG, m["tp"] if params is None else params, x,
                               torch.from_numpy(m["t"]), m["trope"], m["tcross"], mode="train",
                               tf_concat=True, **kw)
    return flow


@pytest.mark.parametrize("form", ["structure", "dense"])
def test_tf_forward_matches_jax(models, form):
    got = port_flow(models, models["clean"], form)
    want = jax_flow(models, models["clean"])
    assert tuple(got.shape) == want.shape == (1, F, C, H, W)
    assert np.isfinite(want).all()
    assert rel_fro(got, want) < REL


def test_tf_grad_matches_jax(models):
    """d(sum(flow * w)) / d(x, a self-attention weight, an ffn weight) in the
    structure form, against jax.grad of JAX's dense-mask forward."""
    m = models
    w = np.random.default_rng(5).normal(size=(1, F, C, H, W)).astype(np.float32)
    x0 = np.concatenate([m["clean"], m["noisy"]], 1)
    mask = jattn.teacher_forcing_mask(F, FSL, NFPB)

    def jloss(x, q_w, fc1_w):
        p = {**m["jp"], "blocks": {**m["jp"]["blocks"],
                                   "self_attn": {**m["jp"]["blocks"]["self_attn"],
                                                 "q": {**m["jp"]["blocks"]["self_attn"]["q"],
                                                       "w": q_w}},
                                   "ffn": {**m["jp"]["blocks"]["ffn"],
                                           "fc1": {**m["jp"]["blocks"]["ffn"]["fc1"],
                                                   "w": fc1_w}}}}
        flow, _ = jdit.dit_forward(JCFG, p, x, jnp.asarray(m["t"]), m["jrope"], m["jcross"],
                                   mode="train", attn_mask=mask, tf_concat=True)
        return jnp.sum(flow * w)

    jb = m["jp"]["blocks"]
    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(x0), jb["self_attn"]["q"]["w"], jb["ffn"]["fc1"]["w"])

    tb = m["tp"]["blocks"]
    x = torch.from_numpy(x0).requires_grad_()
    q_w = tb["self_attn"]["q"]["w"].clone().requires_grad_()
    fc1_w = tb["ffn"]["fc1"]["w"].clone().requires_grad_()
    params = {**m["tp"], "blocks": {**tb,
                                    "self_attn": {**tb["self_attn"],
                                                  "q": {**tb["self_attn"]["q"], "w": q_w}},
                                    "ffn": {**tb["ffn"], "fc1": {**tb["ffn"]["fc1"],
                                                                 "w": fc1_w}}}}
    flow = port_flow(m, None, "structure", params=params, x=x)
    got = torch.autograd.grad((flow * torch.from_numpy(w)).sum(), (x, q_w, fc1_w))
    for g, j in zip(got, want):
        assert np.isfinite(np.asarray(j)).all() and float(np.abs(np.asarray(j)).max()) > 0
        assert rel_fro(g, j) < REL


def test_tf_causality(models):
    """JAX's two assertions on the port: block 0's noisy flow does not move
    when the later clean frames change; the later blocks' flow moves when
    block 0's clean frames do."""
    m = models
    rng = np.random.default_rng(6)
    flow = port_flow(m, m["clean"]).numpy()
    clean2 = m["clean"].copy()
    clean2[:, NFPB:] = rng.normal(size=clean2[:, NFPB:].shape)
    np.testing.assert_allclose(flow[:, :NFPB], port_flow(m, clean2).numpy()[:, :NFPB],
                               rtol=1e-4, atol=1e-4)
    clean3 = m["clean"].copy()
    clean3[:, :NFPB] = rng.normal(size=clean3[:, :NFPB].shape)
    assert not np.allclose(flow[:, NFPB:], port_flow(m, clean3).numpy()[:, NFPB:])


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_tf_concat_is_train_mode_only(models, mode):
    x = torch.zeros((1, 2 * F, C, H, W))
    with pytest.raises(ValueError, match="tf_concat"):
        tdit.dit_forward(CFG, models["tp"], x, torch.zeros((1, 2 * F)), models["trope"],
                         models["tcross"], mode=mode, kv_cache={}, max_attention_size=1,
                         prefill_block_tokens=BLOCK, tf_concat=True)
