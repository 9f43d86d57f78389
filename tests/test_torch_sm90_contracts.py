"""What surrounds the wgmma kernels, held on the CPU (the kernels themselves run
only on a card: tests/test_torch_kernels_cuda.py, test_torch_int8_kernels_cuda.py).

  * the logit-bound pre-pass's plain twin against the JAX package's
    `_logit_bound(_prescale(q, scale), k)` (rtol 1e-6), and the prescale
    factor the kernel takes against `prescale`'s rounding;
  * the fused int8 linear's K-major weights: `quantize_wan_linears` and
    `wan_params_from_jax` hand out [K, N] views of [N, K] storage (strides
    (1, K), K * N bytes a layer) with the JAX quanta, the plain version gives
    the same output on either layout, and the wrapper's layout check refuses
    an N-contiguous w_q;
  * the build keys a library on the headers its source includes, the port's
    sources are the four wgmma libraries, the attention backward's among
    them (the mma.sync ones are gone), and ptxas's report of registers and
    spills is read from the build's log;
  * the block profiler's buckets for the new kernels' names (the conv with
    its quantise pre-pass in one bucket, the VAE convs, the backward's
    three kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_video_tpu.config import WAN_CONFIGS
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.ops import pallas_attention as pat
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.ops import cuda_build
from realtime_video_tpu_torch.ops import hopper_attention as hk
from realtime_video_tpu_torch.ops import hopper_conv as hc
from realtime_video_tpu_torch.ops import hopper_int8_mm as hm
from realtime_video_tpu_torch.tools import profile_block as pb
from realtime_video_tpu_torch.utils.convert import wan_params_from_jax

CFG = WAN_CONFIGS["t2v-tiny"]


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("lq, lk, n, d, scale", [
    (8, 24, 2, 64, 1.0), (16, 40, 3, 128, 4.0), (5, 7, 1, 32, 0.25)])
def test_logit_bound_plain_matches_jax(lq, lk, n, d, scale):
    q = rand(lq, (1, lq, n, d), scale).astype(jnp.bfloat16)
    k = rand(lk, (1, lk, n, d), scale).astype(jnp.bfloat16)
    want = pat._logit_bound(pat._prescale(jnp.asarray(q), d ** -0.5), jnp.asarray(k))
    tq = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16)
    tk = torch.from_numpy(k.astype(np.float32)).to(torch.bfloat16)
    got = hk.logit_bound_plain(tq, tk, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # the CPU entry of the pre-pass is its plain twin
    torch.testing.assert_close(hk.logit_bound_maxima(tq, tk, d ** -0.5),
                               hk.logit_bound_maxima_plain(tq, tk, d ** -0.5), rtol=0, atol=0)
    torch.testing.assert_close(got, hk.logit_bound(hk.prescale(tq, d ** -0.5), tk),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [128 ** -0.5, 64 ** -0.5, 1.0 / hk.LOG2E, 0.3])
def test_qscale_is_prescales_factor(scale):
    """The kernel forms bf16(q * c) from c = qscale(scale): one rounding of
    an exact f32 product, bit-equal to prescale and to the JAX _prescale."""
    q = rand(3, (1, 33, 2, 128), 3.0)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    c = hk.qscale(scale)
    folded = (tq.float() * c).to(torch.bfloat16)
    assert torch.equal(folded.view(torch.int16), hk.prescale(tq, scale).view(torch.int16))
    jq = np.asarray(pat._prescale(jnp.asarray(tq.float().numpy()).astype(jnp.bfloat16), scale))
    np.testing.assert_array_equal(folded.float().numpy(), jq.astype(np.float32))


@pytest.fixture(scope="module")
def quantized():
    jp = jdit.init_wan_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    jq = jax.device_get(jdit.quantize_wan_linears(jp))
    tq = tdit.quantize_wan_linears(wan_params_from_jax(jax.device_get(jp)))
    return jq, tq


def _linears(tree):
    for group in ("self_attn", "cross_attn", "ffn"):
        for name, node in tree["blocks"][group].items():
            if isinstance(node, dict) and "w_q" in node:
                yield (group, name), node


@pytest.mark.parametrize("source", ["quantize_wan_linears", "wan_params_from_jax"])
def test_int8_weights_are_k_major_views_of_the_jax_quanta(quantized, source):
    jq, tq = quantized
    tree = tq if source == "quantize_wan_linears" else wan_params_from_jax(jq)
    jnodes = dict(_linears(jq))
    assert set(dict(_linears(tree))) == set(jnodes) and jnodes
    for site, node in _linears(tree):
        w = node["w_q"]
        nl, k, n = w.shape
        assert w.dtype == torch.int8
        assert w.stride() == (k * n, 1, k), (site, w.stride())
        assert w.untyped_storage().nbytes() == nl * k * n, site  # stored once
        for i in range(nl):
            assert w[i].stride() == (1, k)
            hm.check_weight_layout(w[i])
        np.testing.assert_array_equal(w.numpy(), np.asarray(jnodes[site]["w_q"]), str(site))


@pytest.mark.parametrize("m, k, n, bias", [(5, 32, 48, True), (17, 64, 16, False)])
def test_int8_linear_plain_same_on_either_layout(m, k, n, bias):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-127, 128, size=(k, n)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(1e-3, 2e-3, size=n).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(torch.bfloat16) if bias \
        else None
    a = torch.tensor([2.5 / 127.0])
    wk = hm.k_major(w)
    assert wk.stride() == (1, k) and torch.equal(wk, w)
    want = hm.int8_linear_plain(x, w, ws, a, b)
    got = hm.int8_linear(x, wk, ws, a, b)  # a CPU tensor takes the plain version
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_weight_layout_check_refuses_n_contiguous():
    w = torch.zeros((64, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="strides"):
        hm.check_weight_layout(w)  # N contiguous: the JAX layout as stored by numpy
    with pytest.raises(ValueError, match=r"\[K, N\]"):
        hm.check_weight_layout(torch.zeros((2, 64, 32), dtype=torch.int8))
    hm.check_weight_layout(hm.k_major(w))
    with pytest.raises(ValueError, match="strides"):
        hm.check_weight_layout(hm.k_major(torch.zeros((128, 32), dtype=torch.int8))[:64])


def test_library_path_follows_included_headers(tmp_path):
    header = tmp_path / "helpers.cuh"
    nested = tmp_path / "nested.cuh"
    src = tmp_path / "kernel.cu"
    nested.write_text("#define DEPTH 1\n")
    header.write_text('#pragma once\n#include "nested.cuh"\n')
    src.write_text('#include <cuda_runtime.h>\n#include "helpers.cuh"\nint x;\n')
    first = cuda_build.library_path(src)
    assert cuda_build.local_headers(src) == [header.resolve(), nested.resolve()]
    assert cuda_build.library_path(src) == first
    nested.write_text("#define DEPTH 2\n")
    second = cuda_build.library_path(src)
    assert second != first
    header.write_text('#pragma once\n#include "nested.cuh"\n// changed\n')
    assert cuda_build.library_path(src) not in (first, second)
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libkernel_")


def test_port_sources_hash_the_shared_header():
    for src in (hk.SM90_SOURCE, hk.BWD_SOURCE, hm.SOURCE, hc.SOURCE):
        assert cuda_build.CSRC / "sm90.cuh" in cuda_build.local_headers(src)
    for src in (hm.SOURCE, hc.SOURCE):  # the int8 pre-passes share one quantiser
        assert cuda_build.CSRC / "quantize.cuh" in cuda_build.local_headers(src)
    assert cuda_build.local_headers(cuda_build.CSRC / "quantize.cuh") == []
    # the two attention kernels take the shared header and the mask header
    # (teacher forcing's ranges), nothing else; the mask header includes none
    for src in hk.SOURCES:
        assert sorted(cuda_build.local_headers(src)) == sorted(
            [cuda_build.CSRC / "sm90.cuh", cuda_build.CSRC / "attention_mask.cuh"])
    assert cuda_build.local_headers(cuda_build.CSRC / "attention_mask.cuh") == []
    assert sorted(p.name for p in cuda_build.CSRC.glob("*.cu")) == [
        "attention_bwd_sm90.cu", "attention_sm90.cu", "conv_sm90.cu", "int8_mm.cu"]


@pytest.mark.parametrize("name, want", [
    ("(anonymous namespace)::attention_kernel_sm90(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, __nv_bfloat16*, int)", "attention_kernel"),
    ("(anonymous namespace)::attn_logit_bound_kernel(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, long long, long long, float, unsigned int*)",
     "attention_bound_prepass"),
    ("(anonymous namespace)::int8_linear_kernel_sm90(CUtensorMap_st, CUtensorMap_st, "
     "float const*)", "int8_linear_kernel"),
    ("(anonymous namespace)::int8_linear_kernel_quantize_x(__nv_bfloat16 const*, "
     "signed char*, float const*, long long)", "int8_linear_kernel"),
    ("void (anonymous namespace)::attention_kernel_sm90<true>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int)", "attention_kernel"),
    ("(anonymous namespace)::attn_int8_quantize_rows(__nv_bfloat16 const*, float const*, "
     "signed char*, float*, int, int, int, int, int, float, int)", "attention_int8_prepass"),
    ("void (anonymous namespace)::conv_kernel_sm90<true, 96>(CUtensorMap_st, CUtensorMap_st, "
     "(anonymous namespace)::Geo, float const*)", "conv3x3_kernel"),
    ("(anonymous namespace)::conv_quantize_kernel(__nv_bfloat16 const*, signed char*, "
     "float const*, long long, int, int)", "conv3x3_kernel"),
    ("(anonymous namespace)::attn_bwd_prepass(__nv_bfloat16 const*, __nv_bfloat16 const*, "
     "__nv_bfloat16 const*, float const*, float, float*, __nv_bfloat16*, int, int, int, int, "
     "int)", "attention_backward_kernel"),
    ("(anonymous namespace)::attn_bwd_dq_sm90(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, (anonymous namespace)::Params)", "attention_backward_kernel"),
    ("(anonymous namespace)::attn_bwd_dkdv_sm90(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
     "attention_backward_kernel"),
    ("void (anonymous namespace)::attention_kernel_sm90<false, true>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, int)", "attention_kernel"),
    ("void (anonymous namespace)::attn_bwd_dkdv_sm90<true>(CUtensorMap_st, CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, (anonymous namespace)::Params)",
     "attention_backward_kernel"),
])
def test_profile_buckets_the_new_kernels(name, want):
    assert pb.category(name) == want
    assert want in pb.CATEGORIES


def test_ptxas_usage_reads_registers_and_spills():
    report = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attn_bwd_dq_sm90E' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116attn_bwd_dq_sm90E\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 896 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116attn_bwd_prepassE' "
        "for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116attn_bwd_prepassE\n"
        "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers, 424 bytes cmem[0]\n")
    assert cuda_build.ptxas_usage(report) == {
        "_ZN12_GLOBAL__N_116attn_bwd_dq_sm90E": {
            "registers": 168, "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0},
        "_ZN12_GLOBAL__N_116attn_bwd_prepassE": {
            "registers": 40, "stack_bytes": 8, "spill_store_bytes": 12, "spill_load_bytes": 4}}
    assert "-Xptxas=-v" in cuda_build.NVCC_FLAGS
    lib = cuda_build.BUILD_DIR / "libx_0123.so"
    assert cuda_build.log_path(lib) == cuda_build.BUILD_DIR / "libx_0123.log"
