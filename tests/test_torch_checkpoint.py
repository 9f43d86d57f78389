"""The port's checkpoint converters against the JAX package's on synthetic
state dicts in the reference's layout (tests/test_checkpoint.py builds them
the same way): `convert_wan_dit` (q/k/v split or fused as `to_qkv`, with and
without the "model." prefix), `convert_t5_encoder` and `convert_vae` must give
trees equal bit for bit to the JAX converters' output carried across
(`utils/convert.py`), in f32 and in bf16; `detect_wan_config` and
`strip_prefix` must agree with JAX's. Also: the file loaders (.pt, and
.safetensors only with its package), and the server's loaders reading
`checkpoint_path` and picking the text encoder from the environment."""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_session import numpy_tree

from realtime_video_tpu.config import T5_CONFIGS as J_T5_CONFIGS
from realtime_video_tpu.config import VAEConfig as JVAEConfig
from realtime_video_tpu.config import WanModelConfig as JWanConfig
from realtime_video_tpu.models import t5 as jt5
from realtime_video_tpu.models import vae as jvae
from realtime_video_tpu.models import wan_dit as jdit
from realtime_video_tpu.utils import checkpoint as jckpt
from realtime_video_tpu_torch.config import T5_CONFIGS, VAEConfig, WanModelConfig
from realtime_video_tpu_torch.models import wan_dit as tdit
from realtime_video_tpu_torch.serving import models as serving_models
from realtime_video_tpu_torch.utils import checkpoint as tckpt
from realtime_video_tpu_torch.utils.convert import (
    t5_params_from_jax,
    vae_params_from_jax,
    wan_params_from_jax,
)

CFG, JCFG = (WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2),
             JWanConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2))
VAEC = dict(dim=8, z_dim=16, dim_mult=(1, 1, 2, 2), num_res_blocks=1)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x, np.float32)))


def _wan_state_dict(params, cfg, fused_qkv=False):
    """Emit reference-named tensors (causal_model.py module tree)."""
    sd = {}
    pe_w = np.asarray(params["patch_embedding"]["w"], np.float32)  # [C*4, D]
    pt, ph, pw = cfg.patch_size
    sd["patch_embedding.weight"] = _t(
        pe_w.T.reshape(cfg.dim, cfg.in_dim, pt, ph, pw)
    )
    sd["patch_embedding.bias"] = _t(params["patch_embedding"]["b"])
    for tgt, src in (("text_embedding.0", "fc1"), ("text_embedding.2", "fc2")):
        sd[f"{tgt}.weight"] = _t(np.asarray(params["text_embedding"][src]["w"]).T)
        sd[f"{tgt}.bias"] = _t(params["text_embedding"][src]["b"])
    for tgt, src in (("time_embedding.0", "fc1"), ("time_embedding.2", "fc2")):
        sd[f"{tgt}.weight"] = _t(np.asarray(params["time_embedding"][src]["w"]).T)
        sd[f"{tgt}.bias"] = _t(params["time_embedding"][src]["b"])
    sd["time_projection.1.weight"] = _t(np.asarray(params["time_projection"]["fc"]["w"]).T)
    sd["time_projection.1.bias"] = _t(params["time_projection"]["fc"]["b"])
    bp = params["blocks"]
    for i in range(cfg.num_layers):
        for attn in ("self_attn", "cross_attn"):
            a = bp[attn]
            if fused_qkv and attn == "self_attn":
                w = np.concatenate(
                    [np.asarray(a[n]["w"][i]).T for n in ("q", "k", "v")], axis=0
                )
                b = np.concatenate([np.asarray(a[n]["b"][i]) for n in ("q", "k", "v")])
                sd[f"blocks.{i}.{attn}.to_qkv.weight"] = _t(w)
                sd[f"blocks.{i}.{attn}.to_qkv.bias"] = _t(b)
            else:
                for n in ("q", "k", "v"):
                    sd[f"blocks.{i}.{attn}.{n}.weight"] = _t(np.asarray(a[n]["w"][i]).T)
                    sd[f"blocks.{i}.{attn}.{n}.bias"] = _t(a[n]["b"][i])
            sd[f"blocks.{i}.{attn}.o.weight"] = _t(np.asarray(a["o"]["w"][i]).T)
            sd[f"blocks.{i}.{attn}.o.bias"] = _t(a["o"]["b"][i])
            sd[f"blocks.{i}.{attn}.norm_q.weight"] = _t(a["norm_q"]["scale"][i])
            sd[f"blocks.{i}.{attn}.norm_k.weight"] = _t(a["norm_k"]["scale"][i])
        sd[f"blocks.{i}.ffn.0.weight"] = _t(np.asarray(bp["ffn"]["fc1"]["w"][i]).T)
        sd[f"blocks.{i}.ffn.0.bias"] = _t(bp["ffn"]["fc1"]["b"][i])
        sd[f"blocks.{i}.ffn.2.weight"] = _t(np.asarray(bp["ffn"]["fc2"]["w"][i]).T)
        sd[f"blocks.{i}.ffn.2.bias"] = _t(bp["ffn"]["fc2"]["b"][i])
        sd[f"blocks.{i}.modulation"] = _t(bp["modulation"][i])
        sd[f"blocks.{i}.norm3.weight"] = _t(bp["norm3"]["scale"][i])
        sd[f"blocks.{i}.norm3.bias"] = _t(bp["norm3"]["bias"][i])
    sd["head.head.weight"] = _t(np.asarray(params["head"]["head"]["w"]).T)
    sd["head.head.bias"] = _t(params["head"]["head"]["b"])
    sd["head.modulation"] = _t(params["head"]["modulation"])
    return sd


def _t5_state_dict(params, cfg):
    sd = {"token_embedding.weight": _t(params["token_embedding"]),
          "norm.weight": _t(params["norm"]["scale"])}
    bp = params["blocks"]
    for i in range(cfg.num_layers):
        sd[f"blocks.{i}.norm1.weight"] = _t(bp["norm1"]["scale"][i])
        sd[f"blocks.{i}.norm2.weight"] = _t(bp["norm2"]["scale"][i])
        for n in ("q", "k", "v", "o"):
            sd[f"blocks.{i}.attn.{n}.weight"] = _t(np.asarray(bp["attn"][n]["w"][i]).T)
        sd[f"blocks.{i}.ffn.gate.0.weight"] = _t(np.asarray(bp["ffn"]["gate"]["w"][i]).T)
        sd[f"blocks.{i}.ffn.fc1.weight"] = _t(np.asarray(bp["ffn"]["fc1"]["w"][i]).T)
        sd[f"blocks.{i}.ffn.fc2.weight"] = _t(np.asarray(bp["ffn"]["fc2"]["w"][i]).T)
        sd[f"blocks.{i}.pos_embedding.embedding.weight"] = _t(bp["rel_emb"][i])
    return sd


def _vae_state_dict(params, cfg):
    """Emit the Wan 2.1 VAE's reference names (wan/modules/vae.py module tree)
    from a tree in the JAX layout: the inverse of `convert_vae`."""
    sd = {}

    def conv3(name, p):  # [kt, kh, kw, in, out] -> [out, in, kt, kh, kw]
        sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(4, 3, 0, 1, 2))
        sd[f"{name}.bias"] = _t(p["b"])

    def conv2(name, p):  # [kh, kw, in, out] -> [out, in, kh, kw]
        sd[f"{name}.weight"] = _t(np.asarray(p["w"]).transpose(3, 2, 0, 1))
        sd[f"{name}.bias"] = _t(p["b"])

    def gamma(name, p, trailing=3):
        sd[name] = _t(np.asarray(p["gamma"]).reshape(-1, *(1,) * trailing))

    def res(base, p):
        gamma(f"{base}.residual.0.gamma", p["norm1"])
        conv3(f"{base}.residual.2", p["conv1"])
        gamma(f"{base}.residual.3.gamma", p["norm2"])
        conv3(f"{base}.residual.6", p["conv2"])
        if "shortcut" in p:
            conv3(f"{base}.shortcut", p["shortcut"])

    def attn(base, p):
        gamma(f"{base}.norm.gamma", p["norm"], trailing=2)
        for name in ("to_qkv", "proj"):
            sd[f"{base}.{name}.weight"] = _t(np.asarray(p[name]["w"]).T[:, :, None, None])
            sd[f"{base}.{name}.bias"] = _t(p[name]["b"])

    def stage(prefix, plan, ps):
        for i, (spec, p) in enumerate(zip(plan, ps)):
            if spec[0] == "res":
                res(f"{prefix}.{i}", p)
            else:
                conv2(f"{prefix}.{i}.resample.1", p["conv"])
                if "time_conv" in p:
                    conv3(f"{prefix}.{i}.time_conv", p["time_conv"])

    enc, dec = params["encoder"], params["decoder"]
    conv3("encoder.conv1", enc["conv1"])
    stage("encoder.downsamples", jvae._encoder_plan(cfg)[1], enc["downsamples"])
    res("encoder.middle.0", enc["middle_res1"])
    attn("encoder.middle.1", enc["middle_attn"])
    res("encoder.middle.2", enc["middle_res2"])
    gamma("encoder.head.0.gamma", enc["head_norm"])
    conv3("encoder.head.2", enc["head_conv"])
    conv3("decoder.conv1", dec["conv1"])
    res("decoder.middle.0", dec["middle_res1"])
    attn("decoder.middle.1", dec["middle_attn"])
    res("decoder.middle.2", dec["middle_res2"])
    stage("decoder.upsamples", jvae._decoder_plan(cfg)[1], dec["upsamples"])
    gamma("decoder.head.0.gamma", dec["head_norm"])
    conv3("decoder.head.2", dec["head_conv"])
    conv3("conv1", params["conv1"])
    conv3("conv2", params["conv2"])
    return sd


def assert_bit_equal(got, want, path="") -> None:
    """Same keys, and every leaf the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), (path, got.keys())
        for k in want:
            assert_bit_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype,
                                                                     want.dtype)
        bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[want.element_size()]
        assert torch.equal(got.contiguous().view(bits), want.contiguous().view(bits)), path


@pytest.fixture(scope="module")
def dit_np():
    tree, _ = numpy_tree(lambda k: jdit.init_wan_params(k, JCFG, jnp.float32), 21)
    return tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused, prefix", [(False, ""), (True, ""), (False, "model.")])
def test_convert_wan_dit_equals_the_jax_converter(dit_np, fused, prefix, dtype):
    jdt, tdt = DTYPES[dtype]
    sd = {f"{prefix}{k}": v for k, v in _wan_state_dict(dit_np, JCFG, fused).items()}
    want = tdit.fuse_qkv_params(wan_params_from_jax(
        jax.device_get(jckpt.convert_wan_dit(jckpt.strip_prefix(sd), JCFG, jdt))))
    got = tckpt.convert_wan_dit(sd, CFG, tdt)
    assert_bit_equal(got, want)
    assert got["time_embedding"]["fc1"]["w"].dtype == torch.float32
    assert got["blocks"]["self_attn"]["qkv"]["w"].shape == (2, 64, 192)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_t5_encoder_equals_the_jax_converter(dtype):
    jdt, tdt = DTYPES[dtype]
    cfg = J_T5_CONFIGS["t5-tiny"]
    params, _ = numpy_tree(lambda k: jt5.init_t5_encoder_params(k, cfg, jnp.float32), 22)
    sd = _t5_state_dict(params, cfg)
    want = t5_params_from_jax(jax.device_get(jckpt.convert_t5_encoder(sd, cfg, jdt)))
    got = tckpt.convert_t5_encoder(sd, T5_CONFIGS["t5-tiny"], tdt)
    assert_bit_equal(got, want)
    assert got["blocks"]["rel_emb"].dtype == torch.float32


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convert_vae_equals_the_jax_converter(dtype):
    jdt, tdt = DTYPES[dtype]
    jcfg = JVAEConfig(**VAEC)
    params, _ = numpy_tree(lambda k: jvae.init_vae_params(k, jcfg, jnp.float32), 23)
    sd = _vae_state_dict(params, jcfg)
    want = vae_params_from_jax(jax.device_get(jckpt.convert_vae(sd, jcfg, jdt)))
    got = tckpt.convert_vae(sd, VAEConfig(**VAEC), tdt)
    assert_bit_equal(got, want)
    # and the converter inverts the emitter: the tree round-trips
    assert_bit_equal(got, vae_params_from_jax(params, dtype=tdt))


@pytest.mark.parametrize("dim", [1536, 5120, None])
def test_detect_wan_config_names_the_jax_config(dim):
    sd = {} if dim is None else {"blocks.0.self_attn.k.weight": torch.zeros(dim, 4)}
    want, got = jckpt.detect_wan_config(sd), tckpt.detect_wan_config(sd)
    assert (got.dim, got.num_layers, got.num_heads, got.ffn_dim) == \
        (want.dim, want.num_layers, want.num_heads, want.ffn_dim)


@pytest.mark.parametrize("keys", [["model.a", "model.b"], ["model.a", "b"], ["a", "b"]])
def test_strip_prefix_equals_the_jax_one(keys):
    sd = {k: i for i, k in enumerate(keys)}
    assert tckpt.strip_prefix(sd) == jckpt.strip_prefix(sd)


def test_state_dict_files_load(tmp_path, monkeypatch):
    """.pt needs only torch; .safetensors uses the safetensors package, and
    without it says so."""
    import sys

    sd = {"a.weight": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)}
    torch.save(sd, tmp_path / "w.pt")
    assert torch.equal(tckpt.load_torch_state_dict(str(tmp_path / "w.pt"))["a.weight"],
                       sd["a.weight"])
    safetensors_torch = pytest.importorskip("safetensors.torch")
    safetensors_torch.save_file(sd, str(tmp_path / "w.safetensors"))
    assert torch.equal(tckpt.load_torch_state_dict(str(tmp_path / "w.safetensors"))["a.weight"],
                       sd["a.weight"])
    monkeypatch.setitem(sys.modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors package"):
        tckpt.load_torch_state_dict(str(tmp_path / "w.safetensors"))


def test_server_loads_an_existing_checkpoint_path(dit_np, tmp_path, monkeypatch, caplog):
    """`checkpoint_path` is loaded when the file exists (the model detected
    from it; the two real sizes only, so the tiny one is named here), and a
    missing one random-initialises `model_name` with a warning."""
    from realtime_video_tpu_torch.config import load_server_config

    sd = {f"model.{k}": v.to(torch.bfloat16) for k, v in _wan_state_dict(dit_np, JCFG).items()}
    path = tmp_path / "dit.pt"
    torch.save(sd, path)
    monkeypatch.setattr(tckpt, "detect_wan_config", lambda sd: CFG)
    config = load_server_config(model_name="t2v-tiny", checkpoint_path=str(path))
    got = serving_models.load_transformer(config, "cpu")
    assert_bit_equal(got.params, tckpt.convert_wan_dit(sd, CFG, torch.bfloat16))
    with caplog.at_level(logging.WARNING):
        config = load_server_config(model_name="t2v-tiny",
                                    checkpoint_path=str(tmp_path / "absent.pt"))
        fresh = serving_models.load_transformer(config, "cpu")
    assert "missing" in caplog.text and fresh.cfg.dim == 64
    assert not torch.equal(fresh.params["blocks"]["ffn"]["fc1"]["w"],
                           got.params["blocks"]["ffn"]["fc1"]["w"])


def test_text_encoder_loads_a_t5_checkpoint(tmp_path):
    from realtime_video_tpu_torch.models.text_encoder import WanTextEncoder

    cfg = J_T5_CONFIGS["t5-tiny"]
    params, _ = numpy_tree(lambda k: jt5.init_t5_encoder_params(k, cfg, jnp.float32), 24)
    sd = _t5_state_dict(params, cfg)
    torch.save(sd, tmp_path / "t5.pt")
    enc = WanTextEncoder(cfg=T5_CONFIGS["t5-tiny"], checkpoint_path=str(tmp_path / "t5.pt"),
                         device="cpu", tokenizer_path=str(tmp_path / "no-tokenizer"))
    assert_bit_equal(enc.params, tckpt.convert_t5_encoder(sd, T5_CONFIGS["t5-tiny"]))
    emb = enc(text_prompts=["a cat"])["prompt_embeds"]
    assert emb.shape == (1, cfg.text_len, cfg.dim) and not emb[0, 3:].any()


@pytest.mark.parametrize("env, kind", [({"USE_STATIC_ENCODER_COND_DICT": "1"}, "static"),
                                       ({"RTV_T5_TINY": "1"}, "t5-tiny"), ({}, "umt5-xxl")])
def test_load_text_encoder_follows_the_environment(monkeypatch, env, kind):
    """The JAX loader's switches; without them umT5-xxl from the model folder
    (its 5.7 B-parameter random init is not built here: the call is recorded)."""
    from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder, WanTextEncoder

    for name in ("USE_STATIC_ENCODER_COND_DICT", "RTV_T5_TINY"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    calls = []
    monkeypatch.setattr(WanTextEncoder, "from_model_folder",
                        classmethod(lambda cls, **kw: calls.append(kw) or "umt5-xxl"))
    enc = serving_models.load_text_encoder({}, torch.device("cpu"), seed=2, text_len=16,
                                           text_dim=8)
    if kind == "static":
        assert isinstance(enc, StaticTextEncoder)
        assert enc(text_prompts=["x"])["prompt_embeds"].shape == (1, 16, 8)
    elif kind == "t5-tiny":
        assert isinstance(enc, WanTextEncoder) and enc.cfg.dim == 32
    else:
        assert enc == "umt5-xxl" and calls == [{"device": torch.device("cpu"), "seed": 2}]
