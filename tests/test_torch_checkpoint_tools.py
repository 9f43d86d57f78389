"""The port's checkpoint tooling, harnesses and serving configs against the
JAX package's, on the CPU at tiny configs:

  * `scripts/synthesize_checkpoint`: the port's synth_dit / synth_t5 /
    synth_vae equal the JAX script's bit for bit (both draw from a
    module-level generator in call order, reseeded before each comparison),
    the port's converters on them give the JAX converters' trees (through
    `utils/convert`), and `--verify` passes and fails on a leaf of another
    shape;
  * `scripts/run_real_checkpoint` exits 0 naming the missing files, and its
    `find_dit_checkpoint` skips the umT5 and CLIP files;
  * `sweep_sample.load_ckpt` swaps the transformer's params (and its layer
    views) from a safetensors file, and refuses a checkpoint of another width;
  * the two serving YAMLs parse to the JAX package's dicts but `mesh_shape`,
    which is {} in the port, and `load_all` refuses a mesh of more than one
    device.
"""
import importlib.util
import pathlib

import jax
import pytest
import torch
import yaml
from safetensors.torch import save_file

from realtime_video_tpu.config import T5_CONFIGS as JT5
from realtime_video_tpu.config import VAE_CONFIGS as JVAE
from realtime_video_tpu.config import WAN_CONFIGS as JWAN
from realtime_video_tpu.utils import checkpoint as jckpt
from realtime_video_tpu_torch import config as tconfig
from realtime_video_tpu_torch import sweep_sample
from realtime_video_tpu_torch.config import T5_CONFIGS, VAE_CONFIGS, WAN_CONFIGS, WanModelConfig
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.scripts import run_real_checkpoint as rrc
from realtime_video_tpu_torch.scripts import synthesize_checkpoint as tsyn
from realtime_video_tpu_torch.serving import models as serving_models
from realtime_video_tpu_torch.utils import checkpoint as tckpt
from realtime_video_tpu_torch.utils import convert

REPO = pathlib.Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_synthesize_checkpoint", REPO / "scripts" / "synthesize_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JSYN = _jax_script()
# (name, port synth and config, JAX synth and config)
SYNTH = {
    "dit": (tsyn.synth_dit, WAN_CONFIGS["t2v-tiny"], JSYN.synth_dit, JWAN["t2v-tiny"]),
    "t5": (tsyn.synth_t5, T5_CONFIGS["t5-tiny"], JSYN.synth_t5, JT5["t5-tiny"]),
    "vae": (tsyn.synth_vae, VAE_CONFIGS["vae-tiny"], JSYN.synth_vae, JVAE["vae-tiny"]),
}


def _both(name, seed=0):
    """(port state dict, JAX script's state dict), each generator reseeded."""
    tfn, tcfg, jfn, jcfg = SYNTH[name]
    tsyn.GEN.manual_seed(seed)
    JSYN.GEN.manual_seed(seed)
    return tfn(tcfg), jfn(jcfg)


@pytest.mark.parametrize("name", list(SYNTH))
def test_synth_equals_jax_script(name):
    got, want = _both(name)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _leaves(tree):
    return tsyn.tree_leaves(tree)


@pytest.mark.parametrize("name", list(SYNTH))
def test_converters_match_jax(name):
    """The port's converter against the JAX converter on the same state dict
    (the DiT with q/k/v fused on both sides: the port's converter fuses)."""
    sd, _ = _both(name, seed=3)
    _, tcfg, _, jcfg = SYNTH[name]
    if name == "dit":
        got = tckpt.convert_wan_dit(sd, tcfg)
        from realtime_video_tpu.models.wan_dit import fuse_qkv_params

        want = convert.wan_params_from_jax(
            jax.device_get(fuse_qkv_params(jckpt.convert_wan_dit(sd, jcfg))))
    elif name == "t5":
        got = tckpt.convert_t5_encoder(sd, tcfg)
        want = convert.t5_params_from_jax(jax.device_get(jckpt.convert_t5_encoder(sd, jcfg)))
    else:
        got = tckpt.convert_vae(sd, tcfg)
        want = convert.vae_params_from_jax(jax.device_get(jckpt.convert_vae(sd, jcfg)))
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and torch.equal(g[k], w[k]), k


def test_verify_passes(capsys):
    assert tsyn.main(["--verify"]) == 0
    assert capsys.readouterr().out.count("round-trip OK") == 3


@pytest.mark.parametrize("tree,key", [("t5", "token_embedding.weight"), ("vae", "conv1.weight")])
def test_verify_catches_a_wrong_shape(tree, key, capsys):
    """A state dict one row short in a leaf converts, and `verify` names the
    leaf and fails."""
    cfgs = WAN_CONFIGS["t2v-tiny"], T5_CONFIGS["t5-tiny"], VAE_CONFIGS["vae-tiny"]
    sds = dict(zip(("dit", "t5", "vae"), (tsyn.synth_dit(cfgs[0]), tsyn.synth_t5(cfgs[1]),
                                          tsyn.synth_vae(cfgs[2]))))
    sds[tree][key] = sds[tree][key][:-1]
    assert not tsyn.verify(*sds.values(), *cfgs)
    out = capsys.readouterr().out
    assert f"[{tree}] MISMATCH" in out and out.count("round-trip OK") == 2


def test_run_real_checkpoint_skips_without_weights(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tconfig, "MODEL_FOLDER", str(tmp_path))
    assert rrc.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "SKIPPED" in out
    assert "<no DiT safetensors under MODEL_FOLDER>" in out
    assert str(tmp_path / "Wan2.1-T2V-1.3B" / "Wan2.1_VAE.pth") in out
    assert str(tmp_path / "Wan2.1-T2V-1.3B" / "models_t5_umt5-xxl-enc-bf16.safetensors") in out


def test_find_dit_checkpoint_skips_text_and_image_encoders(tmp_path):
    sub = tmp_path / "Wan2.1-T2V-1.3B"
    sub.mkdir()
    for p in (sub / "models_t5_umt5-xxl-enc-bf16.safetensors",
              tmp_path / "open-CLIP-xlm-roberta.safetensors"):
        p.write_bytes(b"")
    assert rrc.find_dit_checkpoint(str(tmp_path)) is None
    (sub / "dit.safetensors").write_bytes(b"")
    assert rrc.find_dit_checkpoint(str(tmp_path)) == str(sub / "dit.safetensors")
    top = tmp_path / "wan_synth_t2v_1.3b.safetensors"
    top.write_bytes(b"")
    assert rrc.find_dit_checkpoint(str(tmp_path)) == str(top)


class _Models:
    def __init__(self, transformer):
        self.transformer = transformer


def test_sweep_load_ckpt_swaps_params_and_refuses_another_width(tmp_path, monkeypatch):
    cfg = WAN_CONFIGS["t2v-tiny"]
    tsyn.GEN.manual_seed(1)
    path = tmp_path / "tiny.safetensors"
    save_file(tsyn.synth_dit(cfg), str(path))
    # the reference's detect tells 1.3B from 14B only; this file is tiny
    monkeypatch.setattr(tckpt, "detect_wan_config", lambda sd: cfg)
    models = _Models(WanDiffusion(cfg=cfg, device="cpu", dtype=torch.float32, seed=0))
    sweep_sample.load_ckpt(models, str(path))
    tr = models.transformer
    want = tckpt.convert_wan_dit(tckpt.load_torch_state_dict(str(path)), cfg, torch.float32)
    assert torch.equal(tr.params["blocks"]["ffn"]["fc1"]["w"], want["blocks"]["ffn"]["fc1"]["w"])
    assert torch.equal(tr.layers[1]["ffn"]["fc1"]["w"], want["blocks"]["ffn"]["fc1"]["w"][1])
    assert tr.params["blocks"]["ffn"]["fc1"]["w"].dtype == torch.float32
    narrow = WanModelConfig(dim=32, ffn_dim=64, num_heads=2, num_layers=2)
    other = _Models(WanDiffusion(cfg=narrow, device="cpu", dtype=torch.float32, seed=0))
    with pytest.raises(ValueError, match="dim mismatch"):
        sweep_sample.load_ckpt(other, str(path))


@pytest.mark.parametrize("name", ["self_forcing_server.yaml", "self_forcing_server_14b.yaml"])
def test_serving_yamls_match_jax(name):
    port = yaml.safe_load((REPO / "realtime_video_tpu_torch" / "configs" / name).read_text())
    jax_cfg = yaml.safe_load((REPO / "realtime_video_tpu" / "configs" / name).read_text())
    assert port.pop("mesh_shape") == {}
    jax_cfg.pop("mesh_shape")
    assert port == jax_cfg
    merged = tconfig.load_server_config(REPO / "realtime_video_tpu_torch" / "configs" / name)
    serving_models.check_mesh_shape(merged)


def test_load_all_refuses_a_multi_device_mesh():
    jax_14b = REPO / "realtime_video_tpu" / "configs" / "self_forcing_server_14b.yaml"
    for config in (tconfig.load_server_config(jax_14b),
                   tconfig.load_server_config(mesh_shape={"tp": 2})):
        with pytest.raises(ValueError, match="the server runs on one card"):
            serving_models.load_all(config, "cpu")
    serving_models.check_mesh_shape(tconfig.load_server_config(mesh_shape={"dp": 1, "tp": 1}))
