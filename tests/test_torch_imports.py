"""The PyTorch port imports no JAX: a fresh interpreter imports the package,
its serving stack, TAEHV, the quantised-tree cache, the offline sampler, the
solvers, the teacher pipelines, `WanT2V` and `WanI2V`, the CLIP towers, the
image and prompt-extension utilities, the training stack (`train`,
`training/` with GAN, the self-forcing rollout, the datasets), the ODE-pair
scripts (`scripts/`) and every other module of it, and neither `jax` nor
the JAX package enters sys.modules. Also holds
that the port's kernel wrappers take a CUDA tensor only to their kernels (on
a CPU-only host they must raise, not fall back), and that its entry points
(TAEHV's init and `sample_videos` among them) build on the card unless
asked for the CPU."""
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "realtime_video_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def test_port_imports_no_jax():
    mods = _modules()
    assert {"realtime_video_tpu_torch.serving.server", "realtime_video_tpu_torch.models.taehv",
            "realtime_video_tpu_torch.utils.qcache", "realtime_video_tpu_torch.sample",
            "realtime_video_tpu_torch.pipelines.causal_inference",
            "realtime_video_tpu_torch.solvers", "realtime_video_tpu_torch.generators",
            "realtime_video_tpu_torch.pipelines.causal_diffusion_inference",
            "realtime_video_tpu_torch.pipelines.bidirectional_diffusion_inference",
            "realtime_video_tpu_torch.pipelines.bidirectional_inference",
            "realtime_video_tpu_torch.models.clip", "realtime_video_tpu_torch.utils.image",
            "realtime_video_tpu_torch.utils.prompt_extend",
            "realtime_video_tpu_torch.utils.qwen_vl",
            "realtime_video_tpu_torch.train", "realtime_video_tpu_torch.training.losses",
            "realtime_video_tpu_torch.training.distillation",
            "realtime_video_tpu_torch.training.base", "realtime_video_tpu_torch.training.ema",
            "realtime_video_tpu_torch.training.train_step",
            "realtime_video_tpu_torch.training.draws",
            "realtime_video_tpu_torch.pipelines.self_forcing_training",
            "realtime_video_tpu_torch.utils.dataset",
            "realtime_video_tpu_torch.utils.lmdb_io",
            "realtime_video_tpu_torch.training.gan", "realtime_video_tpu_torch.scripts",
            "realtime_video_tpu_torch.scripts.generate_ode_pairs",
            "realtime_video_tpu_torch.scripts.create_shards",
            "realtime_video_tpu_torch.scripts.synthesize_checkpoint",
            "realtime_video_tpu_torch.scripts.run_real_checkpoint",
            "realtime_video_tpu_torch.sweep_sample", "realtime_video_tpu_torch.examples",
            "realtime_video_tpu_torch.examples.generate",
            "realtime_video_tpu_torch.examples.sample_example"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'realtime_video_tpu' or m.startswith('realtime_video_tpu.'))\n"
            "print('BAD', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_kernel_wrapper_never_falls_back_for_cuda_tensors(monkeypatch):
    """With a (fake) CUDA tensor the wrapper must go to the kernel; when the
    kernel cannot be built it raises instead of running the plain version."""
    from realtime_video_tpu_torch.ops import hopper_attention as hk

    monkeypatch.setattr(hk, "_lib", None)
    monkeypatch.setattr(hk, "build", lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    monkeypatch.setattr(hk, "_check", lambda *a: None)
    hk.reset_launch_counts()
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.window_attention(q, q, q, 0, 4)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.block_causal_attention(q, q, q, 2)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.teacher_forcing_attention(q, q, q, 2, 1)
    # the gradient path too: its forward and its backward kernel
    qg = q.float().requires_grad_().to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.window_attention(qg, q, q, 0, 4)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.teacher_forcing_attention(qg, q, q, 2, 1)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hk.attention_backward(q, q, q, q, q, torch.zeros(1, 2, 4), 0.1, hk.Mask.window(0, 4))
    assert hk.PLAIN_ON_CUDA == {"window": 0, "block_causal": 0, "teacher_forcing": 0}


def test_entry_points_default_to_the_card(monkeypatch):
    """WanDiffusion and VAEWrapper with device=None build on the CUDA card; on
    a host without one they raise instead of building on the CPU."""
    from realtime_video_tpu_torch.config import VAEConfig, WanModelConfig
    from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
    from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WanDiffusion(cfg=WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VAEWrapper(VAEConfig(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1))
    vae = VAEWrapper(VAEConfig(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1),
                     device="cpu")
    assert vae.params["conv2"]["w"].device.type == "cpu"
    from realtime_video_tpu_torch import sample
    from realtime_video_tpu_torch.models import taehv

    with pytest.raises(RuntimeError, match="no CUDA device"):
        taehv.init_taehv_params(torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample.sample_videos(["a cat"], save_videos=False)
    assert taehv.init_taehv_params(torch.Generator(), "cpu")["decoder"][1]["w"].device.type == \
        "cpu"


def test_ode_pairs_script_defaults_to_the_card(monkeypatch, tmp_path):
    """generate_ode_pairs builds its teacher on the CUDA card unless --device
    names another: without a card it raises before it writes anything."""
    from realtime_video_tpu_torch.scripts import generate_ode_pairs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("a cat\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_ode_pairs.main(["--prompts", str(prompts), "--out", str(tmp_path / "out"),
                                 "--tiny"])
    assert not (tmp_path / "out").exists()


def test_checkpoint_tools_default_to_the_card(monkeypatch, tmp_path):
    """run_real_checkpoint, sweep_sample and the two examples load their
    models on the CUDA card unless --device names another: without a card
    they raise before they load anything."""
    from realtime_video_tpu_torch import config, sweep_sample
    from realtime_video_tpu_torch.examples import generate, sample_example
    from realtime_video_tpu_torch.scripts import run_real_checkpoint

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = tmp_path / "Wan2.1-T2V-1.3B"
    base.mkdir()
    for p in (tmp_path / "dit.safetensors", base / "Wan2.1_VAE.pth",
              base / "models_t5_umt5-xxl-enc-bf16.safetensors"):
        p.write_bytes(b"")
    monkeypatch.setattr(config, "MODEL_FOLDER", str(tmp_path))
    for run in (lambda: run_real_checkpoint.main([]),
                lambda: sweep_sample.main([str(tmp_path / "dit.safetensors")]),
                lambda: generate.main(["--out", str(tmp_path / "g.mp4")]),
                lambda: sample_example.main(["--video", str(tmp_path / "in.mp4")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()


def test_int8_kernel_wrappers_never_fall_back_for_cuda_tensors(monkeypatch):
    """The fused int8 linear and the conv take a (fake) CUDA tensor only to
    their kernels: when a kernel cannot be built the call raises, and no plain
    version runs in its place."""
    from realtime_video_tpu_torch.ops import hopper_conv as hc
    from realtime_video_tpu_torch.ops import hopper_int8_mm as hm

    for mod in (hm, hc):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "build",
                            lambda: (_ for _ in ()).throw(RuntimeError("no nvcc")))
        monkeypatch.setattr(mod, "_check", lambda *a: None)
        mod.reset_launch_counts()
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    x = torch.zeros((4, 16), dtype=torch.bfloat16)
    w_q = torch.zeros((16, 8), dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no nvcc"):
        hm.int8_linear(x, w_q, torch.ones(8), torch.ones(1))
    with pytest.raises(RuntimeError, match="no nvcc"):
        hc.conv3x3(torch.zeros((1, 4, 4, 8), dtype=torch.int8),
                   torch.zeros((1, 3, 3, 8, 8), dtype=torch.int8))
    assert hm.PLAIN_ON_CUDA == {"int8_linear": 0} and hc.PLAIN_ON_CUDA == {"conv3x3": 0}
    assert hm.LAUNCHES == {"int8_linear": 0, "int8_linear_k_tiled": 0}
    assert hc.LAUNCHES == {"conv3x3": 0, "conv3x3_temporal": 0}
