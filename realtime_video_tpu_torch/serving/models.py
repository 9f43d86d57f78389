"""Model loading for the port's server (port of realtime_video_tpu/serving/models.py,
after release_server.py:100-313).

`load_all` builds every component on `device`: the DiT from the config's
`checkpoint_path` when that file exists (a reference state dict; the model is
detected from it), else random-initialised from a seed with a warning; the
Wan 2.1 VAE from MODEL_FOLDER's Wan2.1_VAE.pth when it exists, else random;
the text encoder `load_text_encoder` picks; and, for the TAEHV preview tier
(`use_taehv`), TAEHV's params (`load_taehv`).

The int8 tier follows the JAX loaders' steps on the device itself:
`enable_int8_dit` (default: `enable_int8`) calibrates the DiT's block linears
on the serving denoise schedule and quantises them; `enable_int8` calibrates
and quantises the VAE's 3x3 convs, decoder and encoder both. With
`int8_static_scales` (default on) the activation scales are the calibrated
static ones, else each call takes its own amax. Both finished trees go
through the on-disk cache of `utils/qcache.py` (RTV_QUANT_CACHE,
RTV_QUANT_CACHE_DIR), keyed on their source, the schedule and the code that
shapes their numbers.
"""
from __future__ import annotations

import logging
import os
import time

import torch

from realtime_video_tpu_torch import config as config_mod
from realtime_video_tpu_torch.config import MODEL_FOLDER, T5_CONFIGS, WAN_CONFIGS
from realtime_video_tpu_torch.models import diffusion_wrapper as dw_mod
from realtime_video_tpu_torch.models import taehv as taehv_mod
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder, WanTextEncoder
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper
from realtime_video_tpu_torch.ops import hopper_conv, hopper_int8_mm
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule, get_denoising_schedule
from realtime_video_tpu_torch.utils import qcache

log = logging.getLogger(__name__)


class Models:
    def __init__(self, text_encoder, transformer, pipeline, vae_encoder, vae_decoder,
                 taehv_params=None):
        self.text_encoder = text_encoder
        self.transformer: WanDiffusion = transformer
        self.pipeline: CausalInferencePipeline = pipeline
        # one VAEWrapper serves both roles; two attributes for API parity
        self.vae_encoder: VAEWrapper = vae_encoder
        self.vae_decoder: VAEWrapper = vae_decoder
        #: the TAEHV preview decoder's params (`load_taehv`), built by load_all
        #: for a `use_taehv` config, else at a preview session's start
        self.taehv_params = taehv_params


def _denoise_steps(config, shift) -> tuple:
    """The serving denoising schedule, which drives the DiT's int8 calibration."""
    schedule = FlowMatchSchedule.create(shift=float(shift), sigma_min=0.0,
                                        extra_one_step=True)
    return tuple(float(t) for t in get_denoising_schedule(
        schedule.zero_padded_timesteps(), 1.0,
        int(config.get("num_denoising_steps", 5) or 5)))


def _build_base_transformer(config, ckpt: str, shift, device, seed: int) -> WanDiffusion:
    """The bf16 DiT from `ckpt` when it exists, else random-init `model_name`
    with a warning (serving/models.py:52-63 of the JAX package)."""
    if ckpt and os.path.exists(ckpt):
        return WanDiffusion(checkpoint_path=ckpt, timestep_shift=shift, device=device,
                            dtype=torch.bfloat16)
    name = config.get("model_name", "t2v-1.3B")
    log.warning("checkpoint %r missing — random-init %s", ckpt, name)
    return WanDiffusion(cfg=WAN_CONFIGS[name], timestep_shift=shift, device=device,
                        dtype=torch.bfloat16, seed=seed)


def load_transformer(config, device, seed: int = 0) -> WanDiffusion:
    """The DiT in bf16 on `device` (`checkpoint_path`, or random init); on the
    int8 tier, calibrated (on the serving schedule, when scales are static)
    and quantised there."""
    device = torch.device(device)
    shift = config.get("timestep_shift", 5.0)
    ckpt = config.get("checkpoint_path", "")
    if not config.get("enable_int8_dit", config.get("enable_int8", False)):
        return _build_base_transformer(config, ckpt, shift, device, seed)
    static = bool(config.get("int8_static_scales", True))
    steps = _denoise_steps(config, shift) if static else None
    src = (qcache.file_sig(ckpt) if ckpt and os.path.exists(ckpt)
           else f"random:{config.get('model_name', 't2v-1.3B')}:{seed}:{device.type}")
    key = qcache.cache_key(src, float(shift), steps, qcache.code_hash(wan_dit),
                           qcache.code_hash(config_mod), qcache.code_hash(dw_mod),
                           qcache.code_hash(hopper_int8_mm), "qp1")

    def build():
        transformer = _build_base_transformer(config, ckpt, shift, device, seed)
        act_scales = (transformer.calibrate_act_scales(steps, seed=seed)
                      if static else None)
        return {"cfg": transformer.cfg,
                "params": wan_dit.quantize_wan_linears(transformer.params,
                                                       act_scales=act_scales)}

    entry = qcache.cached_tree("dit_qparams", key, build, device, log)
    log.info("DiT linears quantised to int8 (static scales: %s)", static)
    return WanDiffusion(cfg=entry["cfg"], params=entry["params"], timestep_shift=shift)


def load_vae(config, device, seed: int = 0) -> VAEWrapper:
    """The Wan 2.1 VAE in bf16 on `device` (Wan2.1_VAE.pth under MODEL_FOLDER,
    or random init); with `enable_int8`, its 3x3 convs calibrated (static
    scales: a float decode of 2 latents (1, 2, 8, 8, 16) and an encode of one
    (1, 1, 64, 64, 3) frame, the JAX loader's shapes) and quantised there, the
    encoder's included."""
    device = torch.device(device)
    if not config.get("enable_int8", False):
        return VAEWrapper.from_model_folder(dtype=torch.bfloat16, device=device, seed=seed)
    static = bool(config.get("int8_static_scales", True))
    ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth")
    src = (qcache.file_sig(ckpt) if os.path.exists(ckpt)
           else f"random:wan2.1:{seed}:{device.type}")
    key = qcache.cache_key(src, static, qcache.code_hash(vae_mod),
                           qcache.code_hash(config_mod), qcache.code_hash(hopper_conv), "vq1")

    def build():
        vae = VAEWrapper.from_model_folder(dtype=torch.bfloat16, device=device, seed=seed)
        act_scales = None
        if static:
            gen = torch.Generator(device=device).manual_seed(seed)
            zc = torch.randn((1, 2, 8, 8, vae.cfg.z_dim), generator=gen, device=device)
            pxc = torch.rand((1, 1, 64, 64, 3), generator=gen, device=device) * 2.0 - 1.0
            act_scales = vae_mod.calibrate_vae_act_scales(
                vae.cfg, vae.params, zc.to(torch.bfloat16), pxc.to(torch.bfloat16))
        return {"cfg": vae.cfg,
                "params": vae_mod.quantize_vae_params(vae.params, act_scales=act_scales)}

    entry = qcache.cached_tree("vae_qparams", key, build, device, log)
    log.info("VAE convs quantised to int8 (static scales: %s)", static)
    return VAEWrapper(cfg=entry["cfg"], params=entry["params"])


def _env_flag(name: str, default: str, true=("true", "1", "yes")) -> bool:
    return os.getenv(name, default).lower() in true


def load_text_encoder(config, device, seed: int = 0, text_len: int = 512,
                      text_dim: int = 4096):
    """serving/models.py:129-143 of the JAX package: USE_STATIC_ENCODER_COND_DICT
    serves one fixed [1, text_len, text_dim] embedding (drawn from `seed`);
    RTV_T5_TINY the random t5-tiny; otherwise umT5-xxl, from the model folder's
    checkpoint or random-initialised from `seed` on `device`."""
    del config  # the JAX loader reads only the environment too
    if _env_flag("USE_STATIC_ENCODER_COND_DICT", "false"):
        gen = torch.Generator(device=device).manual_seed(seed)
        emb = torch.randn((1, text_len, text_dim), generator=gen, dtype=torch.float32,
                          device=device)
        return StaticTextEncoder(emb.to(torch.bfloat16))
    if _env_flag("RTV_T5_TINY", "0", ("1", "true")):
        return WanTextEncoder(cfg=T5_CONFIGS["t5-tiny"], device=device, seed=seed)
    return WanTextEncoder.from_model_folder(device=device, seed=seed)


#: the seed of TAEHV's random init when no checkpoint is found (the JAX session's key)
TAEHV_SEED = 0


def load_taehv(device):
    """TAEHV's params in bf16 on `device`, from RTV_TAEHV_CKPT (default
    checkpoints/taew2_1.pth, the reference's taew2_1) when that file exists,
    else random-initialised from TAEHV_SEED with a warning, as the JAX session
    does (session.py:40-66 of the JAX package)."""
    ckpt = os.getenv("RTV_TAEHV_CKPT", "checkpoints/taew2_1.pth")
    if ckpt and os.path.exists(ckpt):
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        log.info("loaded TAEHV weights from %s", ckpt)
        return taehv_mod.convert_taehv_checkpoint(sd, torch.bfloat16, device)
    log.warning("TAEHV checkpoint %r missing — random-init TAEHV", ckpt)
    gen = torch.Generator(device=device).manual_seed(TAEHV_SEED)
    return taehv_mod.init_taehv_params(gen, device, torch.bfloat16)


def load_all(config, device, seed: int = 0) -> Models:
    """DiT (`checkpoint_path`, else config["model_name"] from `seed`), Wan 2.1
    VAE (seed + 1), text encoder (seed + 2) and, with `use_taehv`, TAEHV on
    `device`, in the tier the config asks for."""
    t0 = time.time()
    device = torch.device(device)
    transformer = load_transformer(config, device, seed)
    text_encoder = load_text_encoder(config, device, seed + 2, transformer.cfg.text_len,
                                     transformer.cfg.text_dim)
    vae = load_vae(config, device, seed + 1)
    pipeline = CausalInferencePipeline(config, transformer, text_encoder, vae)
    taehv = load_taehv(device) if config.get("use_taehv", False) else None
    log.info("All models loaded in %.2fs", time.time() - t0)
    return Models(text_encoder, transformer, pipeline, vae, vae, taehv)
