"""Model loading for the port's server (port of realtime_video_tpu/serving/models.py,
after release_server.py:100-313).

`load_all` builds every component on `device`: the DiT from the config's
`checkpoint_path` when that file exists (a reference state dict; the model is
detected from it), else random-initialised from a seed with a warning; the
Wan 2.1 VAE from MODEL_FOLDER's Wan2.1_VAE.pth when it exists, else random;
the text encoder `load_text_encoder` picks; and, for the TAEHV preview tier
(`use_taehv`), TAEHV's params (`load_taehv`). `warmup_models` then takes
what a fresh server's first session would pay (the server calls it under
DO_COMPILE).

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
import math
import os
import time
from typing import Optional, Tuple

import torch

from realtime_video_tpu_torch import config as config_mod
from realtime_video_tpu_torch.config import (
    COMPILE_SHAPES,
    MODEL_FOLDER,
    T5_CONFIGS,
    WAN_CONFIGS,
)
from realtime_video_tpu_torch.models import diffusion_wrapper as dw_mod
from realtime_video_tpu_torch.models import taehv as taehv_mod
from realtime_video_tpu_torch.models import vae as vae_mod
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import WanDiffusion
from realtime_video_tpu_torch.models.text_encoder import StaticTextEncoder, WanTextEncoder
from realtime_video_tpu_torch.models.vae_wrapper import VAEWrapper, fuseup_enabled
from realtime_video_tpu_torch.ops import (hopper_attention, hopper_conv, hopper_dit_norm,
                                          hopper_int8_mm)
from realtime_video_tpu_torch.pipelines.causal_inference import CausalInferencePipeline
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule, get_denoising_schedule
from realtime_video_tpu_torch.utils import qcache, trace
from realtime_video_tpu_torch.utils.device import indexed

log = logging.getLogger(__name__)


class Models:
    def __init__(self, text_encoder, transformer, pipeline, vae_encoder, vae_decoder,
                 taehv_params=None, load_seconds=None):
        self.text_encoder = text_encoder
        self.transformer: WanDiffusion = transformer
        self.pipeline: CausalInferencePipeline = pipeline
        # one VAEWrapper serves both roles; two attributes for API parity
        self.vae_encoder: VAEWrapper = vae_encoder
        self.vae_decoder: VAEWrapper = vae_decoder
        #: the TAEHV preview decoder's params (`load_taehv`), built by load_all
        #: for a `use_taehv` config, else at a preview session's start
        self.taehv_params = taehv_params
        #: seconds `load_all` took per component (transformer, text_encoder,
        #: vae), the device synchronised after each: its spans `setup.load.*`
        self.load_seconds = load_seconds


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


def vae_placement(config, n_cards: int, env=None) -> Tuple[Optional[int], Tuple[int, ...]]:
    """(the card the VAE is pinned to, or None; the cards its row split runs
    on, or ()), as the JAX loader chooses (serving/models.py:145-178 of the
    JAX package): RTV_VAE_DEVICE, else the config's `vae_device_index` (0 is
    a card, null none), pins it; RTV_VAE_SP_DEVICES, else `vae_sp_devices`,
    N >= 2 splits it over cards 1..N while card 0 runs the DiT, and then no
    pin applies. Unlike the JAX loader, which warns and leaves the VAE on the
    default chip, a card that is not attached raises: nothing runs on
    another device in silence. `env` defaults to os.environ."""
    env = os.environ if env is None else env
    env_dev, cfg_dev = env.get("RTV_VAE_DEVICE"), config.get("vae_device_index")
    dev = int(env_dev) if env_dev not in (None, "") else (
        int(cfg_dev) if cfg_dev is not None else -1)
    if dev >= n_cards:
        raise ValueError(f"VAE device {dev} requested (RTV_VAE_DEVICE / vae_device_index) "
                         f"but {n_cards} CUDA devices are attached")
    env_sp = env.get("RTV_VAE_SP_DEVICES")
    n_sp = int(env_sp) if env_sp not in (None, "") else int(
        config.get("vae_sp_devices", 0) or 0)
    if n_sp >= 2:
        if n_cards <= n_sp:
            raise ValueError(f"a VAE split over {n_sp} devices (RTV_VAE_SP_DEVICES / "
                             f"vae_sp_devices) takes cards 1..{n_sp} beside the DiT's card "
                             f"0, but {n_cards} CUDA devices are attached")
        return None, tuple(range(1, 1 + n_sp))
    return (dev if dev >= 0 else None), ()


def _card(index: int) -> torch.device:
    return torch.device("cuda", index)


def load_vae(config, device, seed: int = 0) -> VAEWrapper:
    """The Wan 2.1 VAE in bf16 (Wan2.1_VAE.pth under MODEL_FOLDER, or random
    init) beside the DiT on `device`, or on the card `vae_placement` pins it
    to, or split by rows over the cards it names (built on the first, then
    copied to each); with `enable_int8`, its 3x3 convs calibrated (static
    scales: a float decode of 2 latents (1, 2, 8, 8, 16) and an encode of one
    (1, 1, 64, 64, 3) frame, the JAX loader's shapes) and quantised on the
    VAE's card, the encoder's included. Encoded latents come back to
    `device`."""
    device = indexed(device)
    pin, split = vae_placement(config, torch.cuda.device_count())
    cards = [_card(i) for i in split]
    home = cards[0] if cards else (_card(pin) if pin is not None else device)
    if pin is not None:
        log.info("VAE pinned to %s (its decode runs beside the DiT's denoise)", home)
    if cards:
        log.info("VAE split by rows over %s", ", ".join(map(str, cards)))
    place = dict(mesh=cards, dit_device=device) if cards else dict(device=home,
                                                                    dit_device=device)
    if not config.get("enable_int8", False):
        return VAEWrapper.from_model_folder(dtype=torch.bfloat16, seed=seed, **place)
    static = bool(config.get("int8_static_scales", True))
    ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", "Wan2.1_VAE.pth")
    src = (qcache.file_sig(ckpt) if os.path.exists(ckpt)
           else f"random:wan2.1:{seed}:{home.type}")
    key = qcache.cache_key(src, static, fuseup_enabled(), qcache.code_hash(vae_mod),
                           qcache.code_hash(config_mod), qcache.code_hash(hopper_conv), "vq1")

    def build():
        # the constructor folds the upsamples first under RTV_VAE_FUSEUP
        vae = VAEWrapper.from_model_folder(dtype=torch.bfloat16, device=home, seed=seed)
        act_scales = None
        if static:
            gen = torch.Generator(device=home).manual_seed(seed)
            zc = torch.randn((1, 2, 8, 8, vae.cfg.z_dim), generator=gen, device=home)
            pxc = torch.rand((1, 1, 64, 64, 3), generator=gen, device=home) * 2.0 - 1.0
            act_scales = vae_mod.calibrate_vae_act_scales(
                vae.cfg, vae.params, zc.to(torch.bfloat16), pxc.to(torch.bfloat16))
        return {"cfg": vae.cfg,
                "params": vae_mod.quantize_vae_params(vae.params, act_scales=act_scales)}

    entry = qcache.cached_tree("vae_qparams", key, build, home, log)
    log.info("VAE convs quantised to int8 (static scales: %s)", static)
    return VAEWrapper(cfg=entry["cfg"], params=entry["params"], **place)


def vae_devices(vae: VAEWrapper) -> tuple:
    """Every device the VAE computes on."""
    return getattr(vae, "devices", None) or (vae.device,)


def _sync(*devices) -> None:
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


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


def load_pipeline(config, transformer, text_encoder, vae) -> CausalInferencePipeline:
    return CausalInferencePipeline(config, transformer, text_encoder, vae)


def check_mesh_shape(config) -> None:
    """The server runs on one card: a `mesh_shape` whose sizes multiply to
    more than 1 device is refused, not run on one card in silence. (The
    JAX server never reads `mesh_shape` either; the tp denoise block runs
    outside the server, one process a rank: `parallel/launch.py`.)"""
    shape = dict(config.get("mesh_shape") or {})
    devices = math.prod(int(n) for n in shape.values())
    if devices > 1:
        raise ValueError(f"mesh_shape {shape} asks for {devices} devices; the server runs on "
                         "one card (tp inside the server: ROADMAP): set mesh_shape: {}")


def load_all(config, device, seed: int = 0) -> Models:
    """DiT (`checkpoint_path`, else config["model_name"] from `seed`), Wan 2.1
    VAE (seed + 1), text encoder (seed + 2) and, with `use_taehv`, TAEHV on
    `device`, in the tier the config asks for (the DiT on one device: see
    `check_mesh_shape`; the VAE where `vae_placement` puts it). The Models
    carry each component's load seconds, the spans `setup.load.<name>`."""
    check_mesh_shape(config)
    t0 = time.time()
    device = indexed(device)
    seconds = {}

    def timed(name, fn, *args):
        with trace.timed(f"setup.load.{name}") as span:
            out = fn(*args)
            _sync(device, *(vae_devices(out) if isinstance(out, VAEWrapper) else ()))
        seconds[name] = span.seconds
        return out

    transformer = timed("transformer", load_transformer, config, device, seed)
    text_encoder = timed("text_encoder", load_text_encoder, config, device, seed + 2,
                         transformer.cfg.text_len, transformer.cfg.text_dim)
    vae = timed("vae", load_vae, config, device, seed + 1)
    pipeline = load_pipeline(config, transformer, text_encoder, vae)
    taehv = load_taehv(device) if config.get("use_taehv", False) else None
    log.info("All models loaded in %.2fs", time.time() - t0)
    return Models(text_encoder, transformer, pipeline, vae, vae, taehv, seconds)



def _has_int8(tree) -> bool:
    if isinstance(tree, dict):
        return "w_q" in tree or any(_has_int8(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_int8(v) for v in tree)
    return False


def kernel_sources(models: Models) -> list:
    """The CUDA sources of every kernel library the loaded tier launches while
    serving: the attention kernel and the DiT's norm kernels always, K3 for
    int8 DiT linears, the conv kernel for an int8 VAE."""
    sources = [hopper_attention.SM90_SOURCE, hopper_dit_norm.SOURCE]
    if _has_int8(models.transformer.params):
        sources.append(hopper_int8_mm.SOURCE)
    if _has_int8(models.vae_decoder.params):
        sources.append(hopper_conv.SOURCE)
    return sources


def warmup_models(models: Models, config, shapes=None) -> dict:
    """Take what a fresh server's first session would pay, before any
    session (serving/models.py:250-345 of the JAX package, which compiles
    the hot path; release_server.py:753-755 + COMPILE_SHAPES, settings.py:6).
    The port compiles no program, so it warms what a first session meets
    cold: on a card, the kernel libraries the tier launches
    (`cuda_build.build_all`, nvcc for a missing one) and their loads; then,
    for each (width, height) in `shapes` (default config["compile_shapes"],
    else COMPILE_SHAPES, both orientations), the library handles, kernel
    loads, heuristics and allocator growth of the session's own `block_step`
    on block 0 (no context) and on a steady block (kv_cache_num_frames of
    context), block 0's decode per latent (twice, the second with the
    cache), the steady block's decode as a session decodes it (the Wan VAE
    per latent, or TAEHV with `use_taehv`) and one frame of the stream
    encode; the VAE's work on its own card or cards where it is placed
    there, each of them synchronised with the DiT's before a shape's time
    is read.

    Scratch KV, VAE and TAEHV caches only, and a zero [1, 512, text_dim]
    context for the text K/V: the models' and the pipeline's state stay as
    they were, except TAEHV's params, which a `use_taehv` config without them
    gets here as its first session would. Returns {"build_s": seconds of the
    library builds and loads, "shapes": {"WxH": seconds}}, the seconds of
    the spans `setup.warmup.build` and `setup.warmup.<W>x<H>`."""
    from realtime_video_tpu_torch.ops import cuda_build, kv_cache as kvc
    from realtime_video_tpu_torch.serving.session import _ensure_taehv_params, block_step

    gen = models.transformer
    cfg, dev, dtype = gen.cfg, gen.device, gen.dtype
    shapes = shapes or config.get("compile_shapes") or COMPILE_SHAPES
    shift = float(config.get("timestep_shift", 5.0))
    steps = _denoise_steps(config, shift)
    kv_frames = int(config.get("kv_cache_num_frames", 3))
    nfpb = models.pipeline.num_frame_per_block
    schedule = FlowMatchSchedule.create(shift=shift, sigma_min=0.0, extra_one_step=True,
                                        device=dev)
    use_taehv = bool(config.get("use_taehv", False))
    vae = models.vae_decoder

    def sync():  # the DiT's card and every VAE card
        _sync(dev, *vae_devices(vae), *vae_devices(models.vae_encoder))

    t0 = time.perf_counter()
    with trace.timed("setup.warmup.build") as build:
        if dev.type == "cuda":
            sources = kernel_sources(models)
            libs = cuda_build.build_all(sources)
            hopper_attention._load()
            hopper_dit_norm._load()
            if hopper_int8_mm.SOURCE in libs:
                hopper_int8_mm._load()
            if hopper_conv.SOURCE in libs:
                hopper_conv._load()
    out = {"build_s": build.seconds, "shapes": {}}
    if use_taehv:
        _ensure_taehv_params(models)

    def zeros_like_draw(shape, dtype_, device):
        return torch.zeros(shape, dtype=dtype_, device=device)

    def warm_shape(w, h, cross):
        lat_h, lat_w = h // 8, w // 8
        fsl = cfg.frame_seq_length(lat_h, lat_w)
        max_attn = (kv_frames + nfpb) * fsl
        kv = kvc.init_kv_cache(cfg.num_layers, 1, max_attn, cfg.num_heads, cfg.head_dim,
                               dtype=dtype, device=dev)
        noisy = torch.zeros((1, nfpb, cfg.in_dim, lat_h, lat_w), dtype=dtype, device=dev)
        for nctx in (0, kv_frames):
            clean = (torch.zeros((1, nctx, cfg.in_dim, lat_h, lat_w), dtype=dtype,
                                 device=dev) if nctx else None)
            x0, kv = block_step(gen, kv, cross, steps, clean, noisy, nctx * fsl, fsl,
                                nfpb, max_attn, schedule, zeros_like_draw)
            if nctx == 0:
                # block 0 decodes per latent frame (the streamed path)
                _, vcache = vae.decode_block(x0[:, :1].to(vae.dtype))
                _, vcache = vae.decode_block(x0[:, :1].to(vae.dtype), vcache)
        if use_taehv:
            # a TAEHV session decodes each block whole: fresh, then with state
            _, tstate = taehv_mod.taehv_decode(models.taehv_params,
                                               x0.to(torch.bfloat16), None)
            taehv_mod.taehv_decode(models.taehv_params, x0.to(torch.bfloat16), tstate)
        else:
            for i in range(x0.shape[1]):
                _, vcache = vae.decode_block(x0[:, i:i + 1].to(vae.dtype), vcache)
        models.vae_encoder.encode_stream(
            torch.zeros((1, 1, 3, h, w), dtype=models.vae_encoder.dtype, device=dev))
        sync()

    with torch.no_grad():
        cross = gen.compute_crossattn_cache(
            torch.zeros((1, 512, cfg.text_dim), dtype=dtype, device=dev))
        for w, h in shapes:
            with trace.timed(f"setup.warmup.{w}x{h}") as span:
                warm_shape(w, h, cross)
            out["shapes"][f"{w}x{h}"] = span.seconds
            log.info("warmup %dx%d done (%.1fs)", w, h, span.seconds)
    log.info("warmup complete in %.1fs", time.perf_counter() - t0)
    return out
