"""Per-connection generation state machine (port of
realtime_video_tpu/serving/session.py, after release_server.py:344-751).

Each block: reset the KV cache, prefill it from the clean context latents
(the first frame re-encoded from pixels after warm-up, the anti-drift
measure), run the few-step denoise, then stream the VAE decode one latent
frame at a time. Block 0 drops its first 3 pixel frames, so a session of n
blocks sends 6 + 12 (n - 1) frames. A prompt change lerps the text embedding
over `interp_steps` blocks.

Throughput mode (RTV_SESSION_MEGAFUSE, default 1, as in the JAX session): a
warm block (any block after block 0, outside webcam mode) is decoded latent
by latent as above, and its 12 frames go out in one `frame_callback` after
the last latent's decode is queued. No call of a block waits for a card, in
either mode, so the host queues a block and returns while the card(s) still
run it. Block 0 stays streamed for the first frame's latency.
RTV_SESSION_MEGAFUSE=0 sends every latent's frames as they are decoded.

The TAEHV preview tier (server config `use_taehv`) decodes each block whole
with the tiny autoencoder instead (`models/taehv.py`, its MemBlock state kept
where the Wan decoder keeps its cache): 12 frames a block, of which block 0
drops the first 3, so n blocks send 9 + 12 (n - 1) frames; its pixels feed
the anti-drift re-encode like the Wan decoder's.

Video in, as in the JAX session:
  * `input_video`: the clip is encoded once and mixed into the initial noise
    at the schedule's first timestep; the block count follows the clip;
  * `webcam_mode`: each block waits for the frames the client pushed
    (`push_frame`: 9 at block 0, 12 after), resamples them to that count,
    stream-encodes them with the session's encoder cache and mixes them with
    fresh noise at the session's initial strength;
  * `start_frame`: one image, repeated over the KV-cache window and encoded,
    becomes the resume latents;
  * `resume_latents`: .npy bytes of [Tz, z, h, w] latents that block 0
    takes as its context.

Where the VAE lies on a card of its own, or is split over cards by rows
(`VAEWrapper(device=)` / `mesh=`, chosen by `serving/models.load_vae`), the
per-latent decode runs there and its pixels stay there, in the frame deque
too; the anti-drift re-encode, the webcam, start-frame and v2v encodes read
pixels from wherever they lie and return latents on the DiT's card (the
wrapper's `dit_device`). TAEHV stays on the DiT's card, as in the JAX
session. The re-encode of block n + 1 reads block n's pixels, so it queues
behind block n's decodes on the VAE's card and the DiT's prefill waits for
it.

Random numbers come from a `torch.Generator` seeded with the request's seed
(the JAX package's `jax.random` stream gives other numbers); `noise` injects
the initial latents noise and `noise_fn` every later draw, in the JAX
session's order: the v2v noise at set-up, then per block the webcam noise
before the denoise's renoise draws.
"""
from __future__ import annotations

import asyncio
import io
import logging
import os
import queue
import threading
import time
from collections import deque
from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from realtime_video_tpu_torch.models import taehv as taehv_mod
from realtime_video_tpu_torch.models import wan_dit
from realtime_video_tpu_torch.models.diffusion_wrapper import NoiseFn, generator_noise
from realtime_video_tpu_torch.ops import kv_cache as kvc
from realtime_video_tpu_torch.scheduler import FlowMatchSchedule, get_denoising_schedule
from realtime_video_tpu_torch.serving.models import load_taehv
from realtime_video_tpu_torch.serving.params import GenerateParams
from realtime_video_tpu_torch.serving.video_io import load_video_as_rgb, resample_array
from realtime_video_tpu_torch.utils import trace
from realtime_video_tpu_torch.utils.image import resize_bicubic
from realtime_video_tpu_torch.utils.misc import AtomicCounter

log = logging.getLogger(__name__)


def _ensure_taehv_params(models) -> None:
    """Give `models` TAEHV's params when load_all did not (session.py:40-66 of
    the JAX package builds them at the first preview session)."""
    if getattr(models, "taehv_params", None) is None:
        models.taehv_params = load_taehv(models.transformer.device)


def encode_video_latent(vae, encode_vae_cache, resample_to: Optional[int] = 16,
                        max_frames: Optional[int] = 81,
                        video_path_or_url: Optional[str] = None,
                        frames: Optional[np.ndarray] = None, height: Optional[int] = None,
                        width: Optional[int] = None, stream: bool = False,
                        dtype: torch.dtype = torch.bfloat16):
    """Pixel frames -> normalised latents (reference v2v.py:138-158; session.py:70-107
    of the JAX package). frames: [T, 3, H, W] in [-1, 1], numpy or a tensor;
    resized in f32 on the encoder's device to height x width (rounded down to
    multiples of 8), cast to `dtype` (bf16, as the JAX function does), then
    encoded fresh (chunks 1, 4, 4, ...) or, with `stream`, continuing
    `encode_vae_cache` (chunks 4, 4, ...). Returns ([Tz, z, h, w] in `dtype`,
    cache). The JAX encoder computes in its input's dtype; the port's in its
    weights', which serving keeps in bf16."""
    vae_stride = (4, 8, 8)
    if frames is None:
        frames = load_video_as_rgb(video_path_or_url, resample_to=resample_to,
                                   resample_frame_count_threshold=33)
    frames = torch.as_tensor(frames).to(device=vae.device, dtype=torch.float32)
    if frames.dim() == 3:
        frames = frames[None]
    h = height if height is not None else frames.shape[2]
    w = width if width is not None else frames.shape[3]
    if max_frames is None:
        max_frames = 1 + ((frames.shape[0] - 1) // 4) * 4
    if max_frames:
        frames = frames[:max_frames]
    h = h // vae_stride[1] * vae_stride[1]
    w = w // vae_stride[2] * vae_stride[2]
    pixels = resize_bicubic(frames, h, w).to(dtype)
    latents, cache = vae.encode_stream(pixels[None].to(vae.dtype),
                                       encode_vae_cache if stream else None)
    return latents[0].to(pixels.dtype), cache


@lru_cache(maxsize=32)
def _encode_v2v_cached(vae_encoder, video_path_or_url, height, width, max_frames,
                       resample_to):
    """A clip's latents, keyed on the long-lived encoder and the request's
    statics (a cache on the session would pin every disposed session's
    latents). The encoder cache is not kept, unlike the JAX package's entry:
    a clip is encoded fresh and never continued, and at 480x832 its cache
    would pin ~3 GiB of the card per entry."""
    latents, _ = encode_video_latent(vae_encoder, None, video_path_or_url=video_path_or_url,
                                     height=height, width=width, stream=False,
                                     max_frames=max_frames, resample_to=resample_to)
    return latents


def _image_to_array(image) -> np.ndarray:
    """A PIL image, an image file's bytes or its path -> [3, H, W] f32 in [-1, 1]."""
    if isinstance(image, (bytes, str)):
        from PIL import Image

        image = Image.open(image if isinstance(image, str) else io.BytesIO(image)).convert("RGB")
    arr = np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0
    return (arr - 0.5) * 2.0


def megafuse_enabled() -> bool:
    """RTV_SESSION_MEGAFUSE, read at each block as the JAX session reads it:
    on (the default) for "1" or "true"."""
    return os.getenv("RTV_SESSION_MEGAFUSE", "1") in ("1", "true")


def block_step(gen, kv_cache, cross, steps: Tuple[float, ...],
               clean_context: Optional[torch.Tensor], noisy: torch.Tensor,
               current_start: int, fsl: int, nfpb: int, max_attn: int,
               schedule: FlowMatchSchedule, noise_fn: NoiseFn):
    """One serving block on `kv_cache` (zeroed, then prefilled from the clean
    context when there is one) and the text K/V `cross`: the few-step
    denoise of `noisy`. Returns (x0 [1, nfpb, 16, h, w], kv_cache). The
    session runs it on its pipeline's caches, the warm-up on scratch ones.
    Its span: `dit.block_step`."""
    with trace.span("dit.block_step"):
        kvc.reset_kv_cache(kv_cache)
        if clean_context is not None:
            wan_dit.context_prefill(gen.cfg, gen.params, clean_context, gen.rope, cross,
                                    kv_cache, block_tokens=fsl * nfpb, layers=gen.layers)
        denoise = gen.make_denoise_block_fn(steps, max_attn, schedule=schedule)
        return denoise(kv_cache, cross, noisy, current_start, noise_fn)


class GenerationSession:
    SESSION_COUNTER = AtomicCounter()

    def __init__(self, params: GenerateParams, config,
                 frame_callback: Optional[Callable] = None, models=None,
                 noise: Optional[torch.Tensor] = None,
                 noise_fn: Optional[NoiseFn] = None):
        self.session_id = self.SESSION_COUNTER.increment()
        with trace.span("session.setup", self.session_id):
            self._setup(params, config, frame_callback, models, noise, noise_fn)

    def _setup(self, params, config, frame_callback, models, noise, noise_fn):
        self.use_taehv = bool(config.get("use_taehv", False))
        self.frame_callback = frame_callback or (
            lambda *a, **k: log.warning("No frame callback set!"))
        #: webcam frames pushed by the client: ([3, H, W] in [-1, 1], request id)
        self.frame_queue: "queue.Queue" = queue.Queue()
        self.block_idx = 0
        self.params = params
        self.config = config
        self.models = models
        self.input_video = params.input_video
        if self.input_video is None and not params.webcam_mode:
            self.params.strength = 1.0  # text-to-video denoises from pure noise

        self.device = models.transformer.device
        self.dtype = models.transformer.dtype
        self.width = params.width // 8 * 8
        self.height = params.height // 8 * 8
        self.latent_width = self.width // 8
        self.latent_height = self.height // 8
        self.resume_latents: Optional[torch.Tensor] = None

        self.interpolated_prompt_embeds: List[torch.Tensor] = []
        self.current_prompt_embeds: Optional[torch.Tensor] = None

        self.kv_cache_num_frames = params.kv_cache_num_frames
        self.num_blocks = params.num_blocks
        # raw pixel frames of the recent blocks, for the anti-drift re-encode
        self.frame_context_cache: deque = deque(
            maxlen=1 + (params.kv_cache_num_frames - 1) * 4)
        self.encode_vae_cache = None
        self.decode_vae_cache = None
        self.num_frame_per_block = 3

        if self.params.seed is None:
            self.params.seed = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.params.seed)
        latent_shape = (1, self.num_blocks * self.num_frame_per_block, 16,
                        self.latent_height, self.latent_width)
        self.all_latents = torch.zeros(latent_shape, dtype=self.dtype, device=self.device)
        if noise is None:
            noise = torch.randn(latent_shape, generator=self.generator,
                                dtype=torch.float32, device=self.device)
        self.noise = noise.to(device=self.device, dtype=self.dtype)
        self.noise_fn = noise_fn or generator_noise(self.generator)

        self.current_start_frame = 0
        self.total_frames_sent = 0
        self.disposed = threading.Event()
        self.init_models(models, self.params)
        self.denoising_step_list = get_denoising_schedule(
            self.zero_padded_timesteps, self.params.strength,
            steps=self.params.num_denoising_steps)
        log.info("denoising step list: %s", self.denoising_step_list)

        if self.input_video is not None:
            # the clip's latents, mixed into the initial noise at the first
            # timestep (release_server.py:420-430)
            init_strength = float(self.denoising_step_list[0]) / 1000.0
            latents = self.encode_v2v(self.input_video)[None].to(self.noise.dtype)
            nz = self.noise_fn(tuple(latents.shape), latents.dtype, self.device)
            n = min(latents.shape[1], self.noise.shape[1])
            mixed = latents[:, :n] * (1.0 - init_strength) + nz[:, :n] * init_strength
            self.noise = torch.cat([mixed, self.noise[:, n:]], dim=1)
            # the -1 (the last input block held back) is the reference's own
            # arithmetic, release_server.py:429: a 1-block clip yields 0 blocks
            actual_num_blocks = latents.shape[1] // self.num_frame_per_block - 1
            self.num_blocks = min(actual_num_blocks, self.params.num_blocks)
        if isinstance(self.params.resume_latents, bytes):
            # serialised .npy latents [Tz, z, h, w] to resume from
            # (GenerateParams.resume_latents, release_server.py:321)
            arr = np.load(io.BytesIO(self.params.resume_latents), allow_pickle=False)
            lat = torch.from_numpy(np.asarray(arr, np.float32)).to(self.device, torch.bfloat16)
            self.resume_latents = lat[None] if lat.dim() == 4 else lat
        if self.params.start_frame is not None:
            self.setup_start_frame(self.params.start_frame, models)

    def dispose(self):
        self.disposed.set()

    @property
    def frame_seq_length(self) -> int:
        return self.models.transformer.cfg.frame_seq_length(
            self.latent_height, self.latent_width)

    def init_models(self, models, params: GenerateParams):
        """Per-session pipeline re-config (release_server.py:542-561): the
        attention window is kv frames + one block, fresh caches, the
        session's shifted schedule."""
        pipeline = models.pipeline
        pipeline.local_attn_size = params.kv_cache_num_frames + pipeline.num_frame_per_block
        self.num_frame_per_block = pipeline.num_frame_per_block
        pipeline._initialize_kv_cache(1, self.frame_seq_length, self.dtype)
        self.schedule = FlowMatchSchedule.create(
            shift=params.timestep_shift, sigma_min=0.0, extra_one_step=True,
            device=self.device)
        self.zero_padded_timesteps = self.schedule.zero_padded_timesteps().cpu().numpy()

    def _max_attn(self) -> int:
        # serving attends over the whole (kv frames + block) cache
        return (self.kv_cache_num_frames + self.num_frame_per_block) * self.frame_seq_length

    def interpolate_prompt_embeds(self, models, new_prompt: str, interpolation_steps: int):
        """Lerp old -> new embeds over N blocks (release_server.py:459-468);
        one step jumps straight to the new prompt."""
        if self.current_prompt_embeds is None:
            return
        p1 = self.current_prompt_embeds
        with trace.span("session.text_encode"):
            p2 = models.text_encoder(text_prompts=[new_prompt])["prompt_embeds"].to(self.dtype)
        if interpolation_steps == 1:
            ws = torch.ones((1,), device=p1.device)
        else:
            ws = torch.linspace(0.0, 1.0, interpolation_steps, device=p1.device)
        ws = ws[:, None, None]
        x = p1[0][None] * (1 - ws) + p2[0][None] * ws  # [steps, T, D]
        self.interpolated_prompt_embeds = [x[i][None] for i in range(interpolation_steps)]

    def push_frame(self, frame, denoising_strength=None, request_id=None):
        """Webcam / v2v frame push (release_server.py:470-487): JPEG or PNG
        bytes, or their base64 (a data URL too)."""
        try:
            if denoising_strength is not None:
                self.params.strength = denoising_strength
            if isinstance(frame, str):
                import base64

                if frame.startswith("data:"):
                    frame = frame[frame.index(",") + 1:]
                frame = base64.b64decode(frame)
            self.frame_queue.put((_image_to_array(bytes(frame)), request_id))
        except Exception as e:  # noqa: BLE001 — a bad frame ends the session
            log.exception("Killing from push_frame: %s", e)
            self.dispose()

    def process_webcam_frames(self, models, idx: int) -> Optional[torch.Tensor]:
        """Wait for 9 (block 0) or 12 pushed frames, take every queued one,
        resample them to that count and stream-encode them
        (release_server.py:489-527); None once the session is disposed."""
        num_frames_to_encode = 9 if idx == 0 else 12
        while self.frame_queue.qsize() < num_frames_to_encode:
            if self.disposed.is_set():
                return None
            time.sleep(0.01)
        frame_list = []
        while not self.frame_queue.empty():
            try:
                frame_list.append(self.frame_queue.get_nowait()[0])
            except queue.Empty:
                break
        if len(frame_list) < num_frames_to_encode:
            return None
        frames = np.stack(resample_array(frame_list, num_frames_to_encode))
        with trace.span("session.webcam_encode"):
            latents, self.encode_vae_cache = encode_video_latent(
                models.vae_encoder, self.encode_vae_cache, frames=frames,
                height=self.params.height, width=self.params.width, stream=idx > 0)
        return latents

    def encode_v2v(self, video_path_or_url: str, max_frames=None,
                   resample_to=None) -> torch.Tensor:
        """The clip's latents [Tz, z, h, w] (cached per encoder and request)."""
        return _encode_v2v_cached(self.models.vae_encoder, video_path_or_url,
                                  self.params.height, self.params.width, max_frames,
                                  resample_to)

    def setup_start_frame(self, image, models):
        """One conditioning image (a PIL image, or an image file's bytes or
        path) repeated over the KV-cache window's pixel frames and encoded
        into resume latents (release_server.py:578-586)."""
        frame_cache_len = 1 + (self.params.kv_cache_num_frames - 1) * 4
        frames = np.stack([_image_to_array(image)] * frame_cache_len)
        latents, _ = encode_video_latent(
            models.vae_encoder, None, resample_to=16, max_frames=81, frames=frames,
            height=self.params.height, width=self.params.width, stream=False)
        self.resume_latents = latents[None]  # [1, kv, z, h, w]

    def get_clean_context_frames(self, models) -> torch.Tensor:
        """First frame + the last (k-1) context latents; after warm-up the
        first frame is re-encoded from the oldest cached pixel frame
        (release_server.py:563-576)."""
        k = self.kv_cache_num_frames
        ctx = self.all_latents[:, :self.current_start_frame]
        warmup = (self.block_idx - 1) * self.num_frame_per_block < k
        if self.params.keep_first_frame or warmup:
            if k == 1:
                return ctx[:, :1]
            return torch.cat([ctx[:, :1], ctx[:, 1:][:, -(k - 1):]], dim=1)
        # k == 1 keeps no tail (the reference's `[:, -k + 1:]` is `[:, 0:]`
        # at k=1, which would overflow the (k+3)-frame cache)
        tail = ctx[:, 1:][:, -(k - 1):] if k > 1 else ctx[:, :0]
        blk, fi = self.frame_context_cache[0]
        first_pixels = blk[:, fi:fi + 1].to(models.vae_encoder.dtype)  # [1, 1, 3, H, W]
        first_latent, _ = models.vae_encoder.encode_stream(first_pixels)
        return torch.cat([first_latent.to(self.all_latents.dtype), tail], dim=1)

    def plan_block_context(self, models) -> Tuple[Optional[torch.Tensor], int]:
        """(clean context latents or None, model input start frame) for this
        block's KV recompute (release_server.py:588-633). Block 0 takes the
        resume latents, when there are any, as its context. Its span:
        `session.context`."""
        with trace.span("session.context"):
            if self.block_idx == 0:
                if self.resume_latents is None:
                    return None, self.current_start_frame
                self.current_start_frame = self.resume_latents.shape[1]
                self.all_latents[:, :self.current_start_frame] = self.resume_latents.to(
                    self.all_latents.dtype)
            k = self.params.kv_cache_num_frames
            return self.get_clean_context_frames(models), min(self.current_start_frame, k)

    def recompute_kv_cache(self, models) -> int:
        """Zero the KV cache and re-prefill it from this block's clean context
        (session.py:584-600 of the JAX package; the hot loop does the same
        inside `block_step`); returns the model input start frame."""
        pipeline = models.pipeline
        clean_context, model_input_start_frame = self.plan_block_context(models)
        pipeline._initialize_kv_cache(1, self.frame_seq_length, self.dtype)
        if clean_context is not None:
            gen = models.transformer
            wan_dit.context_prefill(
                gen.cfg, gen.params, clean_context, gen.rope, pipeline.crossattn_cache,
                pipeline.kv_cache, block_tokens=self.frame_seq_length * self.num_frame_per_block,
                layers=gen.layers)
        return model_input_start_frame

    def block_step(self, models, steps: Tuple[float, ...],
                   clean_context: Optional[torch.Tensor], noisy: torch.Tensor,
                   current_start: int) -> torch.Tensor:
        """Reset the KV cache, prefill it from the clean context, denoise the
        block (`block_step`); returns its clean latents x0 [1, nfpb, 16, h, w]."""
        pipeline = models.pipeline
        x0, pipeline.kv_cache = block_step(
            models.transformer, pipeline.kv_cache, pipeline.crossattn_cache, steps,
            clean_context, noisy, current_start, self.frame_seq_length,
            self.num_frame_per_block, self._max_attn(), self.schedule, self.noise_fn)
        return x0

    def generate_block_internal(self, models) -> Optional[torch.Tensor]:
        """The per-block hot loop (release_server.py:635-736) in the span
        `session.block`."""
        with trace.span("session.block", self.session_id, self.block_idx):
            return self._generate_block(models)

    def _set_text_cache(self, models) -> None:
        with trace.span("session.cross_cache"):
            models.pipeline._initialize_crossattn_cache(self.current_prompt_embeds)

    def _emit(self, pixels: torch.Tensor) -> None:
        with trace.span("session.emit"):
            self.frame_callback(pixels, [], None)
        self.total_frames_sent += pixels.shape[1]

    def _generate_block(self, models) -> Optional[torch.Tensor]:
        idx = self.block_idx
        if idx >= self.num_blocks:
            return None
        nfpb = self.num_frame_per_block
        if self.current_prompt_embeds is None:
            with trace.span("session.text_encode"):
                cond = models.text_encoder(text_prompts=[self.params.prompt])
            self.current_prompt_embeds = cond["prompt_embeds"].to(self.dtype)
            self._set_text_cache(models)
        if idx > 0 and self.current_start_frame + nfpb > self.all_latents.shape[1]:
            # the budget is spent: skip the plan's anti-drift re-encode
            return None
        clean_context, model_input_start_frame = self.plan_block_context(models)
        if self.current_start_frame + nfpb > self.all_latents.shape[1]:
            # resume latents took the frame budget (block 0 included): end
            # instead of denoising an empty block
            return None
        csf = self.current_start_frame

        if self.params.webcam_mode:
            latents = self.process_webcam_frames(models, idx)
            if latents is None:
                return None
            # a mid-stream strength push only sets params.strength: the step
            # list, and so this mix, keeps the session's initial strength
            # (release_server.py:656)
            strength = float(self.denoising_step_list[0]) / 1000.0
            latents = latents[None].to(self.noise.dtype)
            nz = self.noise_fn(tuple(latents.shape), latents.dtype, self.device)
            noisy_input = latents * (1.0 - strength) + nz * strength
        else:
            noisy_input = self.noise[:, csf:csf + nfpb]

        if self.interpolated_prompt_embeds:
            self.current_prompt_embeds = self.interpolated_prompt_embeds.pop(0).to(self.dtype)
            self._set_text_cache(models)

        steps = tuple(float(t) for t in self.denoising_step_list)
        x0 = self.block_step(models, steps, clean_context, noisy_input,
                             model_input_start_frame * self.frame_seq_length)
        self.all_latents[:, csf:csf + nfpb] = x0
        if self.use_taehv:
            return self._emit_taehv_block(models, x0, idx)

        # stream the decode per latent frame: the block's first pixel frames
        # reach the client before the rest of the block is decoded (the
        # streaming conv cache makes it the whole-block decode's math); in
        # throughput mode a warm block's frames go out in one callback
        # (session.py:674-760 of the JAX package; block 0 has no decode cache
        # yet)
        whole = (megafuse_enabled() and not self.params.webcam_mode
                 and self.decode_vae_cache is not None)
        vae = models.vae_decoder
        drop = 3 if idx == 0 else 0
        parts = []
        for i in range(x0.shape[1]):
            px_i, self.decode_vae_cache = vae.decode_block(
                x0[:, i:i + 1].to(vae.dtype), self.decode_vae_cache)
            for fi in range(px_i.shape[1]):
                self.frame_context_cache.append((px_i, fi))
            out_i = px_i[:, drop:]
            drop = max(0, drop - px_i.shape[1])
            parts.append(out_i)
            if out_i.shape[1] and not whole:
                self._emit(out_i)
        pixels = torch.cat(parts, dim=1)
        if whole:
            self._emit(pixels)
        self.current_start_frame += nfpb
        self.block_idx += 1
        self.resume_latents = None
        return pixels

    def _emit_taehv_block(self, models, x0: torch.Tensor, idx: int) -> torch.Tensor:
        """Decode the block whole with TAEHV in bf16, its state carried in
        `decode_vae_cache`, map ~[0, 1] to [-1, 1], keep every frame for the
        anti-drift re-encode and send them, block 0's first 3 dropped
        (session.py:774-790 and 822-830 of the JAX package)."""
        _ensure_taehv_params(models)
        with trace.span("vae.taehv_decode"):
            px, self.decode_vae_cache = taehv_mod.taehv_decode(
                models.taehv_params, x0.to(torch.bfloat16), self.decode_vae_cache)
        pixels = px * 2.0 - 1.0
        for fi in range(pixels.shape[1]):
            self.frame_context_cache.append((pixels, fi))
        if idx == 0:
            pixels = pixels[:, 3:]
        self._emit(pixels)
        self.current_start_frame += self.num_frame_per_block
        self.block_idx += 1
        self.resume_latents = None
        return pixels

    def generate_block(self, models):
        out = self.generate_block_internal(models)
        if out is None:
            raise asyncio.CancelledError()
        return out

    def generate_blocks(self, num_blocks: int, models) -> None:
        for _ in range(num_blocks):
            self.generate_block(models)

    def __hash__(self):
        return id(self)
