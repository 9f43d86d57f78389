"""Per-request generation parameters — bit-compatible with the reference's
pydantic model (release_server.py:315-341). A copy of
realtime_video_tpu/serving/params.py, which cannot be imported without JAX."""
from __future__ import annotations

from pydantic import BaseModel


class GenerateParams(BaseModel):
    prompt: str
    width: int = 832
    height: int = 480

    seed: int | None = None
    resume_latents: bytes | None = None
    strength: float = 1.0
    request_id: str | None = None

    interp_blocks: int = -1
    context_noise: float = 0.0
    keep_first_frame: bool = False
    kv_cache_num_frames: int = 3
    num_blocks: int = 9
    num_denoising_steps: int | None = 5  # use 4 for performance

    block_on_frame: bool = False

    input_video: str | None = None
    start_frame: bytes | str | None = None
    timestep_shift: float = 5.0

    webcam_mode: bool = False
    webcam_fps: int = 10

    class Config:
        arbitrary_types_allowed = True
