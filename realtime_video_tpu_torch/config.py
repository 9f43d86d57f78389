"""Model / server configuration (a copy of realtime_video_tpu/config.py).

The JAX package's config module is free of JAX, but importing it runs
`realtime_video_tpu/__init__.py`, which imports JAX; the port therefore keeps
its own copy. Mirrors the reference's three-tier config system (YAML +
per-request params + env), cf. release_server.py:92-98, wan/configs/*.py,
settings.py.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# env tier (reference: settings.py:1-6)
# ---------------------------------------------------------------------------
MODEL_FOLDER = os.getenv("MODEL_FOLDER", os.path.expanduser("~/models"))
#: shapes the server precompiles at startup (reference: settings.py:6)
COMPILE_SHAPES: Tuple[Tuple[int, int], ...] = ((832, 480), (480, 832))


@dataclasses.dataclass(frozen=True)
class WanModelConfig:
    """Architecture of a (causal) Wan DiT.

    Reference dims: wan/configs/wan_t2v_14B.py:22-27, wan_t2v_1_3B.py:22-27,
    CausalWanModel defaults at wan/modules/causal_model.py:537-554.
    """

    model_type: str = "t2v"  # 't2v' | 'i2v'
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    text_len: int = 512
    in_dim: int = 16
    dim: int = 2048
    ffn_dim: int = 8192
    freq_dim: int = 256
    text_dim: int = 4096
    out_dim: int = 16
    num_heads: int = 16
    num_layers: int = 32
    local_attn_size: int = -1  # in latent frames; -1 = global window
    sink_size: int = 0  # frames pinned at cache start during rolling eviction
    qk_norm: bool = True
    cross_attn_norm: bool = True
    eps: float = 1e-6
    rope_max_seq_len: int = 1024

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    def frame_seq_length(self, latent_h: int, latent_w: int) -> int:
        """Tokens per latent frame after patchify (1560 at 832x480)."""
        return (latent_h // self.patch_size[1]) * (latent_w // self.patch_size[2])

    def max_attention_size(self, frame_seqlen: int = 1560) -> int:
        """Token window the decode path attends over.

        Reference: causal_model.py:192 — 32760 (21 frames) when global,
        else local_attn_size frames.
        """
        if self.local_attn_size == -1:
            return 21 * frame_seqlen
        return self.local_attn_size * frame_seqlen


#: canonical model registry (reference: wan/configs/__init__.py:14-19)
WAN_CONFIGS: Dict[str, WanModelConfig] = {
    "t2v-14B": WanModelConfig(dim=5120, ffn_dim=13824, num_heads=40, num_layers=40),
    "t2v-1.3B": WanModelConfig(dim=1536, ffn_dim=8960, num_heads=12, num_layers=30),
    # Wan2.1-I2V-14B's published config.json: model_type "i2v", in_dim 36
    # (16 noisy latent channels + the 4-channel first-frame mask + 16 channels
    # of the encoded conditioning clip), dim 5120, ffn 13824, 40 heads, 40 layers
    "i2v-14B": WanModelConfig(
        model_type="i2v", in_dim=36, dim=5120, ffn_dim=13824, num_heads=40, num_layers=40
    ),
    # tiny config for CPU tests (not in reference)
    "t2v-tiny": WanModelConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2),
}

SIZE_CONFIGS: Dict[str, Tuple[int, int]] = {
    "720*1280": (720, 1280),
    "1280*720": (1280, 720),
    "480*832": (480, 832),
    "832*480": (832, 480),
    "1024*1024": (1024, 1024),
}

SUPPORTED_SIZES: Dict[str, Tuple[str, ...]] = {
    "t2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
    "t2v-1.3B": ("480*832", "832*480"),
    "i2v-14B": ("720*1280", "1280*720", "480*832", "832*480"),
}

#: default negative prompt shared by all Wan configs
#: (reference: wan/configs/shared_config.py)
SAMPLE_NEG_PROMPT = (
    "色调艳丽，过曝，静态，细节模糊不清，字幕，风格，作品，画作，画面，静止，整体发灰，最差质量，"
    "低质量，JPEG压缩残留，丑陋的，残缺的，多余的手指，画得不好的手部，画得不好的脸部，畸形的，"
    "毁容的，形态畸形的肢体，手指融合，静止不动的画面，杂乱的背景，三条腿，背景人很多，倒着走"
)
SAMPLE_FPS = 16
NUM_TRAIN_TIMESTEPS = 1000


@dataclasses.dataclass(frozen=True)
class T5Config:
    """umT5-XXL encoder (reference: wan/modules/t5.py:456-469)."""

    vocab_size: int = 256384
    dim: int = 4096
    dim_attn: int = 4096
    dim_ffn: int = 10240
    num_heads: int = 64
    num_layers: int = 24
    num_buckets: int = 32
    shared_pos: bool = False  # umT5: per-layer relative position embeddings
    max_dist: int = 128
    text_len: int = 512


T5_CONFIGS: Dict[str, T5Config] = {
    "umt5-xxl": T5Config(),
    "t5-tiny": T5Config(
        vocab_size=512, dim=32, dim_attn=32, dim_ffn=64, num_heads=2, num_layers=2
    ),
}


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Wan 2.1 causal 3D VAE (reference: wan/modules/vae.py:586-599)."""

    dim: int = 96
    z_dim: int = 16
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = ()
    temperal_downsample: Tuple[bool, ...] = (False, True, True)

    @property
    def temperal_upsample(self) -> Tuple[bool, ...]:
        return tuple(reversed(self.temperal_downsample))


VAE_CONFIGS: Dict[str, VAEConfig] = {
    "wan2.1": VAEConfig(),
    "vae-tiny": VAEConfig(dim=8, z_dim=4, dim_mult=(1, 1, 2, 2), num_res_blocks=1),
}

#: per-channel latent statistics (reference: wan/modules/vae.py:623-630)
VAE_LATENT_MEAN = (
    -0.7571, -0.7089, -0.9113, 0.1075, -0.1745, 0.9653, -0.1517, 1.5508,
    0.4134, -0.0715, 0.5517, -0.3632, -0.1922, -0.9497, 0.2503, -0.2921,
)
VAE_LATENT_STD = (
    2.8184, 1.4541, 2.3275, 2.6558, 1.2196, 1.7708, 2.6052, 2.0743,
    3.2687, 2.1526, 2.8652, 1.5579, 1.6382, 1.1253, 2.8251, 1.9160,
)
VAE_STRIDE = (4, 8, 8)


# ---------------------------------------------------------------------------
# YAML server-config tier
# ---------------------------------------------------------------------------

_DEFAULT_SERVER_CONFIG: Dict[str, Any] = {
    # reference defaults: configs/default_config.yaml + self_forcing_server_14b.yaml
    "independent_first_frame": False,
    "warp_denoising_step": False,
    "denoising_step_list": [1000, 937, 833, 625, 0],
    "num_train_timestep": 1000,
    "timestep_shift": 5.0,
    "guidance_scale": 3.0,
    "denoising_loss_type": "flow",
    "mixed_precision": True,
    "seed": 0,
    "num_frame_per_block": 3,
    "context_noise": 0,
    "checkpoint_path": "",
    "model_name": "t2v-14B",
    "use_taehv": False,
    "enable_int8": False,
    "do_kv_recomp": True,
    "height": 480,
    "width": 832,
    "causal": True,
    "model_kwargs": {"timestep_shift": 5.0},
    "mesh_shape": {},  # one device; load_all refuses more (tp runs outside the server)
    "param_dtype": "bfloat16",
}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class ServerConfig(dict):
    """Dict with attribute access (replaces OmegaConf in the reference)."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, ServerConfig):
            v = ServerConfig(v)
        return v

    def get(self, name: str, default: Any = None) -> Any:  # noqa: A003
        return super().get(name, default)


def load_server_config(path: Optional[str | Path] = None, **overrides: Any) -> ServerConfig:
    """Load a YAML config merged over the built-in defaults.

    Reference behaviour: release_server.py:92-98 (OmegaConf.merge of
    default_config.yaml under the override file).
    """
    merged = dict(_DEFAULT_SERVER_CONFIG)
    if path is not None:
        import yaml

        with open(path) as f:
            file_cfg = yaml.safe_load(f) or {}
        merged = _deep_merge(merged, file_cfg)
    if overrides:
        merged = _deep_merge(merged, overrides)
    return ServerConfig(merged)
