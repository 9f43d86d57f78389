"""Text encoders for the port (port of realtime_video_tpu/models/text_encoder.py,
after the reference's utils/wan_wrapper.py:20-55 WanTextEncoder).

`WanTextEncoder`: tokenise -> umT5 encode -> zero the padding positions ->
{"prompt_embeds": [B, 512, 4096]}. It loads the umT5-xxl checkpoint when one
is given, else random-initialises the encoder on its device from a seed; it
uses the HuggingFace tokenizer files when present, else the fallback
tokenizer. `StaticTextEncoder` returns one fixed embedding for every prompt
(the reference's USE_STATIC_ENCODER_COND_DICT, release_server.py:125-133);
`SeededTextEncoder` a random one per prompt, drawn from the prompt's text,
so that a guided sampler's prompt and negative prompt differ without umT5.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Dict, List, Optional

import torch

from realtime_video_tpu_torch.config import MODEL_FOLDER, T5_CONFIGS, T5Config
from realtime_video_tpu_torch.models import t5 as t5_mod
from realtime_video_tpu_torch.utils.device import resolve_device
from realtime_video_tpu_torch.utils.tokenizer import load_tokenizer

T5_CHECKPOINT = "models_t5_umt5-xxl-enc-bf16.safetensors"


class WanTextEncoder:
    """umT5 on one device. Without `params` it loads `checkpoint_path` when
    given, else random-initialises the encoder from `seed` on `device`
    (default: the CUDA card; pass device="cpu" for the CPU); with `params`, it
    runs where they lie."""

    def __init__(self, cfg: Optional[T5Config] = None, params: Optional[Dict[str, Any]] = None,
                 tokenizer=None, dtype=torch.bfloat16, checkpoint_path: Optional[str] = None,
                 tokenizer_path: Optional[str] = None, device=None, seed: int = 0):
        if params is None:
            device = resolve_device(device)
            if checkpoint_path:
                from realtime_video_tpu_torch.utils.checkpoint import load_t5

                cfg, params = load_t5(checkpoint_path, cfg, dtype, device)
            else:
                # random init (dev without checkpoints)
                cfg = cfg or T5_CONFIGS["umt5-xxl"]
                gen = torch.Generator(device=device).manual_seed(seed)
                params = t5_mod.init_t5_encoder_params(cfg, gen, device, dtype)
        self.cfg = cfg or T5_CONFIGS["umt5-xxl"]
        self.params = params
        self.device = params["token_embedding"].device
        if tokenizer is None:
            tokenizer_path = tokenizer_path or os.path.join(
                MODEL_FOLDER, "Wan2.1-T2V-1.3B", "google", "umt5-xxl")
            tokenizer = load_tokenizer(tokenizer_path, seq_len=self.cfg.text_len,
                                       vocab_size=self.cfg.vocab_size)
        self.tokenizer = tokenizer

    @classmethod
    def from_model_folder(cls, dtype=torch.bfloat16, device=None,
                          seed: int = 0) -> "WanTextEncoder":
        ckpt = os.path.join(MODEL_FOLDER, "Wan2.1-T2V-1.3B", T5_CHECKPOINT)
        return cls(checkpoint_path=ckpt if os.path.exists(ckpt) else None, dtype=dtype,
                   device=device, seed=seed)

    def __call__(self, text_prompts: List[str]) -> Dict[str, torch.Tensor]:
        ids, mask = self.tokenizer(text_prompts, return_mask=True, add_special_tokens=True)
        ids = torch.as_tensor(ids, dtype=torch.long).to(self.device)
        mask = torch.as_tensor(mask).to(self.device)
        return {"prompt_embeds": t5_mod.encode_prompts(self.cfg, self.params, ids, mask)}


class StaticTextEncoder:
    """Returns one fixed [1, T, text_dim] embedding for every prompt."""

    def __init__(self, prompt_embeds: torch.Tensor):
        self.prompt_embeds = prompt_embeds

    def __call__(self, text_prompts: List[str]) -> Dict[str, torch.Tensor]:
        del text_prompts
        return {"prompt_embeds": self.prompt_embeds}


class SeededTextEncoder:
    """Returns a random [1, text_len, text_dim] bf16 embedding per prompt,
    drawn on `device` from a generator seeded with the CRC-32 of the
    prompt's text: the same prompt gives the same embedding."""

    def __init__(self, device, text_len: int = 512, text_dim: int = 4096):
        self.device = torch.device(device)
        self.shape = (1, text_len, text_dim)

    def __call__(self, text_prompts: List[str]) -> Dict[str, torch.Tensor]:
        embs = []
        for prompt in text_prompts:
            gen = torch.Generator(device=self.device).manual_seed(zlib.crc32(prompt.encode()))
            embs.append(torch.randn(self.shape, generator=gen, device=self.device))
        return {"prompt_embeds": torch.cat(embs).to(torch.bfloat16)}
