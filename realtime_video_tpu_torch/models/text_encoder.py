"""Text encoders for the port. Only the fixed-embedding stand-in is ported so
far (reference USE_STATIC_ENCODER_COND_DICT, release_server.py:125-133); the
umT5 encoder waits for its weights and tokenizer vocabulary."""
from __future__ import annotations

from typing import Dict, List

import torch


class StaticTextEncoder:
    """Returns one fixed [1, T, text_dim] embedding for every prompt."""

    def __init__(self, prompt_embeds: torch.Tensor):
        self.prompt_embeds = prompt_embeds

    def __call__(self, text_prompts: List[str]) -> Dict[str, torch.Tensor]:
        del text_prompts
        return {"prompt_embeds": self.prompt_embeds}
