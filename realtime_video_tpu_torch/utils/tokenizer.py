"""Tokenizer wrapper (reference: wan/modules/tokenizers.py:37-83); a copy of
realtime_video_tpu/utils/tokenizer.py, whose package cannot be imported
without JAX.

Wraps a local HuggingFace tokenizer (google/umt5-xxl files under MODEL_FOLDER)
with whitespace cleaning and fixed-length padding to 512. When no tokenizer
files exist on disk (dev boxes with no checkpoints), a hash fallback keeps the
full pipeline runnable end-to-end. Unlike the JAX package's copy, the fallback
hashes each word with CRC-32 of its UTF-8 bytes, so its ids are the same in
every process (Python's `hash()` of a str is salted per process).
"""
from __future__ import annotations

import html
import os
import re
import string
import zlib
from typing import List, Optional, Tuple

import numpy as np


def _canonicalize(text: str, keep_punctuation_exact_string: Optional[str] = None) -> str:
    text = text.replace("_", " ")
    if keep_punctuation_exact_string:
        text = keep_punctuation_exact_string.join(
            part.translate(str.maketrans("", "", string.punctuation))
            for part in text.split(keep_punctuation_exact_string)
        )
    else:
        text = text.translate(str.maketrans("", "", string.punctuation))
    text = text.lower()
    return re.sub(r"\s+", " ", text).strip()


def _whitespace_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


class HuggingfaceTokenizer:
    """seq_len-padded tokenizer with cleaning modes (tokenizers.py:37-83)."""

    def __init__(self, name: str, seq_len: int = 512, clean: str = "whitespace"):
        self.name = name
        self.seq_len = seq_len
        self.clean = clean
        from transformers import AutoTokenizer

        self.tokenizer = AutoTokenizer.from_pretrained(name)
        self.vocab_size = self.tokenizer.vocab_size

    def _clean(self, text: str) -> str:
        if self.clean == "whitespace":
            return _whitespace_clean(text)
        if self.clean == "lower":
            return _whitespace_clean(text).lower()
        if self.clean == "canonicalize":
            return _canonicalize(text)
        return text

    def __call__(
        self, sequence: List[str], return_mask: bool = True, add_special_tokens: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        texts = [self._clean(t) for t in sequence]
        out = self.tokenizer(
            texts,
            padding="max_length",
            truncation=True,
            max_length=self.seq_len,
            add_special_tokens=add_special_tokens,
            return_tensors="np",
        )
        ids = out["input_ids"].astype(np.int32)
        mask = out["attention_mask"].astype(np.int32)
        if return_mask:
            return ids, mask
        return ids


def _word_id(word: str, vocab_size: int) -> int:
    """A stable id in [256, vocab_size) for a word: CRC-32 of its UTF-8 bytes."""
    return zlib.crc32(word.encode("utf-8")) % (vocab_size - 256) + 256


class FallbackTokenizer:
    """Deterministic hash tokenizer for environments without tokenizer files:
    ids in [256, vocab) from `_word_id`, then `eos_id` 1, padded with 0.

    NOT a replacement for umt5 tokenization — only for end-to-end plumbing
    and tests with random weights.
    """

    def __init__(self, seq_len: int = 512, vocab_size: int = 256384):
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.eos_id = 1

    def __call__(
        self, sequence: List[str], return_mask: bool = True, add_special_tokens: bool = True
    ):
        ids = np.zeros((len(sequence), self.seq_len), np.int32)
        mask = np.zeros((len(sequence), self.seq_len), np.int32)
        for bi, text in enumerate(sequence):
            words = _whitespace_clean(text).split(" ")
            toks = [_word_id(wd, self.vocab_size) for wd in words if wd][: self.seq_len - 1]
            toks.append(self.eos_id)
            ids[bi, : len(toks)] = toks
            mask[bi, : len(toks)] = 1
        if return_mask:
            return ids, mask
        return ids


def load_tokenizer(path: Optional[str], seq_len: int = 512, vocab_size: int = 256384):
    """The HuggingFace tokenizer under `path`, else the fallback with ids below
    `vocab_size` (the encoder's vocabulary: the JAX package's fallback always
    draws from umT5's 256384, past a smaller encoder's table)."""
    if path and os.path.isdir(path):
        try:
            return HuggingfaceTokenizer(path, seq_len=seq_len, clean="whitespace")
        except Exception:  # noqa: BLE001 — no transformers, or unreadable files
            pass
    return FallbackTokenizer(seq_len=seq_len, vocab_size=vocab_size)
