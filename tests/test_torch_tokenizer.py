"""The port's copy of the tokenizer wrapper: its fallback tokenizer gives the
same ids in every interpreter (CRC-32 of each word, where the JAX package's
copy uses Python's per-process salted `hash()`), inside [256, vocab) and
ended by eos 1; the text cleaning equals the JAX package's; without
tokenizer files `load_tokenizer` falls back."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from realtime_video_tpu.utils import tokenizer as jtok
from realtime_video_tpu_torch.utils import tokenizer as ttok

REPO = pathlib.Path(__file__).resolve().parents[1]
PROMPTS = ["A red fox running through snow", "  two   cats &amp; a dog\n at dusk  ", ""]


def _ids_in_a_fresh_interpreter(hash_seed: str) -> list:
    code = ("import json\n"
            "from realtime_video_tpu_torch.utils.tokenizer import FallbackTokenizer\n"
            f"ids, mask = FallbackTokenizer(seq_len=16)({PROMPTS!r})\n"
            "print(json.dumps([ids.tolist(), mask.tolist()]))\n")
    env = dict(os.environ, PYTHONHASHSEED=hash_seed)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout)


def test_fallback_ids_are_equal_across_hash_seeds():
    first, second = _ids_in_a_fresh_interpreter("1"), _ids_in_a_fresh_interpreter("2")
    assert first == second
    ids, mask = ttok.FallbackTokenizer(seq_len=16)(PROMPTS)
    assert [ids.tolist(), mask.tolist()] == first


@pytest.mark.parametrize("vocab_size", [512, 256384])
def test_fallback_ids_range_and_end_token(vocab_size):
    tok = ttok.FallbackTokenizer(seq_len=8, vocab_size=vocab_size)
    ids, mask = tok(["one two three four five six seven eight nine", "hi"])
    assert ids.dtype == mask.dtype == np.int32 and ids.shape == mask.shape == (2, 8)
    assert mask[0].all() and ids[0, -1] == 1  # truncated to seq_len - 1 words, then eos
    assert mask[1].tolist() == [1, 1, 0, 0, 0, 0, 0, 0] and ids[1, 1] == 1
    words = ids[mask.astype(bool) & (ids != 1)]
    assert ((words >= 256) & (words < vocab_size)).all()
    assert ids[1, 0] == ttok.zlib.crc32(b"hi") % (vocab_size - 256) + 256


@pytest.mark.parametrize("text", PROMPTS + ["Hello, World! It_s <b>bold</b>", "A&amp;amp;B"])
def test_cleaning_equals_the_jax_copy(text):
    assert ttok._whitespace_clean(text) == jtok._whitespace_clean(text)
    assert ttok._canonicalize(text) == jtok._canonicalize(text)
    assert ttok._canonicalize(text, "_") == jtok._canonicalize(text, "_")


def test_load_tokenizer_falls_back_without_files(tmp_path):
    tok = ttok.load_tokenizer(str(tmp_path / "absent"), seq_len=32, vocab_size=1000)
    assert isinstance(tok, ttok.FallbackTokenizer)
    assert tok.seq_len == 32 and tok.vocab_size == 1000
    # a folder without tokenizer files: the HuggingFace load fails, then the fallback
    assert isinstance(ttok.load_tokenizer(str(tmp_path), seq_len=32), ttok.FallbackTokenizer)
