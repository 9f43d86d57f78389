"""A run of the 1.3B cell on a card, a short window: it prints a result
line with `correct` true. Marked `cuda`; skips without a card.

    python -m pytest --noconftest -m cuda gpubench/tests/test_gpubench_cuda.py
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")


@pytest.mark.cuda
def test_a_short_run_of_the_13b_cell_is_correct(card):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload",
                          "t2v-1.3b-int8.stream", "--seed", "2147483659", "--seconds", "10",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert set(result["metrics"]) == {"fps", "ttff_ms_p50", "block_gap_ms_p90",
                                      "peak_mem_gib", "setup_s"}
