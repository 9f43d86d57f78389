"""A run of the 1.3B cell on a card, a short window: it prints a result
line with `correct` true; and a traced run of the cell whose VAE is split
over cards 1-3, which reports four cards with the VAE's kernels on cards
1-3. Marked `cuda`; each skips without the cards it needs.

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


@pytest.fixture
def four_cards():
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the DiT on card 0, the VAE split over cards 1-3")


def _run(workload: str, seed: int, seconds: int, trace: int):
    out = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", workload,
                          "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.cuda
def test_a_short_run_of_the_13b_cell_is_correct(card):
    result, _ = _run("t2v-1.3b-int8.stream", 2147483659, 10, 0)
    assert result["correct"] and result["device"]["platform"] == "gpu", result
    assert set(result["metrics"]) == {"fps", "ttff_ms_p50", "block_gap_ms_p90",
                                      "peak_mem_gib", "setup_s"}


@pytest.mark.cuda
def test_a_split_vae_cell_runs_its_vae_on_cards_1_to_3(four_cards):
    result, log = _run("t2v-14b-int8qk.vae-split", 2147483671, 20, 1)
    assert result["correct"] and result["device"]["count"] == 4, result
    busy = json.loads(log.split("busy s in the profiled blocks by card: ")[1].splitlines()[0])
    assert set(busy) == {"0", "1", "2", "3"} and all(v > 0 for v in busy.values()), busy
    peaks = json.loads(log.split("peak memory by card (bytes): ")[1].splitlines()[0])
    assert all(peaks[c] > 0 for c in ("1", "2", "3")), peaks
    assert "vae_overlap_pct" in result["metrics"], result["metrics"]
