"""Whole-block model FLOP utilisation, in %: the least time of all of a warm
block's matrix work (DiT linears, QK^T and PV, VAE convs and attention
products), each at its own precision's H100 peak, over the traced run's
mean gap between consecutive warm blocks' last frames (profiled blocks left
out), times the cards the cell runs on (their peaks add up)."""
import statistics

from gpubench import roofline


def read(run):
    gaps = run["warm_gaps_ms"]
    if not gaps:
        return None
    seconds = statistics.mean(gaps) / 1e3 * run.get("cards", 1)
    return 100.0 * roofline.matrix_time_s(run["work"]) / seconds
