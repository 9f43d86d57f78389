"""Median CUDA-event milliseconds of serving.session.block_step (context prefill + the denoise) per warm block."""
import statistics


def read(run):
    values = run["dit_ms"]
    return statistics.median(values) if values else None
