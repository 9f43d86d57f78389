"""Median CUDA-event milliseconds of the session's prompt encode (the text encoder's call)."""
import statistics


def read(run):
    values = run["t5_ms"]
    return statistics.median(values) if values else None
