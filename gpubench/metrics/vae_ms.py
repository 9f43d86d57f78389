"""Median CUDA-event milliseconds per warm block of the VAE's decode_block
calls and the re-encode's encode_stream, summed; timed on the VAE's (first)
card."""
import statistics


def read(run):
    values = run["vae_ms"]
    return statistics.median(values) if values else None
