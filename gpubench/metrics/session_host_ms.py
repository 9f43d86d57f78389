"""Median host milliseconds inside GenerationSession.generate_block per warm block (no sync: the host's enqueue time), profiled blocks left out."""
import statistics


def read(run):
    values = run["session_host_ms"]
    return statistics.median(values) if values else None
