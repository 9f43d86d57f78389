"""Median host ms inside the port's `dit.block_step` span (KV reset, context
prefill, the 4-step denoise) per warm block of the window: the host's
time to launch the DiT's work, or, where the launch queue is full, to wait
for room in it (then an upper bound on the enqueue cost)."""
from gpubench import spans


def read(run):
    records = run.get("program_spans")
    return spans.median(spans.block_host_ms(records, ("dit.block_step",))) if records else None
