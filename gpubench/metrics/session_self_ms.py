"""Median self time of the port's `session.block` span per warm block of the
window, in ms: its host time less the union of its children's (context
plan, DiT, VAE, emits): the session's own bookkeeping between the layers."""
from gpubench import spans


def read(run):
    records = run.get("program_spans")
    return spans.median(spans.self_ms(records, "session.block")) if records else None
