"""Median host ms of the port's `session.setup` span (GenerationSession's
construction: the KV cache, the schedule, the noise) over the window's
sessions: the part of TTFF before block 0."""
from gpubench import spans


def read(run):
    records = run.get("program_spans")
    return spans.median(spans.host_ms(records, "session.setup")) if records else None
