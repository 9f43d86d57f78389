"""Device-busy ms per profiled warm block of the kernels launched inside the
port's `dit.*` spans (each kernel tied to its launch call by kineto's
correlation id, the call to the innermost span open on its thread)."""


def read(run):
    busy = run.get("span_busy_ms")
    if not busy or "dit" not in busy:
        return None
    return busy["dit"] / run["profiled_blocks"]
