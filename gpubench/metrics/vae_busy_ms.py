"""Device-busy ms per profiled warm block of the kernels launched inside the
port's `vae.*` spans (each kernel tied to its launch call by kineto's
correlation id, the call to the innermost span open on its thread)."""


def read(run):
    busy = run.get("span_busy_ms")
    if not busy or "vae" not in busy:
        return None
    return busy["vae"] / run["profiled_blocks"]
