"""Median host ms inside the port's `vae.decode` and `vae.encode` spans (a warm
block's 3 per-latent decodes and its anti-drift re-encode) per warm block of
the window: the host's time to launch the VAE's work (an upper bound on it
where the launch queue is full)."""
from gpubench import spans


def read(run):
    records = run.get("program_spans")
    return (spans.median(spans.block_host_ms(records, ("vae.decode", "vae.encode")))
            if records else None)
