"""Share of its roofline of the VAE conv family (the int8 conv kernel with
its quantise pre-pass, library convolutions): the least time of the
profiled warm blocks' decode and re-encode convs over that family's device
time in the trace, summed over the cards that ran it, in %."""
from gpubench import roofline


def read(run):
    prof = run["profile"]
    spent = prof and prof["by_family_s"]["conv"]
    if not spent:
        return None
    return 100.0 * run["profiled_blocks"] * roofline.least_time_s(run["work"]["conv"]) / spent
