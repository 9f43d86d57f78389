"""Share of its roofline of the attention family (the attention kernels and
their pre-passes): the least time of the profiled warm blocks' attention
work (roofline.py, from the shapes) over that family's device time in the
trace, in %."""
from gpubench import roofline


def read(run):
    prof = run["profile"]
    spent = prof and prof["by_family_s"]["attention"]
    if not spent:
        return None
    return 100.0 * run["profiled_blocks"] * roofline.least_time_s(run["work"]["attention"]) / spent
