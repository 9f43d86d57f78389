"""Share of its roofline of the linear family (the int8 linear kernel and
library GEMMs): the least time of the profiled warm blocks' DiT linears and
VAE attention products over that family's device time in the trace, in %."""
from gpubench import roofline


def read(run):
    prof = run["profile"]
    spent = prof and prof["by_family_s"]["linear"]
    if not spent:
        return None
    return 100.0 * run["profiled_blocks"] * roofline.least_time_s(run["work"]["linear"]) / spent
