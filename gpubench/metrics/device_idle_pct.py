"""Share of the profiled span of warm blocks in which no kernel ran on the
DiT's card (card 0), in %; an upper bound, for the profiler's own host cost
is in it."""


def read(run):
    prof = run["profile"]
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
