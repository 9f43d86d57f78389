"""The control of `correct`: a run of a cell (a short window, at the cell's
own size) whose check puts the int4 reference in the program's place.

    python -m gpubench.control --workload <name> --seconds <s> --seeds <n> [<n> ...]

For each seed, one process, it prints the run's result line: its `correct`
and its numbers are the control's, judged against the configuration's
limits as a run judges the program's, so a sound check prints `correct`
false; the program's own numbers stand beside them as `program.<number>`.
The window has to be long enough for one session of the mix to finish. The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys


def one(workload: str, seed: int, seconds: float) -> dict:
    from gpubench import run as bench

    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=0,
                              control=True)
    bench.pin_process()
    return bench.run(args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.workload, args.seeds[0], args.seconds)), flush=True)
        return 0
    rc = 0
    for seed in args.seeds:  # a process a seed
        rc |= subprocess.run([sys.executable, "-m", "gpubench.control", "--one",
                              "--workload", args.workload, "--seconds", str(args.seconds),
                              "--seeds", str(seed)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
