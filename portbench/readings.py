#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process on the
card: the numbers compared, for sound runs of the program on many seeds,
for the control (the plain reference computed in float8 in the
program's place) and for planted faults (``faults.py``).  The benchmark's
own runs do not run it.

    python3 portbench/readings.py --workload scn.train.b1024 --start 100 \\
        --seeds 12 --control 3 --fault half_batch:3

prints one JSON line per run: its kind, its seed and its readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import faults, run  # noqa: E402

# what the drivers report beside the numbers compared
EXTRA = ("losses", "ref_losses", "left_out", "gap_mean", "gap_max",
         "score_err", "score_err_mean")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--fault", action="append", default=[],
                    help="NAME:SEEDS, a fault of faults.py on SEEDS seeds")
    args = ap.parse_args(argv)
    plan = [("program", None, n) for n in range(args.seeds)]
    plan += [("control", None, n) for n in range(args.control)]
    for spec in args.fault:
        name, n = spec.split(":")
        plan += [(name, faults.FAULTS[name], i) for i in range(int(n))]
    for kind, fault, i in plan:
        seed = args.start + i
        t0 = time.time()
        cell_args = run.parse(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", "0"])
        result, facts, _ = run.execute(cell_args, fault=fault,
                                       control=kind == "control")
        print(json.dumps({
            "workload": args.workload, "kind": kind, "seed": seed,
            "readings": {k: v["value"] for k, v in result["checks"].items()},
            "limits": {k: v["limit"] for k, v in result["checks"].items()},
            "seconds": time.time() - t0,
            **{k: facts[k] for k in EXTRA if k in facts}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
