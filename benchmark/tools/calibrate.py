#!/usr/bin/env python3
"""Readings that a cell's limits are set from, many seeds in one process:

    python benchmark/tools/calibrate.py --workload <cell> \\
        --seeds <n>[,<n>...] --controls <k> --seconds <s> [--out FILE]

Each seed is one run of the cell (``--seconds`` long, untraced) whose
checked numbers are the program's readings; the first ``--controls``
seeds also read the control: the reference put in the program's place
with TF32 on (the precision below the serving cells' fp32).  The control
is judged by the cell's limits (``check.failed_by``) and its line names
the limits it fails.  One JSON line a seed goes to ``--out`` and to
standard output.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import main as harness  # noqa: E402
from harness import manifest  # noqa: E402
from harness.check import failed_by  # noqa: E402


# the readings of the reference put in the program's place in the lower
# precision
CONTROLS = ("tf32",)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.set_environment()
    cell = manifest.cell(manifest.load_manifest(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds):
        result, checks, info = harness.run_cell(
            cell, seed, args.seconds, False, "cuda",
            controls=i < args.controls)
        controls = info["controls"]
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "correct": result["correct"], "metrics": result["metrics"],
            "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "numbers": {c["name"]: c["value"] for c in checks},
            "controls_fail": {name: failed_by(controls[name], cell["limits"])
                              for name in CONTROLS if name in controls},
            "controls": controls})
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
