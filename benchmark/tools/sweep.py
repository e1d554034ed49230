#!/usr/bin/env python3
"""The open-loop cell at several arrival rates, one process, to find the
highest rate the engine sustains without a growing backlog (the knee):

    python benchmark/tools/sweep.py --workload gpt3-1.3b.serve-chat \\
        --rates 3.5,4,4.5,5 --seconds 60 --seed <n> [--out FILE]

For each rate one run of the cell (its own pre-roll, window and grace)
prints the tails and the backlog's signs: the share of the window's
requests that had their first token before the window closed, and the
median time to first token of the last quarter of them against the
first quarter's (a growing queue makes the late ones wait longer).
"""
import argparse
import copy
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))

from harness import main as harness  # noqa: E402
from harness import manifest  # noqa: E402


def backlog(rec: dict) -> dict:
    layer = rec["layer"]
    t0, t1 = layer["t0"], layer["t1"]
    t_begin = t0 - layer["mix"]["preroll_s"]
    ttft, served_in_window = [], 0
    for rid in layer["counted"]:
        seen = layer["stamps"][rid]
        due = t_begin + layer["requests"][rid][1]
        if seen:
            ttft.append((seen[0][0] - due) * 1e3)
            served_in_window += seen[0][0] < t1
        else:
            ttft.append(float("inf"))
    q = max(1, len(ttft) // 4)
    return {"requests": len(ttft),
            "first_token_in_window": served_in_window / max(1, len(ttft)),
            "ttft_p50_first_quarter_ms": float(np.median(ttft[:q])),
            "ttft_p50_last_quarter_ms": float(np.median(ttft[-q:])),
            "ttft_p50_ms": float(np.median(ttft))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.set_environment()
    base = manifest.cell(manifest.load_manifest(), args.workload)
    for rate in [float(r) for r in args.rates.split(",")]:
        cell = copy.deepcopy(base)
        cell["mix"]["rate_per_s"] = rate
        result, _, info = harness.run_cell(cell, args.seed, args.seconds,
                                           False, "cuda")
        line = json.dumps(dict(
            rate_per_s=rate, correct=result["correct"],
            failed=result["failed"],
            metrics={k: v["value"] for k, v in result["metrics"].items()},
            **backlog(info["record"])))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
