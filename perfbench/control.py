"""Readings that set the limits of ``correct``: the control, and sound runs.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --seconds <s> [--sound]

The control is the program on its inputs in the nearest precision below
the configuration's (float32 for float64), through the same window and
the same comparison with the plain reference; each seed prints one JSON
line of its checks.  ``--sound`` runs each seed in the configuration's
precision as well.  The benchmark's own runs never run this."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parent.parent),
                str(Path(__file__).resolve().parent.parent / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", action="store_true")
    args = ap.parse_args()

    import torch

    from perfbench import harness, spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    lower = {torch.float64: torch.float32}[spec.family(cell).DTYPES[cell.config["dtype"]]]
    kinds = [("control", lower)] + ([("sound", None)] if args.sound else [])
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, dtype in kinds:
            t0 = time.perf_counter()
            run = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t0, control=dtype)
            print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                              "correct": harness.passes(run.checks), "solves": len(run.solves),
                              "outers": [s.outer for s in run.solves],
                              "converged": [s.converged for s in run.solves],
                              "checks": {k: c["value"] for k, c in run.checks.items()},
                              "seconds": time.perf_counter() - t0}), flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
