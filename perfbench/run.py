"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the plain reference beside its limit, which also end
standard error.  Exits non-zero with no result where there is no CUDA
device, fewer than the cell asks for, or once the window has closed any
of JAX, jaxlib, flax or the JAX package ``repro`` is loaded, on this
rank or on any other of the cell's world (``world.py``)."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache of the program stays in the checkout, at
# fixed paths, so only a checkout's first run builds
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.world import FORBIDDEN, forbidden_loaded  # noqa: E402,F401


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness, spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)   # one process, one host thread: the steadiest load
    run = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    loaded = sorted(set(forbidden_loaded()) | set(run.forbidden))
    if loaded:
        print(f"forbidden modules loaded in the run: {loaded}", file=sys.stderr)
        return 3

    result = harness.result(cell, run, bool(args.trace), torch.cuda.get_device_name(0))
    for k, v in run.setup_stages.items():
        print(f"setup {k}: {v!r} s", file=sys.stderr)
    for r, peak in enumerate(run.memory_peaks):
        print(f"memory peak rank {r}: {peak} bytes", file=sys.stderr)
    print(f"window: {len(run.solves)} solves, {sum(s.outer for s in run.solves)} outer "
          f"iterations in {run.window_s!r} s", file=sys.stderr)
    if args.trace:
        for r, got in enumerate(run.traced.get("ranks", [run.traced])):
            print(f"traced rank {r}: {got['outers']} outer iterations, device busy "
                  f"{got['busy_s']!r} s of {got['window_s']!r} s", file=sys.stderr)
    for k, c in run.checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        # a world's teardown can hold the interpreter's exit for minutes
        # after a failure: the traceback, then out at once
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.exit(code)
