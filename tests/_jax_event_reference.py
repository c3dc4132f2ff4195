"""The JAX package's event engine on ``chip_smoke.py`` phase 16(a)'s runs:
prints, for each run, the counters and virtual times that the script's
``EVENT_JAX`` holds the port to (they do not depend on the device).

    PYTHONPATH=src python tests/_jax_event_reference.py

The runs are ``benchmarks/common.py:run_cell``'s setup at the paper's
smaller grid: convdiff n = 150, ρ = 0.93, the hybrid sweep, l∞,
``stable_platform()``, seed 0, ``max_iters`` 60000; PFAIT at ε̃/10 = 1e-7,
NFAIS2 and NFAIS5 at ε̃ = 1e-6 on p = 50, and PFAIT again on p = 150.  Host
numpy, about a minute a run.
"""
import dataclasses
import sys
import time

from repro.core.async_engine import AsyncEngine, stable_platform
from repro.core.protocols import NFAIS2, NFAIS5, PFAIT
from repro.solvers.convdiff import ConvDiffProblem

RUNS = (("pfait", 1e-7, 50), ("nfais2", 1e-6, 50), ("nfais5", 1e-6, 50), ("pfait", 1e-7, 150))


def main() -> int:
    for proto, eps, p in RUNS:
        prob = ConvDiffProblem(n=150, p=p, rho=0.93, seed=0)
        cfg = dataclasses.replace(stable_platform(), seed=0, max_iters=60000)
        cls = {"pfait": PFAIT, "nfais2": NFAIS2, "nfais5": NFAIS5}[proto]
        eng = AsyncEngine(prob, cfg, cls(eps, ord=prob.ord))
        t0 = time.perf_counter()
        r = eng.run()
        print(repr(((proto, p), dict(
            sweeps=sum(eng.k), k_max=r.k_max, k_min=r.k_min, reductions=r.reductions,
            wtime=r.wtime, detect_time=r.detect_time, msg_counts=r.msg_counts,
            msg_bytes=r.msg_bytes, detected_residual=r.detected_residual,
            r_star=r.r_star))), f"# {time.perf_counter() - t0:.1f} s on the host")
    return 0


if __name__ == "__main__":
    sys.exit(main())
