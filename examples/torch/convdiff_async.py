"""Asynchronous iterations + every detection protocol, event-faithful, on
the PyTorch port.

Reproduces the paper's experimental *methodology* end to end on the
port's event-level simulator (the twin of ``examples/convdiff_async.py``;
the engine decides on the host, the problem's blocks sweep on the card):

  1. platform-stability probe at ε = ε̃ (paper §4.2, Table 1),
  2. margin calibration from the observed overshoot (core/termination.py),
  3. production run at ε = ε̃/margin with the protocol head-to-head
     (Tables 4–5 structure: PFAIT fastest, guarantee restored).

Run:  PYTHONPATH=src python examples/torch/convdiff_async.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch._device import resolve_device
from repro_torch.core.async_engine import AsyncEngine, stable_platform
from repro_torch.core.protocols import NFAIS2, NFAIS5, PFAIT
from repro_torch.core.termination import calibrate_margin, stability_band
from repro_torch.solvers.convdiff import ConvDiffProblem

EPS_TILDE = 1e-6
N, P = 16, 8


def solve_once(protocol_cls, eps, seed, device, **kw):
    prob = ConvDiffProblem(n=N, p=P, rho=0.93, seed=seed, device=device)
    cfg = dataclasses.replace(stable_platform(), seed=seed, max_iters=60_000)
    eng = AsyncEngine(prob, cfg, protocol_cls(eps, ord=prob.ord, **kw))
    return eng.run()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args().device)

    # -- 1. stability probe -------------------------------------------------
    print("== stability probe: PFAIT at ε = ε̃ ==")
    rs = [solve_once(PFAIT, EPS_TILDE, seed, dev).r_star for seed in range(5)]
    lo, hi = stability_band(rs, EPS_TILDE)
    print(f"   r* band: ε{lo:+.1e} … ε{hi:+.1e}")

    # -- 2. margin calibration ---------------------------------------------
    seeds = iter(range(100, 200))
    rep = calibrate_margin(
        lambda eps: solve_once(PFAIT, eps, next(seeds), dev).r_star,
        EPS_TILDE, runs=5,
    )
    print(f"== calibration: overshoot {rep.overshoot:.2f}× → margin "
          f"{rep.margin:.0f} → production ε = {rep.eps_production:.1e} ==")

    # -- 3. production head-to-head ------------------------------------------
    print("== production: PFAIT(ε̃/margin) vs snapshot protocols(ε̃) ==")
    print(f"{'protocol':10s} {'r*':>10s} {'wtime':>8s} {'k_max':>6s} "
          f"{'msgs':>22s}")
    for name, cls, eps, kw in (
        ("pfait", PFAIT, rep.eps_production, {}),
        ("nfais2", NFAIS2, EPS_TILDE, {}),
        ("nfais5", NFAIS5, EPS_TILDE, {"m": 4}),
    ):
        r = solve_once(cls, eps, 7, dev, **kw)
        proto_msgs = {k: v for k, v in r.msg_counts.items() if k != "data"}
        print(f"{name:10s} {r.r_star:10.2e} {r.wtime:8.4f} {r.k_max:6d} "
              f"{str(proto_msgs):>22s}")
        assert r.r_star < EPS_TILDE

    print("\nall protocols meet ε̃; PFAIT does it with zero protocol messages.")


if __name__ == "__main__":
    main()
