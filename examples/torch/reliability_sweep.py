"""Reliability-lab quickstart on the PyTorch port: when does a detected
residual lie?

Sweeps a handful of adversarial platform scenarios over PFAIT (the paper's
protocol-free detection) and NFAIS2 (data-carrying snapshots) on both
problem families, scoring every run with the false/late-detection oracle
(the twin of ``examples/reliability_sweep.py``).  The punchline reproduces
the paper's reliability claim *and* its limits:

  * on stable/unstable/bursty platforms PFAIT's claim holds (overshoot
    within the ε-margin the paper calibrates),
  * under an interface blackout PFAIT confidently reports convergence
    while the true residual is orders of magnitude above ε — a false
    detection — whereas NFAIS2 refuses to fire.

Run:  PYTHONPATH=src python examples/torch/reliability_sweep.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch._device import resolve_device
from repro_torch.core.async_engine import PLATFORMS
from repro_torch.core.protocols import NFAIS2, PFAIT
from repro_torch.core.reliability import detection_report, platform_health, run_traced
from repro_torch.core.scenarios import standard_scenarios
from repro_torch.solvers.convdiff import ConvDiffProblem
from repro_torch.solvers.pagerank import PageRankProblem

BASE = 1e-3
SCENARIOS = ("stable", "burst", "straggler", "pause_resume", "blackout")


def problems(device):
    return {
        "convdiff": (lambda seed: ConvDiffProblem(n=12, p=4, rho=0.9, seed=seed,
                                                  device=device), 1e-6),
        "pagerank": (lambda seed: PageRankProblem(n=128, p=4, seed=seed, device=device),
                     1e-8),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the card")
    dev = resolve_device(ap.parse_args().device)
    specs = standard_scenarios(BASE)
    print(f"{'problem':9s} {'scenario':13s} {'protocol':8s} {'verdict':11s} "
          f"{'detected':>10s} {'true@detect':>11s} {'overshoot':>9s}")
    for pname, (mk, eps) in problems(dev).items():
        for sname in SCENARIOS:
            spec = specs[sname]
            for proto_name, proto_mk in (
                ("pfait", lambda pr: PFAIT(eps, ord=pr.ord)),
                ("nfais2", lambda pr: NFAIS2(eps, ord=pr.ord)),
            ):
                cfg = dataclasses.replace(
                    PLATFORMS[spec.platform](BASE), seed=0, max_iters=1500,
                    scenario=spec.scenario,
                )
                res, rec = run_traced(lambda: mk(0), cfg, proto_mk,
                                      residual_stride=25)
                rep = detection_report(rec, eps)
                verdict = ("FALSE-DETECT" if rep.false_detection
                           else "ok" if res.terminated else "undetected")
                print(f"{pname:9s} {sname:13s} {proto_name:8s} {verdict:11s} "
                      f"{rep.detected_residual:10.2e} "
                      f"{rep.true_at_detect:11.2e} {rep.overshoot:9.1f}")
            health = platform_health(rec, mk(0).p, BASE)
            if health.silent_workers or health.stragglers:
                print(f"{'':9s} {sname:13s} platform-health: "
                      f"silent={health.silent_workers} "
                      f"stragglers={health.stragglers}")

    print("\nPFAIT lies exactly where the platform starves its reductions of"
          "\nfresh interface data; the snapshot protocol goes silent instead.")


if __name__ == "__main__":
    main()
