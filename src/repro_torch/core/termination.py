"""Threshold calibration (paper §4.2) and oracle scoring of detections.

PFAIT has no correctness protocol: its safety comes from a *margin* between
the detection threshold ε and the desired precision ε̃, calibrated from the
observed stability of the platform.  The paper's recipe:

1. run the solver repeatedly on a small/cheap instance with ε = ε̃ and
   observe the distribution of final exact residuals r*;
2. compute the worst overshoot ratio ρ = max r* / ε;
3. pick the margin as the next power of ten ≥ ρ·s (safety factor s) —
   decade steps, because the paper found *intermediate* thresholds (4e-7)
   behave less predictably than decade thresholds (1e-7);
4. production runs use ε = ε̃ / margin.

Every detection is scored against an exact residual trace
(``oracle_detect_step``, ``detection_consistent``).  Host-only Python, a
copy of the JAX package's ``core/termination.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence


@dataclass(frozen=True)
class CalibrationReport:
    eps_probe: float
    residuals: tuple
    min_r: float
    max_r: float
    overshoot: float          # max r* / ε_probe
    margin: float             # recommended ε̃ / ε
    eps_production: float     # ε for the target ε̃


def calibrate_margin(
    solve: Callable[[float], float],
    eps_tilde: float,
    runs: int = 5,
    safety: float = 2.0,
) -> CalibrationReport:
    """Run ``solve(eps) -> final exact residual`` repeatedly at ε = ε̃ and
    derive the production threshold (decade-quantised margin)."""
    rs = [float(solve(eps_tilde)) for _ in range(runs)]
    max_r = max(rs)
    overshoot = max_r / eps_tilde
    margin = decade_margin(overshoot * safety)
    return CalibrationReport(
        eps_probe=eps_tilde,
        residuals=tuple(rs),
        min_r=min(rs),
        max_r=max_r,
        overshoot=overshoot,
        margin=margin,
        eps_production=eps_tilde / margin,
    )


def decade_margin(ratio: float) -> float:
    """Smallest power of ten ≥ ratio (and ≥ 1)."""
    if ratio <= 1.0:
        return 1.0
    return 10.0 ** math.ceil(math.log10(ratio))


def stability_band(residuals: Sequence[float], eps: float) -> tuple:
    """The paper's platform-stability summary: (min r*−ε, max r*−ε)."""
    rs = list(residuals)
    return (min(rs) - eps, max(rs) - eps)


def oracle_detect_step(residuals: Sequence[float], eps: float) -> Optional[int]:
    """First index where the exact residual trace crosses below ε — the
    step a synchronized evaluation would have stopped at — or None if it
    never does.  The ground truth a detection step is scored against."""
    for k, r in enumerate(residuals):
        if float(r) < eps:
            return k
    return None


def detection_consistent(
    detected_step: Optional[int],
    residuals: Sequence[float],
    eps: float,
    factor: float = 10.0,
) -> bool:
    """Decade-consistency of a detection against an exact residual trace:
    at the detected step the true residual was already within one decade
    of ε, ``r_exact[min(k, end)] < factor·ε``, and the oracle crossing
    exists at all (no false detection on a run that never converges)."""
    oracle = oracle_detect_step(residuals, eps)
    if oracle is None:
        return False
    if detected_step is None:
        return False
    k = min(int(detected_step), len(residuals) - 1)
    return float(residuals[k]) < factor * eps
