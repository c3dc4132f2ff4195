"""Calibration — fit event-sim delay models and replay cost models from
measured device traces, with a goodness-of-fit report (the port's copy of
the JAX package's ``sim/calibrate.py``; pure numpy).

Two fits close the measurement → simulation loop:

* ``fit_delay_model`` — fit an ``async_engine.DelayModel`` to a sample of
  measured durations (repeated timed executions of the same compiled
  program — a device loop that runs whole admits no per-step timestamps, so
  the honest sampling unit is the whole short program).  Lognormal fit is
  moment matching in log space (median = exp(mean log), dispersion =
  std log — exactly the parameterisation ``DelayModel`` samples with);
  goodness of fit is a Kolmogorov–Smirnov statistic against the fitted
  CDF.  No scipy on the image: the normal CDF runs on ``math.erf``.
* ``fit_cost_model`` — extract the ``sim.replay.CostModel`` constants from
  a measured schema trace: per-sweep compute cost from the run's wall and
  its sweep ledger, hop/extra-pass defaults as documented fractions when
  the trace cannot separate them (flagged in the returned report).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.trace import Trace
from repro_torch.sim.replay import CostModel

#: hop latency as a fraction of one sweep when no blocking trace pins it
DEFAULT_HOP_FRACTION = 0.05


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def ks_statistic(samples: np.ndarray, cdf) -> float:
    """Two-sided Kolmogorov–Smirnov distance between the empirical CDF of
    ``samples`` and a model ``cdf`` callable."""
    x = np.sort(np.asarray(samples, dtype=np.float64))
    n = x.size
    if n == 0:
        raise ValueError("no samples")
    F = np.asarray(cdf(x), dtype=np.float64)
    lo = np.max(F - np.arange(n) / n)
    hi = np.max((np.arange(n) + 1) / n - F)
    return float(max(lo, hi))


def fit_delay_model(samples: Sequence[float], dist: str = "lognormal",
                    floor: float = 1e-6,
                    alpha: float = 0.05) -> Tuple[object, Dict]:
    """Fit a ``DelayModel`` of family ``dist`` to measured durations.

    Returns ``(model, report)`` where ``report`` carries the fitted
    parameters, the KS statistic against the fitted CDF, the
    level-``alpha`` critical value ``c(alpha)/sqrt(n)`` (asymptotic,
    with the standard two-sided coefficient), and a boolean ``ok``.
    """
    from repro_torch.core.async_engine import DelayModel

    x = np.asarray(list(samples), dtype=np.float64)
    if x.size < 2:
        raise ValueError(f"need >= 2 samples to fit, got {x.size}")
    if (x <= 0).any():
        raise ValueError("durations must be > 0")

    if dist == "lognormal":
        logs = np.log(x)
        mu, sig = float(np.mean(logs)), float(np.std(logs))
        model = DelayModel(base=math.exp(mu), sigma=max(sig, 0.0),
                           floor=floor, dist="lognormal")
        if sig > 0:
            ks = ks_statistic(x, lambda v: _norm_cdf(
                (np.log(v) - mu) / sig))
        else:
            ks = ks_statistic(x, lambda v: (v >= math.exp(mu)).astype(float))
    elif dist == "fixed":
        base = float(np.median(x))
        model = DelayModel(base=base, sigma=0.0, floor=floor, dist="fixed")
        ks = ks_statistic(x, lambda v: (v >= base).astype(float))
    elif dist == "pareto":
        # DelayModel samples base·(1 + Pareto(shape)): support [base, ∞).
        base = float(np.min(x)) * (1.0 - 1e-12)
        ratio = np.log(x / base)
        shape = float(1.0 / max(np.mean(ratio), 1e-12))
        model = DelayModel(base=base, sigma=0.25, floor=floor,
                           dist="pareto", shape=shape)
        ks = ks_statistic(
            x, lambda v: 1.0 - np.power(np.maximum(v, base) / base, -shape))
    else:
        raise ValueError(f"dist {dist!r} not in ('lognormal', 'pareto', "
                         "'fixed')")

    n = x.size
    # asymptotic two-sided critical values: c(0.05)=1.358, c(0.01)=1.628
    c = {0.05: 1.358, 0.01: 1.628}.get(alpha, 1.358)
    crit = c / math.sqrt(n)
    report = {
        "dist": dist, "n": int(n), "base": float(model.base),
        "sigma": float(model.sigma), "shape": float(model.shape),
        "ks_statistic": float(ks), "ks_critical": float(crit),
        "alpha": float(alpha), "ok": bool(ks <= crit),
    }
    return model, report


def fit_cost_model(trace: Trace, hop_s: Optional[float] = None,
                   residual_pass_s: Optional[float] = None
                   ) -> Tuple[CostModel, Dict]:
    """Extract the replay cost constants from one measured schema trace.

    Inverts ``sim.replay.predict_wall``'s per-step structural model on the
    uniform-worker case: the measured step time decomposes into compute
    (``inner`` sweeps), the halo hop, and the recorded reduction's own
    synchronisation terms (extra residual pass + 2·ceil(log2 p)-hop
    allreduce for blocking, one partner hop for the butterfly, nothing for
    flat non-blocking).  With the defaults hop = 5% of a sweep and
    residual pass = one sweep, the decomposition is solved in closed form;
    a constant pinned by a second measurement is taken as given instead.
    The report flags which constants were measured and which defaulted,
    and a self-replay of the calibrating trace reproduces its wall
    exactly (up to run-to-run noise of the measurement itself).
    """
    meta = trace.meta
    p = trace.p
    wall = float(meta.get("wall_s", 0.0))
    outer = int(meta.get("outer_iters", 0))
    if wall <= 0 or outer <= 0:
        raise ValueError("trace has no measured wall/outer to calibrate from")
    inner = np.asarray(meta.get("inner_sweeps", 1), dtype=np.float64)
    max_inner = max(float(inner.max() if inner.ndim else inner), 1.0)
    step_s = wall / outer
    reduction = meta.get("reduction", "nonblocking")
    L2 = 2.0 * math.ceil(math.log2(p)) if p > 1 else 0.0
    delay = np.asarray(meta.get("halo_delay", 0), dtype=np.float64)
    min_delay = float(delay.min() if delay.ndim else delay)
    # a delayed neighbour view (delay >= 1) is already in flight when the
    # step starts, so its hop leaves the critical path
    halo_f = 1.0 if (p > 1 and min_delay == 0) else 0.0
    defaults = []
    f = DEFAULT_HOP_FRACTION
    if hop_s is None and residual_pass_s is None:
        # closed form: step = sweep·(inner + halo_f·f [+ mode terms])
        denom = max_inner + halo_f * f
        if reduction == "blocking":
            denom += 1.0 + L2 * f     # extra pass + allreduce
        elif reduction == "rdoubling" and p > 1:
            denom += f                # one partner hop per round
        sweep_s = step_s / denom
        hop_s = f * sweep_s
        residual_pass_s = sweep_s
        defaults += ["hop_s", "residual_pass_s"]
    else:
        if hop_s is None:
            hop_s = f * step_s / max_inner
            defaults.append("hop_s")
        if residual_pass_s is None:
            residual_pass_s = step_s / max_inner
            defaults.append("residual_pass_s")
        sync = halo_f * hop_s
        if reduction == "blocking":
            sync += residual_pass_s + L2 * hop_s
        elif reduction == "rdoubling" and p > 1:
            sync += hop_s
        sweep_s = max(step_s - sync, 1e-12) / max_inner
    rho = _per_worker_rates(trace, p)
    spw = None if rho is None else tuple(float(sweep_s) * rho)
    cost = CostModel(sweep_s=float(sweep_s), hop_s=float(hop_s),
                     residual_pass_s=float(residual_pass_s), p_ref=p,
                     sweep_s_per_worker=spw)
    report = {
        "p_ref": p, "reduction": reduction, "wall_s": wall, "outer": outer,
        "sweep_s": cost.sweep_s, "hop_s": cost.hop_s,
        "residual_pass_s": cost.residual_pass_s,
        "sweep_s_per_worker": (None if spw is None else list(spw)),
        "worker_rate_ratio": (None if rho is None else list(rho)),
        "defaulted": defaults,
    }
    return cost, report


def _per_worker_rates(trace: Trace, p: int) -> Optional[np.ndarray]:
    """Relative per-worker sweep rates from the trace's sweep-event gaps.

    For each worker the mean gap between its consecutive sweep events is
    its empirical per-step cost; normalising by the cross-worker mean gives
    unit-mean ratios ``ρ_w`` so ``sweep_s · ρ_w`` decomposes the fitted
    aggregate cost per worker (``CostModel.sweep_s_per_worker``).  Returns
    None when the trace carries no per-worker skew to fit — fewer than two
    sweep events for some worker, or uniform gaps (device traces timestamp
    all workers on one interpolated clock, so their skew is unresolvable
    by construction and the scalar model is the honest one).
    """
    gaps = np.full(p, np.nan)
    for w in range(p):
        ts = np.asarray(sorted(
            e["t"] for e in trace.events
            if e["kind"] == "sweep" and e["w"] == w), dtype=np.float64)
        if ts.size >= 2:
            d = np.diff(ts)
            d = d[d > 0]
            if d.size:
                gaps[w] = float(np.mean(d))
    if not np.isfinite(gaps).all() or gaps.size == 0:
        return None
    rho = gaps / gaps.mean()
    if np.allclose(rho, 1.0, rtol=1e-9, atol=1e-12):
        return None
    return rho


def engine_config_from_fit(model, hop_latency: Optional[float] = None):
    """Transfer a fitted compute ``DelayModel`` into an event-sim
    ``EngineConfig`` (channel defaults to the compute model scaled by the
    documented hop fraction unless pinned)."""
    import dataclasses

    from repro_torch.core.async_engine import EngineConfig

    chan = dataclasses.replace(
        model, base=max(model.base * DEFAULT_HOP_FRACTION, model.floor))
    cfg = EngineConfig(compute=model, channel=chan)
    if hop_latency is not None:
        cfg = dataclasses.replace(cfg, hop_latency=float(hop_latency))
    return cfg
