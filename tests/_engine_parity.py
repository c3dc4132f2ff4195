"""Shared by the event-engine parity tests: one seeded run of the JAX
package's engine and one of the port's, and the comparison of the two.

A run is a pure function of the seed in both packages (one RNG stream,
the same draws), and the virtual clock does not depend on residual values,
so the sweep and send events, ``terminated``, ``detect_time``, ``wtime``,
``k_max``, ``k_min``, the message counts and bytes and ``reductions`` must
be equal.  Residuals differ by the port's f32 partials: r* and the detected
residual within rtol 1e-6 at l∞ (one f32 rounding) and 1e-5 at l2 and l1
(an f32 sum), plus the f64 floor of a residual near convergence: r is a
difference of terms of size S (convdiff: max|b| + (diag + Σ|a_k|)·max|x*|),
and two f64 evaluations in other orders part by a few units of 2^-53·S
per cell — 16·2^-53·S at l∞, √N and N times that at l2 and l1 (N cells).
At r ≈ 3.5e-10 and S ≈ 20 that is ≈ 3e-6 of r, above the f32 bar.  Should a
comparison with ε ever flip between the two, the event logs part where it
did, and the failure message gives the detected residuals' distance to ε.
"""
import dataclasses
import functools
import math

import numpy as np

from repro.core import async_engine as jeng
from repro.core import protocols as jproto
from repro.core import reliability as jrel
from repro.core import scenarios as jscen
from repro.solvers.convdiff import ConvDiffProblem as JCD
from repro.solvers.mlfixed import MLFixedPointProblem as JML
from repro.solvers.pagerank import PageRankProblem as JPR
from repro_torch.core import async_engine as teng
from repro_torch.core import protocols as tproto
from repro_torch.core import reliability as trel
from repro_torch.core import scenarios as tscen
from repro_torch.solvers.convdiff import ConvDiffProblem as TCD
from repro_torch.solvers.mlfixed import MLFixedPointProblem as TML
from repro_torch.solvers.pagerank import PageRankProblem as TPR

INF = float("inf")
RTOL = {INF: 1e-6, 2.0: 1e-5, 1.0: 1e-5}
BASE = 1e-3
PROTOCOLS = ("pfait", "nfais2", "nfais5", "rdub", "exact_snapshot")
PLATFORMS = ("stable", "unstable", "heavy_tail")

JAX = dict(eng=jeng, proto=jproto, rel=jrel, scen=jscen,
           convdiff=JCD, pagerank=JPR, mlfixed=JML)
PORT = dict(eng=teng, proto=tproto, rel=trel, scen=tscen,
            convdiff=lambda **kw: TCD(device="cpu", **kw),
            pagerank=lambda **kw: TPR(device="cpu", **kw),
            mlfixed=lambda **kw: TML(device="cpu", **kw))

#: each family's small problem and its ε (a few hundred sweeps a worker)
FAMILIES = {
    "convdiff": (dict(n=8, p=4, rho=0.9, seed=0), 1e-6),
    "pagerank": (dict(n=128, p=4, seed=0), 1e-9),
    "mlfixed": (dict(n=16, p=4, m_rows=64, seed=0), 1e-6),
}


#: the keywords of ``run`` that go to the problem (the rest go to ``config``)
_PROBLEM_KEYS = ("n", "p", "rho", "sweep", "ord", "task", "m_rows")


def config(pkg, platform="stable", scenario=None, seed=3, max_iters=600, fused=True,
           fifo=False):
    """``pkg``'s engine config: ``platform``'s preset at ``BASE``, with
    ``scenario`` — a name of ``scenario_registry`` — built in ``pkg``."""
    if scenario is not None:
        spec = pkg["scen"].scenario_registry(BASE)[scenario]
        platform, scenario = spec.platform, spec.scenario
    return dataclasses.replace(pkg["eng"].PLATFORMS[platform](BASE), seed=seed,
                               max_iters=max_iters, fused=fused, fifo=fifo,
                               scenario=scenario)


def run(pkg, family, proto, eps=None, stride=25, record_sends=True, m=4, **kw):
    """One traced run of ``pkg``'s engine: ``(RunResult, TraceRecorder,
    problem)``; ``kw`` goes to the family's problem and ``config``."""
    prob_kw, default_eps = FAMILIES[family]
    prob_kw = dict(prob_kw)
    for k in _PROBLEM_KEYS:
        if k in kw:
            prob_kw[k] = kw.pop(k)
    eps = default_eps if eps is None else eps
    kw.setdefault("fifo", proto == "exact_snapshot")
    cfg = config(pkg, **kw)
    made = []

    def make_problem():
        made.append(pkg[family](**prob_kw))
        return made[-1]

    def make_protocol(pr):
        cls = pkg["proto"].PROTOCOLS[proto]
        return cls(eps, ord=pr.ord, m=m) if proto == "nfais5" else cls(eps, ord=pr.ord)

    res, rec = pkg["rel"].run_traced(make_problem, cfg, make_protocol,
                                     residual_stride=stride, record_sends=record_sends)
    return res, rec, made[-1]


@functools.lru_cache(maxsize=None)
def f64_floor(family, items):
    """``{ord: floor}``: the f64 floor (module docstring) of the family's
    problem ``dict(items)`` in each norm, from its exact solution x*."""
    prob = JAX[family](**dict(items))
    x = np.abs(np.asarray(prob.solve_reference()))
    if family == "convdiff":
        st = prob.st
        off = sum(abs(c) for c in (st.xm, st.xp, st.ym, st.yp, st.zm, st.zp))
        scale = float(np.abs(prob.b_global).max() + (abs(st.diag) + off) * x.max())
    elif family == "pagerank":
        scale = float((prob.d * (prob.to_dense() @ x)).max() + prob.v + x.max())
    elif prob.task == "lstsq":
        scale = prob.gamma * float((np.abs(prob.H) @ x + np.abs(prob.c)).max())
    else:
        scale = prob.gamma * float(np.abs(prob.A).sum(0).max() / prob.m + prob.l2 * x.max())
    cell = 16 * 2.0 ** -53 * scale
    return {INF: cell, 2.0: math.sqrt(x.size) * cell, 1.0: x.size * cell}


def _near(got, want, ord, floor=0.0):
    if np.isinf(want) or want == 0.0:
        return got == want
    return abs(got - want) <= RTOL[float(ord)] * abs(want) + floor


def events_apart_from_floats(rec):
    """The recorder's events with the residual floats of the detect event
    left out (its time stays)."""
    return [e[:2] if e[0] == "detect" else e for e in rec.events]


def assert_same_run(a, ra, b, rb, ord, eps=None, floor=0.0):
    """The JAX run ``(a, ra)`` and the port's ``(b, rb)`` are the same run;
    residuals within the f32 bars plus ``floor`` (``f64_floor``)."""
    where = ""
    if eps is not None:
        where = (f" (detected {a.detected_residual!r} / {b.detected_residual!r}, "
                 f"distance to ε {abs(a.detected_residual - eps) / eps:.3e} relative)")
    assert rb.sweep_events() == ra.sweep_events(), "sweep events differ" + where
    assert events_apart_from_floats(rb) == events_apart_from_floats(ra), \
        "events differ" + where
    for f in ("terminated", "detect_time", "wtime", "k_max", "k_min", "msg_counts",
              "msg_bytes", "reductions", "protocol", "msg_dropped"):
        assert getattr(b, f) == getattr(a, f), f
    assert _near(b.r_star, a.r_star, ord, floor), (b.r_star, a.r_star)
    assert _near(b.detected_residual, a.detected_residual, ord, floor), \
        (b.detected_residual, a.detected_residual)
    assert len(rb.residual_samples) == len(ra.residual_samples)
    for (tb, vb), (ta, va) in zip(rb.residual_samples, ra.residual_samples):
        assert tb == ta and _near(vb, va, ord, floor), (tb, vb, va)
    for f in ("true_at_detect", "certified_at_detect", "active_at_detect"):
        va, vb = getattr(ra, f), getattr(rb, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert _near(vb, va, ord, floor), (f, vb, va)
    assert rb.claim == ra.claim and rb.membership == ra.membership
    assert rb.result is b


def parity(family, proto, ord=None, **kw):
    """Run ``family`` under ``proto`` in both packages and hold them equal;
    returns the two ``(RunResult, TraceRecorder, problem)`` triples."""
    if ord is not None:
        kw["ord"] = ord
    ja = run(JAX, family, proto, **dict(kw))
    tb = run(PORT, family, proto, **dict(kw))
    eps = kw.get("eps", FAMILIES[family][1])
    prob_kw = dict(FAMILIES[family][0])
    prob_kw.update((k, v) for k, v in kw.items() if k in _PROBLEM_KEYS)
    floor = f64_floor(family, tuple(sorted(prob_kw.items())))[float(ja[2].ord)]
    assert_same_run(ja[0], ja[1], tb[0], tb[1], ja[2].ord, eps=eps, floor=floor)
    return ja, tb

