"""The port's spans and counters (``repro_torch/core/spans.py``) in the
shard runtimes, on the CPU.

Off (no profiler, no recorder) a span is the shared null context and the
hot path makes no ``record_function`` call; under ``torch.profiler`` the
loop's phases lie in the trace as nested ``user_annotation`` events on the
thread of their aten operators; under a recorder self time is duration
less child time, the ghost-assembly bytes and the host reads are counted
exactly, and every result is bitwise the untraced run's."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import detection, spans
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.solvers.convdiff import Stencil

N = 16
LOOP = ("shard.outer", "shard.sweeps", "shard.exchange", "shard.reduce", "shard.decide",
        "shard.sync")


def _convdiff(mode="pfait", reduction="nonblocking", p=4, sweep="jacobi", max_outer=500):
    st = Stencil.for_contraction(N, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode(mode, eps_tilde=1e-6, margin=10.0, ord=2.0,
                             staleness=0 if reduction == "blocking" else 2)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, inner_sweeps=3,
                                 sweep=sweep, max_outer=max_outer, trace_len=500)
    b = np.random.default_rng(0).standard_normal((N, N, N))
    run = tsr.make_convdiff_runtime(cfg, p, st, N, device="cpu")
    return lambda: run(np.zeros_like(b), b)


def _pagerank(p=4, n=64):
    mon = detection.for_mode("pfait", eps_tilde=1e-9, margin=10.0, ord=1.0, staleness=2)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, inner_sweeps=2, max_outer=500, trace_len=500)
    P = torch.rand((n, n), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    P /= P.sum(0)
    run = tsr.make_pagerank_runtime(cfg, p, n, device="cpu")
    return lambda: run(torch.full((n,), 1.0 / n, dtype=torch.float64), P)


def _same(a, b) -> None:
    assert a.outer_iters == b.outer_iters and a.converged == b.converged
    assert a.verifications == b.verifications
    assert torch.equal(a.x, b.x) and torch.equal(a.trace, b.trace)
    assert torch.equal(a.residual, b.residual)


def test_off_a_span_is_the_shared_null_context_and_nothing_counts(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: calls.append(name))
    assert spans.span("shard.outer") is spans.span("shard.sweeps")
    assert not spans.counting()
    spans.count("ghost_bytes", 5)    # no recorder: nothing to add to
    res = _convdiff()()
    assert res.converged and calls == []
    with spans.recording() as rec:
        pass
    assert rec.counts == {} and rec.records == []


def test_recorder_self_time_is_duration_less_children_on_a_fake_clock():
    ticks = iter(range(0, 10_000, 10))
    with spans.recording(clock=lambda: next(ticks)) as rec:
        with spans.span("shard.solve"):            # 0 .. 70
            with spans.span("shard.outer"):        # 10 .. 40
                with spans.span("shard.sweeps"):   # 20 .. 30
                    pass
            with spans.span("shard.outer"):        # 50 .. 60
                pass
        with spans.span("shard.solve"):            # 80 .. 90: a second root
            pass
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass
    tot = rec.totals()
    assert tot["shard.solve"] == {"count": 2, "seconds": 80e-9,
                                  "self_seconds": pytest.approx(40e-9)}
    assert tot["shard.outer"] == {"count": 2, "seconds": 40e-9,
                                  "self_seconds": pytest.approx(30e-9)}
    assert tot["shard.sweeps"]["self_seconds"] == pytest.approx(10e-9)
    assert [(r.name, r.parent, r.seq) for r in rec.records] == [
        ("shard.solve", -1, 0), ("shard.outer", 0, 0), ("shard.sweeps", 1, 0),
        ("shard.outer", 0, 0), ("shard.solve", -1, 1)]
    assert not spans.counting()


def test_profiler_sees_the_loop_phases_as_nested_annotations_on_the_ops_thread(tmp_path):
    run = _convdiff(mode="sync", reduction="blocking", max_outer=3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = run()
    assert res.outer_iters == 3
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ann = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"].startswith("shard.")]
    names = [e["name"] for e in ann]
    assert {"shard.solve", "shard.result", "shard.exact", *LOOP} == set(names)
    assert names.count("shard.outer") == 3 and names.count("shard.solve") == 1
    (solve,) = [e for e in ann if e["name"] == "shard.solve"]

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    outers = [e for e in ann if e["name"] == "shard.outer"]
    assert all(inside(e, solve) for e in ann)
    assert all(any(inside(e, o) for o in outers) for e in ann
               if e["name"] in LOOP[1:] + ("shard.exact",))
    sweeps = [e for e in ann if e["name"] == "shard.sweeps"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and any(inside(e, s) for s in sweeps)]
    assert ops and {e["tid"] for e in ops} == {e["tid"] for e in ann} == {solve["tid"]}


def _ghosted6_bytes(block) -> int:
    bx, by, bz = block
    return 8 * ((bx + 2) * (by + 2) * (bz + 2) + bx * by * bz
                + 2 * (by * bz + bx * bz + bx * by))


# (runtime, assemblies a shard an outer iteration, bytes an assembly,
# host reads a check, shards).  The sweeps and residual passes go through
# the halo ops, whose plain version on the CPU assembles through ghosted6;
# on the card they assemble nothing
CASES = {
    "pfait": (lambda: _convdiff(), 3, _ghosted6_bytes((4, N, N)), 1, 4),
    "blocking": (lambda: _convdiff(mode="sync", reduction="blocking"), 4,
                 _ghosted6_bytes((4, N, N)), 1, 4),
    "nfais2": (lambda: _convdiff(mode="nfais2"), 3, _ghosted6_bytes((4, N, N)), 2, 4),
    "hybrid": (lambda: _convdiff(sweep="hybrid"), 3, _ghosted6_bytes((4, N, N)), 1, 4),
    # the mesh runtime's plain halo sweeps assemble through ghosted6
    "mesh": (lambda: _convdiff(p=(2, 2)), 3, _ghosted6_bytes((8, 8, N)), 1, 4),
    "pagerank": (lambda: _pagerank(), 0, 0, 1, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_are_exact_and_results_bitwise_the_untraced_run(case):
    make, assemblies, nbytes, reads, p = CASES[case]
    run = make()
    off = run()
    with spans.recording() as rec:
        on = run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = run()
    _same(off, on)
    _same(off, profiled)
    k = on.outer_iters
    assert on.converged and 2 < k < 500
    # a check reads converged (NFAIS2 also its candidate flag); the result
    # reads converged and the verification count
    assert rec.counts["host_syncs"] == reads * k + 2
    # NFAIS2's verification assembles each shard once more
    assert rec.counts["ghost_bytes"] == p * (k * assemblies + on.verifications) * nbytes
    tot = rec.totals()
    assert set(tot) <= set(spans.NAMES) and set(rec.counts) <= set(spans.COUNTERS)
    assert tot["shard.solve"]["count"] == tot["shard.result"]["count"] == 1
    assert all(tot[name]["count"] == k for name in LOOP)
    assert {r.seq for r in rec.records} == {0}
    assert tot["shard.solve"]["seconds"] >= tot["shard.outer"]["seconds"] \
        >= tot["shard.sync"]["seconds"]
