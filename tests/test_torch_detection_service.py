"""The port's detection service (``launch/serve.py``) on the CPU: every
contract of the JAX package's ``tests/test_serve.py``, and the JAX
``serve_detection`` against the port's on one seeded schedule.

The parity anchor: a tenant served through the packed lanes reaches the
same verdict (detect step, detected residual bits) as a solo
``detection.batched_monitor`` run over its recorded series — padding ring
slots are never read, and ``reset_lanes`` is ``torch.where`` on every
field.  Against JAX, the seeded schedule over the three families must give
equal statuses, ticks, served/rejected/shed counts and per-tenant detect
steps.  The test first asserts that the two packages' series of each
tenant agree within rtol 2e-5 plus the family's f32 rounding scale, and
that at every check up to its detection the tenant's thresholds sit further
from its series than the two series differ, so equality is what the
precision predicts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.launch import serve as jserve
from repro_torch.core import detection
from repro_torch.launch.serve import (
    DetectionService,
    ServeConfig,
    TenantSpec,
    _percentiles,
    make_serve_problem,
    serve_detection,
    signature_key,
    signature_of,
)

CFG = ServeConfig(lanes=4, chunk=16, max_steps=1024, max_staleness=8)
CPU = "cpu"


def spec(tenant="t0", family="convdiff", eps_tilde=1e-4, mode="pfait",
         K=2, m=4, seed=0, **problem):
    problem = problem or {"n": 8, "p": 4, "rho": 0.9}
    return TenantSpec(tenant=tenant, family=family, problem=problem,
                      seed=seed, eps_tilde=eps_tilde, mode=mode,
                      staleness=K, persistence=m)


def serve_specs(specs, cfg=CFG, arrivals=None):
    reqs = [(s, 0 if arrivals is None else arrivals[i]) for i, s in enumerate(specs)]
    return serve_detection(reqs, cfg, device=CPU)


def tenant_reports(rep):
    return {t.tenant: t for t in rep.tenants}


# ---------------------------------------------------------------------------
# parity vs solo batched_monitor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["pfait", "nfais5", "sync", "nfais2"])
def test_packed_verdict_matches_solo_monitor(mode):
    """A packed tenant's (detect_step, residual) is bitwise what a solo
    batched_monitor gives on its series, which is bitwise the series of
    the tenant's problem stepped alone."""
    eps_tilde = 1e-4
    K = 0 if mode == "sync" else 3
    specs = [spec(f"t{i}", mode=mode, eps_tilde=eps_tilde, K=K, seed=i) for i in range(3)]
    rep = serve_specs(specs)
    mon = detection.for_mode(mode, eps_tilde)
    for t in rep.tenants:
        assert t.status == "served", t
        pr = make_serve_problem(t.family, seed=int(t.tenant[1:]), **dict(specs[0].problem))
        x0 = torch.tensor(pr.lane_x0()[None])
        ops = {k: torch.tensor(np.asarray(v)[None]) for k, v in pr.lane_operands().items()}
        series = detection.contribution_series(
            lambda X: pr.update_with_residual_batched(X, **ops), x0, t.steps)
        assert torch.equal(series[0], torch.tensor(t.series))
        v = detection.batched_monitor(mode, series, [mon.eps], [K], [4], ord=float(pr.ord),
                                      eps_tilde=[eps_tilde], device="cpu")
        assert bool(v.converged[0, 0, 0, 0])
        assert int(v.detect_step[0, 0, 0, 0]) == t.detect_step
        got = np.float32(v.detected_residual[0, 0, 0, 0].item())
        assert got.tobytes() == np.float32(t.detected_residual).tobytes()


def test_retire_refill_preserves_later_tenant_verdicts():
    """More tenants than lanes: later tenants ride recycled lanes and get
    the verdict they get when served alone."""
    cfg = ServeConfig(lanes=2, chunk=16, max_steps=1024)
    specs = [spec(f"t{i}", eps_tilde=(1e-3 if i % 2 else 1e-4), seed=i) for i in range(6)]
    packed = tenant_reports(serve_specs(specs, cfg))
    for s in specs:
        solo = tenant_reports(serve_specs([s], cfg))[s.tenant]
        assert packed[s.tenant].status == solo.status == "served"
        assert packed[s.tenant].detect_step == solo.detect_step
        assert packed[s.tenant].detected_residual == solo.detected_residual
        np.testing.assert_array_equal(packed[s.tenant].series, solo.series)


def test_mixed_eps_lanes_detect_at_different_steps():
    """Lanes with different ε̃ in ONE bucket fire at different steps."""
    rep = tenant_reports(serve_specs([spec("loose", eps_tilde=1e-3),
                                      spec("tight", eps_tilde=1e-5)]))
    assert rep["loose"].status == rep["tight"].status == "served"
    assert rep["loose"].detect_step < rep["tight"].detect_step
    assert rep["loose"].signature == rep["tight"].signature


def test_padding_lanes_inert():
    """One tenant in a 4-lane bucket: the 3 padding lanes never converge
    and produce no reports."""
    rep = serve_specs([spec("only")])
    assert rep.served == 1 and len(rep.tenants) == 1
    assert rep.false_detections == 0


def test_mixed_families_and_zero_false_detections():
    specs = [
        spec("cd", family="convdiff", eps_tilde=1e-4, n=8, p=4, rho=0.9),
        spec("pr", family="pagerank", eps_tilde=1e-6, n=64, p=4),
        spec("ml", family="mlfixed", eps_tilde=1e-4, n=16, p=4, m_rows=48, cond=10.0),
    ]
    rep = serve_specs(specs)
    assert rep.served == 3
    assert rep.false_detections == 0
    assert sorted(t.family for t in rep.tenants) == ["convdiff", "mlfixed", "pagerank"]
    for t in rep.tenants:
        assert t.oracle_step is not None and t.oracle_step <= t.steps


# ---------------------------------------------------------------------------
# warm-runner sharing
# ---------------------------------------------------------------------------


def test_warm_cache_hit_on_signature_identical_tenants():
    """Signature-identical tenants (different seed/ε̃) share one runner."""
    svc = DetectionService(CFG, device=CPU)
    for i in range(6):
        out = svc.submit(spec(f"t{i}", seed=i, eps_tilde=(1e-3, 1e-4)[i % 2]))
        assert out["admitted"]
    svc.run()
    rep = svc.report()
    assert rep.served == 6
    assert rep.compile_count == 1          # one signature, one runner
    assert rep.warm_hits >= 2              # refills rode the live runner


def test_distinct_signatures_compile_separately():
    svc = DetectionService(CFG, device=CPU)
    svc.submit(spec("a", family="convdiff"))
    svc.submit(spec("b", family="pagerank", eps_tilde=1e-6, n=64, p=4))
    svc.submit(spec("c", family="convdiff", mode="nfais5"))
    svc.run()
    rep = svc.report()
    assert rep.served == 3
    assert rep.compile_count == 3


def test_signature_key_ignores_seed_and_eps():
    a = spec("a", seed=0, eps_tilde=1e-3)
    b = spec("b", seed=7, eps_tilde=1e-5, K=5, m=2)
    assert signature_key(signature_of(a, CFG)) == signature_key(signature_of(b, CFG))
    c = spec("c", mode="nfais5")
    assert signature_key(signature_of(a, CFG)) != signature_key(signature_of(c, CFG))


# ---------------------------------------------------------------------------
# admission + shutdown/drain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad,code", [
    (dict(family="heat"), "unknown_family"),
    (dict(mode="magic"), "unknown_mode"),
    (dict(eps_tilde=-1.0), "bad_eps"),
    (dict(eps_tilde=float("nan")), "bad_eps"),
    (dict(K=99), "bad_staleness"),
    (dict(m=0), "bad_persistence"),
    (dict(n=7, p=4, rho=0.9), "problem_invalid"),   # 7 % 4 != 0
])
def test_admission_rejects_structured(bad, code):
    svc = DetectionService(CFG, device=CPU)
    out = svc.submit(spec("bad", **bad))
    assert out["admitted"] is False
    assert out["error"] == code
    assert out["reason"]
    rep = svc.report()
    assert rep.rejected == 1
    assert rep.tenants[0].status == "rejected"
    assert rep.tenants[0].error == code


def test_bad_margin_is_rejected():
    svc = DetectionService(CFG, device=CPU)
    out = svc.submit(TenantSpec(tenant="m", family="convdiff",
                                problem={"n": 8, "p": 4, "rho": 0.9}, margin=0.5))
    assert out["error"] == "bad_margin"


def test_rejected_tenant_never_blocks_valid_ones():
    svc = DetectionService(CFG, device=CPU)
    svc.submit(spec("bad", family="heat"))
    svc.submit(spec("good"))
    svc.run()
    rep = svc.report()
    assert rep.served == 1 and rep.rejected == 1


def test_shutdown_drains_inflight_and_sheds_queued():
    """In-flight lanes complete and report on shutdown; tenants still in
    the admission queue are shed with a structured status."""
    cfg = ServeConfig(lanes=1, chunk=16, max_steps=1024)
    svc = DetectionService(cfg, device=CPU)
    for i in range(3):        # 1 lane: t1/t2 queue behind t0
        svc.submit(spec(f"t{i}", seed=i))
    svc.step_tick()           # t0 packed and in flight
    svc.shutdown(drain=True)
    rep = tenant_reports(svc.report())
    assert rep["t0"].status == "served"
    assert {rep["t1"].status, rep["t2"].status} == {"shed"}
    assert rep["t1"].error == "shutdown"


def test_submit_after_shutdown_is_shed():
    svc = DetectionService(CFG, device=CPU)
    svc.shutdown()
    out = svc.submit(spec("late"))
    assert out["admitted"] is False and out["error"] == "shutdown"
    assert svc.report().shed == 1


def test_timeout_when_the_budget_runs_out():
    cfg = ServeConfig(lanes=2, chunk=16, max_steps=32)
    rep = serve_specs([spec("slow", eps_tilde=1e-9)], cfg)
    (t,) = rep.tenants
    assert t.status == "timeout" and t.steps == 32 and t.detect_step is None
    assert rep.timeouts == 1 and not rep.converged


def test_open_loop_queue_wait_measured_from_arrival():
    """With 1 lane, the second tenant's queue wait spans the first's
    service time."""
    cfg = ServeConfig(lanes=1, chunk=16, max_steps=1024)
    rep = tenant_reports(serve_specs([spec("t0"), spec("t1", seed=1)], cfg, arrivals=[0, 0]))
    assert rep["t0"].queue_wait_ticks == 0
    assert rep["t1"].queue_wait_ticks > 0
    assert rep["t1"].ttd_ticks > rep["t0"].ttd_ticks


def test_report_percentiles_and_throughput():
    rep = serve_specs([spec(f"t{i}", seed=i) for i in range(4)])
    assert rep.served == 4 and rep.converged
    for q in ("p50", "p95", "p99"):
        assert q in rep.ttd_ticks and q in rep.queue_wait_ticks
    assert rep.throughput["tenants_per_tick"] > 0
    assert rep.throughput["lane_steps_per_s/convdiff"] > 0
    assert rep.ticks == rep.outer_iters > 0


def test_on_tick_runs_after_every_tick():
    seen = []
    rep = serve_detection([(spec("t0"), 0), (spec("t1", seed=1), 3)], CFG, device=CPU,
                          on_tick=lambda svc: seen.append(svc.tick_count))
    assert seen == list(range(1, rep.ticks + 1))


def test_wall_breakdown_sums_to_the_ticks_wall():
    svc = DetectionService(CFG, device=CPU)
    for i in range(3):
        svc.submit(spec(f"t{i}", seed=i))
    svc.run()
    parts = svc.wall_breakdown()
    assert set(parts) == {"pack", "capture", "chunks", "other"}
    assert parts["capture"] == 0.0           # the CPU runs its chunks eagerly
    assert abs(sum(parts.values()) - svc.report().wall_s) < 1e-9
    assert svc.wall_s == svc.report().wall_s


@pytest.mark.parametrize("xs", [[5], [3, 1, 2], list(range(1, 21)), [7, 7, 2, 9, 100, 4]])
def test_nearest_rank_percentiles_match_jax(xs):
    assert _percentiles(xs) == jserve._percentiles(xs)
    assert _percentiles([]) == {}


# ---------------------------------------------------------------------------
# the JAX service against the port's, one seeded schedule
# ---------------------------------------------------------------------------

#: (family, problem kwargs, ε̃ grid): the ε̃ grids sit well above each
#: family's f32 floor at these sizes
FAMILIES = (
    ("convdiff", {"n": 8, "p": 4, "rho": 0.9, "sweep": "jacobi"}, (1e-3, 1e-4)),
    ("pagerank", {"n": 64, "p": 4}, (1e-4, 1e-5)),
    ("mlfixed", {"n": 16, "p": 4, "m_rows": 48, "cond": 10.0}, (1e-2, 1e-3)),
)
MODES = ("pfait", "nfais5", "nfais2", "sync")
#: each family's absolute f32 rounding scale of a step's contribution (σ
#: applied), for the series' parity: convdiff l∞ 2·2^-24·(1 + (diag + Σ|c|)
#: / (diag − Σ|c|))·max|b| ≈ 2·2^-24·20·1.1 (the bound on |A x| of the
#: diagonally dominant stencil at ρ = 0.9); PageRank l1 4·2^-24·Σ(d·P|x| + v
#: + |x|) = 4·2^-24·2; mlfixed l2 1e-6, its f32 floor at n = 16
ROUNDING = {"convdiff": 2.5e-6, "pagerank": 4 * 2.0 ** -24 * 2, "mlfixed": 1e-6}
RTOL = 2e-5


def _schedule(tenants=12, rate=2.0, seed=0):
    """Seeded open-loop schedule (``bench_serve.poisson_requests``' draws):
    Poisson arrivals, families round-robin, modes / ε̃ / K / m seeded."""
    rng = np.random.default_rng(seed)
    arrivals = np.floor(np.cumsum(rng.exponential(1.0 / rate, tenants))).astype(int)
    out = []
    for i in range(tenants):
        family, problem, grid = FAMILIES[i % len(FAMILIES)]
        mode = MODES[int(rng.integers(0, len(MODES)))]
        kw = dict(tenant=f"t{i:02d}", family=family, problem=problem,
                  seed=int(rng.integers(0, 4)),
                  eps_tilde=float(grid[int(rng.integers(0, len(grid)))]), mode=mode,
                  staleness=int(rng.integers(0, 5)), persistence=int(rng.choice((2, 4))))
        out.append((kw, int(arrivals[i])))
    return out


def _jax_series(t, kw):
    """The tenant's contribution series from the JAX problem, alone, in f32."""
    pr = jserve.make_serve_problem(t.family, seed=kw["seed"], **kw["problem"])
    x0 = jnp.asarray(np.asarray(pr.lane_x0())[None], jnp.float32)
    ops = {k: jnp.asarray(np.asarray(v)[None], jnp.float32)
           for k, v in pr.lane_operands().items()}
    s = jdet.contribution_series(lambda X: pr.update_with_residual_batched(X, **ops), x0,
                                 t.steps)
    return np.asarray(s)[0]


def test_serve_detection_matches_jax_on_a_seeded_schedule():
    sched = _schedule()
    cfg_kw = dict(lanes=2, chunk=16, max_steps=1024)
    assert {kw["mode"] for kw, _ in sched} == set(MODES)
    got = serve_detection([(TenantSpec(**kw), a) for kw, a in sched], ServeConfig(**cfg_kw),
                          device=CPU)
    want = jserve.serve_detection([(jserve.TenantSpec(**kw), a) for kw, a in sched],
                                  jserve.ServeConfig(**cfg_kw))
    by_kw = {kw["tenant"]: kw for kw, _ in sched}
    # the premise: the two packages' series agree to rounding, and at every
    # check up to a tenant's detection its thresholds sit further from its
    # series than the two series differ, so both compare the same way
    for t in got.tenants:
        kw = by_kw[t.tenant]
        ord_ = float("inf") if t.family == "convdiff" else (1.0 if t.family == "pagerank"
                                                           else 2.0)
        mine = np.asarray(jserve._sigma_np(t.series, ord_))
        theirs = np.asarray(jserve._sigma_np(_jax_series(t, kw), ord_))
        gap = np.abs(mine - theirs)
        assert np.all(gap <= RTOL * np.abs(theirs) + ROUNDING[t.family]), t.tenant
        end = t.steps if t.detect_step is None else t.detect_step + 1
        eps = detection.for_mode(t.mode, t.eps_tilde).eps
        for thr in {np.float32(eps), np.float32(t.eps_tilde)}:
            assert np.all(np.abs(mine[:end] - thr) > gap[:end]), (t.tenant, float(thr))
    for f in ("served", "rejected", "shed", "timeouts", "false_detections", "ticks",
              "compile_count", "warm_hits"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.ttd_ticks == want.ttd_ticks and got.queue_wait_ticks == want.queue_wait_ticks
    mine = {t.tenant: t for t in got.tenants}
    for w in want.tenants:
        t = mine[w.tenant]
        for f in ("status", "detect_step", "steps", "admit_tick", "done_tick",
                  "oracle_step", "false_detection"):
            assert getattr(t, f) == getattr(w, f), (w.tenant, f)
    assert got.served == len(sched) and got.false_detections == 0
