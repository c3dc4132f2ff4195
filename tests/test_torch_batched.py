"""The port's batched monitor, lane lifecycle and batched problem steps
against the JAX package's.

* ``batched_monitor``: the same f32 series (numpy, from a seed) through
  JAX's and the port's, every mode, a (seed × ε × K × m) grid, ord 1, 2
  and ∞: converged, detect step, detected residual (its bits) and
  verifications equal; and equal to the port's per-run ``step`` loop.
* ``reset_lanes`` leaves untouched lanes bitwise; the lane runner's chunk
  (eager, on the CPU) is the step-by-step loop of problem step and check.
* The batched steps against JAX ``update_with_residual_batched`` in f32 at
  the sizes of ``tests/test_batched.py``, with shared (2-D / 3-D) and
  stacked per-lane operands: convdiff ``X_next`` and the l∞ contribution
  bitwise, l2 within rtol 2e-5 (summation order); PageRank states within
  rtol 1e-5 and contributions within 2e-5.  Convdiff at ord 1 is held to
  the exact Σ|b − A x| (JAX's batched step returns Σr² for every finite
  order), within 2e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.solvers.convdiff import ConvDiffProblem as JConvDiff
from repro.solvers.pagerank import PageRankProblem as JPageRank
from repro_torch.core import detection as tdet
from repro_torch.solvers.convdiff import ConvDiffProblem
from repro_torch.solvers.pagerank import PageRankProblem

INF = float("inf")
EPS_GRID = [3e-3, 1e-4]
K_GRID = [0, 1, 3]
M_GRID = [1, 2, 4]
F32_L1_PAGERANK = 4 * 2.0 ** -24 * 2


def _series(S=3, T=160, seed=0):
    """Decaying contribution series with noise, crossing ε a few times."""
    rng = np.random.default_rng(seed)
    base = np.exp(-0.06 * np.arange(T))[None, :]
    noise = 1.0 + 0.5 * rng.random((S, T))
    return (base * noise * 1e-1).astype(np.float32)


def _assert_verdicts_equal(got, want):
    for field in ("converged", "detect_step", "verifications"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    a = np.asarray(got.detected_residual, dtype=np.float32)
    b = np.asarray(want.detected_residual, dtype=np.float32)
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("ord", [INF, 2.0, 1.0])
@pytest.mark.parametrize("mode", tdet.MODES)
def test_batched_monitor_bitwise_matches_jax(mode, ord):
    contribs = _series(seed=int(np.isinf(ord)) + int(ord == 2.0))
    # an ε̃ grid of its own, so NFAIS2's verification is exercised apart from ε
    epst = [5e-3, 2e-4]
    want = jdet.batched_monitor(mode, contribs, EPS_GRID, K_GRID, M_GRID, ord=ord,
                                eps_tilde=epst)
    got = tdet.batched_monitor(mode, contribs, EPS_GRID, K_GRID, M_GRID, ord=ord,
                               eps_tilde=epst, device="cpu")
    assert tuple(got.converged.shape) == (3, 2, 3, 3)
    assert bool(np.asarray(want.converged).any())
    _assert_verdicts_equal(got, want)


@pytest.mark.parametrize("ord", [INF, 2.0, 1.0])
@pytest.mark.parametrize("mode", tdet.MODES)
def test_batched_monitor_bitwise_matches_per_run_loop(mode, ord):
    contribs = _series(S=2, T=140, seed=7)
    v = tdet.batched_monitor(mode, contribs, EPS_GRID, K_GRID, M_GRID, ord=ord, device="cpu")
    for si in range(contribs.shape[0]):
        for ei, eps in enumerate(EPS_GRID):
            for ki, K in enumerate(K_GRID):
                for mi, m in enumerate(M_GRID):
                    cfg = tdet.MonitorConfig(mode=mode, eps=float(eps), eps_tilde=float(eps),
                                             staleness=K, persistence=m, ord=ord)
                    st = tdet.init_state(cfg, "cpu")
                    fired = -1
                    for t, c in enumerate(contribs[si]):
                        st = tdet.step(cfg, st, torch.tensor(c))
                        if fired < 0 and bool(st.converged):
                            fired = t
                    lane = (si, ei, ki, mi)
                    assert bool(v.converged[lane]) == bool(st.converged), lane
                    assert int(v.detect_step[lane]) == fired, lane
                    assert int(v.verifications[lane]) == int(st.verifications), lane
                    a = np.float32(v.detected_residual[lane].item())
                    b = np.float32(st.detected_residual.item())
                    assert a.tobytes() == b.tobytes(), (lane, a, b)


def test_sync_mode_forces_zero_staleness_lanes():
    contribs = _series(S=1, T=80, seed=1)
    v = tdet.batched_monitor("sync", contribs, [3e-3], [0, 2, 5], [1], ord=INF, device="cpu")
    assert np.unique(v.detect_step.numpy()).size == 1
    assert int(v.detect_step.reshape(-1)[0]) >= 0


def test_batched_monitor_rejects_bad_grids():
    with pytest.raises(ValueError, match="mode"):
        tdet.batched_monitor("magic", _series(), [1e-3], [0], [1], device="cpu")
    with pytest.raises(ValueError, match="eps_tilde"):
        tdet.batched_monitor("pfait", _series(), [1e-3, 1e-4], [0], [1], eps_tilde=[1e-3],
                             device="cpu")


def _random_lanes(L=5, ring=4, steps=9, seed=0):
    """Lane states advanced through random checks, with mixed parameters."""
    rng = np.random.default_rng(seed)
    st = tdet.init_lanes(L, ring, "cpu")
    eps = torch.tensor(rng.uniform(1e-3, 1e-2, L), dtype=torch.float32)
    K = torch.tensor(rng.integers(0, ring, L), dtype=torch.int32)
    m = torch.tensor(rng.integers(1, 3, L), dtype=torch.int32)
    for _ in range(steps):
        g = torch.tensor(rng.uniform(0, 2e-2, L), dtype=torch.float32)
        st = tdet.lane_step_batched("nfais5", st, g, eps, eps, K, m)
    return st


def test_reset_lanes_leaves_untouched_lanes_bitwise():
    st = _random_lanes()
    mask = np.array([False, True, False, False, True])
    out = tdet.reset_lanes(st, mask)
    fresh = tdet.init_lanes(5, 4, "cpu")
    for name, old, new, f in zip(st._fields, st, out, fresh):
        assert new.shape == old.shape and new.dtype == old.dtype, name
        assert torch.equal(new[~torch.from_numpy(mask)], old[~torch.from_numpy(mask)]), name
        assert torch.equal(new[torch.from_numpy(mask)], f[torch.from_numpy(mask)]), name
    assert torch.equal(tdet.reset_lanes(st, np.zeros(5, bool)).ring, st.ring)


def test_init_lanes_validates():
    with pytest.raises(ValueError):
        tdet.init_lanes(0, 3, "cpu")
    with pytest.raises(ValueError):
        tdet.make_lane_runner("pfait", lambda X, o: (X, X.sum(1)), 0)
    with pytest.raises(ValueError):
        tdet.make_lane_runner("magic", lambda X, o: (X, X.sum(1)), 4)


@pytest.mark.parametrize("mode", tdet.MODES)
def test_lane_runner_chunk_is_the_step_loop(mode):
    """One eager chunk: X and the lane state updated in place, and the raw
    series, equal to stepping the problem and the monitor by hand."""
    probs = [PageRankProblem(n=32, p=4, seed=s) for s in range(3)]
    P = torch.tensor(np.stack([p.lane_operands()["P"] for p in probs]))
    X = torch.tensor(np.stack([p.lane_x0() for p in probs]))
    eps = torch.tensor([1e-3, 1e-4, -1.0])
    K, m = torch.tensor([0, 2, 1], dtype=torch.int32), torch.tensor([1, 2, 1], dtype=torch.int32)
    state = tdet.init_lanes(3, 4, "cpu")
    run = tdet.make_lane_runner(mode, lambda Xc, o: probs[0].update_with_residual_batched(Xc, **o),
                                chunk=5, ord=1.0)
    Xw, sw, cols = X.clone(), tdet.init_lanes(3, 4, "cpu"), []
    for _ in range(2):
        for _ in range(5):
            Xw, c = probs[0].update_with_residual_batched(Xw, P=P)
            sw = tdet.lane_step_batched(mode, sw, tdet._sigma_lane(c, 1.0), eps, eps, K, m)
            cols.append(c)
        X_out, st_out, cs = run(X, {"P": P}, state, eps, eps, K, m)
        assert X_out is X and st_out is state
        assert torch.equal(cs, torch.stack(cols[-5:], dim=1))
    assert torch.equal(X, Xw)
    for a, b in zip(state, sw):
        assert torch.equal(a, b)
    assert not bool(state.converged[2])          # ε = −1: an inert lane


def test_contribution_series_matches_jax():
    jp, tp = JPageRank(n=64, p=1, seed=0), PageRankProblem(n=64, p=1, seed=0)
    P = tp.lane_operands()["P"]
    x0 = np.full((2, 64), 1.0 / 64, np.float32)
    want = jdet.contribution_series(
        lambda X: jp.update_with_residual_batched(X, P=jnp.asarray(P)), jnp.asarray(x0), 12)
    got = tdet.contribution_series(
        lambda X: tp.update_with_residual_batched(X, P=torch.tensor(P)), torch.tensor(x0), 12)
    assert tuple(got.shape) == (2, 12)
    # the two matvecs sum in different orders: rtol 2e-5, and near the fixed
    # point the l1 rounding scale of a step, 4·2^-24·Σ(d·P|x| + v + |x|) with
    # Σ(...) = 2 (x ≥ 0, Σx = 1, P column-stochastic)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=F32_L1_PAGERANK)


# ---------------------------------------------------------------------------
# batched problem steps vs JAX
# ---------------------------------------------------------------------------


def _exact_l1(jprob, X, b):
    """Σ|b − A x| per lane in f64, through the JAX package's numpy stencil."""
    out = []
    for x, bb in zip(X.astype(np.float64), b.astype(np.float64)):
        g = np.pad(x, 1)
        out.append(np.abs(jprob.st.residual_block(g, bb)).sum())
    return np.array(out)


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("ord", [INF, 2.0, 1.0])
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid"])
@pytest.mark.parametrize("n", [8, 12])
def test_convdiff_batched_step_matches_jax(n, sweep, ord, stacked):
    rng = np.random.default_rng(n + 3 * stacked)
    X = rng.standard_normal((3, n, n, n)).astype(np.float32)
    kw = dict(n=n, p=4, rho=0.9, sweep=sweep, ord=ord)
    jp, tp = JConvDiff(seed=1, **kw), ConvDiffProblem(seed=1, **kw)
    np.testing.assert_array_equal(tp.b_global, jp.b_global)
    if stacked:
        b = np.stack([ConvDiffProblem(seed=s, **kw).lane_operands()["b"] for s in range(3)])
    else:
        b = tp.lane_operands()["b"]
    jx, jc = jp.update_with_residual_batched(jnp.asarray(X), b=jnp.asarray(b))
    tx, tc = tp.update_with_residual_batched(torch.tensor(X), b=torch.tensor(b))
    assert tx.dtype == torch.float32 and jx.dtype == jnp.float32
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if np.isinf(ord):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    elif ord == 2.0:
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)
    else:
        bb = np.broadcast_to(b, X.shape)
        np.testing.assert_allclose(tc.numpy(), _exact_l1(jp, X, bb), rtol=2e-5)


def test_convdiff_problem_validates_like_jax():
    with pytest.raises(ValueError):
        JConvDiff(n=7, p=4)
    with pytest.raises(ValueError):
        ConvDiffProblem(n=7, p=4)
    with pytest.raises(ValueError, match="sweep"):
        ConvDiffProblem(n=8, p=4, sweep="sor")
    p = ConvDiffProblem(n=12, p=6, seed=2)
    q = JConvDiff(n=12, p=6, seed=2)
    assert (p.p, p.part.block) == (q.p, q.part.block)
    assert p.st == type(p.st)(*(getattr(q.st, f) for f in ("diag", "xm", "xp", "ym", "yp",
                                                           "zm", "zp")))
    np.testing.assert_array_equal(p.lane_x0(), q.lane_x0())
    np.testing.assert_array_equal(p.lane_operands()["b"], q.lane_operands()["b"])


@pytest.mark.parametrize("ord", [1.0, 2.0, INF])
@pytest.mark.parametrize("operator", ["2-D", "stacked"])
def test_pagerank_batched_step_matches_jax(ord, operator):
    rng = np.random.default_rng(5)
    jp, tp = JPageRank(n=64, p=4, seed=0, ord=ord), PageRankProblem(n=64, p=4, seed=0, ord=ord)
    X = (np.abs(rng.standard_normal((3, 64))) / 64).astype(np.float32)
    if operator == "2-D":
        P = tp.lane_operands()["P"]
    else:
        P = np.stack([PageRankProblem(n=64, p=4, seed=s).lane_operands()["P"]
                      for s in range(3)])
    np.testing.assert_array_equal(tp.lane_operands()["P"], jp.lane_operands()["P"])
    np.testing.assert_array_equal(tp.lane_x0(), jp.lane_x0())
    jy, jc = jp.update_with_residual_batched(jnp.asarray(X), P=jnp.asarray(P))
    ty, tc = tp.update_with_residual_batched(torch.tensor(X), P=torch.tensor(P))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)


def test_pagerank_batched_other_order_on_cpu():
    """ord 3 has no kernel mode: the CPU reduces it plainly, as JAX does."""
    jp, tp = JPageRank(n=64, p=4, seed=1, ord=3.0), PageRankProblem(n=64, p=4, seed=1, ord=3.0)
    X = np.full((2, 64), 1.0 / 64, np.float32)
    P = tp.lane_operands()["P"]
    _, jc = jp.update_with_residual_batched(jnp.asarray(X), P=jnp.asarray(P))
    _, tc = tp.update_with_residual_batched(torch.tensor(X), P=torch.tensor(P))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)

