"""The three problems' event-level methods in the port against the JAX
package's, on the CPU (``device="cpu"``), on random blocks and
dependencies drawn with numpy from a seed.

Bars: blocks (x) within rtol 1e-12 of the largest magnitude; contributions
and exact residuals within the f32 partials' bars — rtol 1e-6 at l∞ (one
f32 rounding of an f64 max) and 1e-5 at l2 and l1 (an f32 sum).  The JAX
package's host residuals are f64 throughout.

Covered: every method of ``ConvDiffProblem`` (hybrid and Jacobi, l∞ and l2,
an odd block offset, the stale face the fused path keeps for a missing
dependency against the zero face of the unfused path), of
``PageRankProblem`` (the packed product, the partial view, the empty
interface, l1 / l2 / l∞) and of ``MLFixedPointProblem`` (lstsq and
logistic, l1 / l2 / l∞, ``split``), and the reference fault at ord 1: the
JAX package's event contribution there is Σr², the port's the exact Σ|r|.
"""
import numpy as np
import pytest
import torch

from repro.solvers.convdiff import ConvDiffProblem as JCD
from repro.solvers.mlfixed import MLFixedPointProblem as JML
from repro.solvers.pagerank import PageRankProblem as JPR
from repro_torch.solvers.convdiff import ConvDiffProblem
from repro_torch.solvers.mlfixed import MLFixedPointProblem
from repro_torch.solvers.pagerank import PageRankProblem

INF = float("inf")
RTOL = {INF: 1e-6, 2.0: 1e-5, 1.0: 1e-5}


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _x_close(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def _r_close(got, want, ord):
    assert got == pytest.approx(want, rel=RTOL[float(ord)], abs=0.0)


def _views(j, t, xs, i, drop=()):
    """Dependency views of worker i in both packages, with ``drop`` left out."""
    jd = {k: j.interface(k, xs[k], i) for k in j.neighbors(i) if k not in drop}
    td = {k: t.interface(k, _t(xs[k]), i) for k in t.neighbors(i) if k not in drop}
    assert jd.keys() == td.keys()
    for k in jd:
        _x_close(td[k], jd[k])
        assert td[k].nbytes == jd[k].nbytes
    return jd, td


# ---------------------------------------------------------------------------
# ConvDiffProblem
# ---------------------------------------------------------------------------


def _convdiff(n, p, sweep, ord, seed=0):
    kw = dict(n=n, p=p, rho=0.9, seed=seed, sweep=sweep, ord=ord)
    return JCD(**kw), ConvDiffProblem(device="cpu", **kw)


def _blocks(j, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(j.init_local(i).shape) for i in range(j.p)]


@pytest.mark.parametrize("ord", [INF, 2.0])
@pytest.mark.parametrize("sweep", ["hybrid", "jacobi"])
@pytest.mark.parametrize("n,p", [(12, 4), (15, 3), (9, 9)])   # (15, 3), (9, 9): odd offsets
def test_convdiff_methods_match_jax(n, p, sweep, ord):
    j, t = _convdiff(n, p, sweep, ord, seed=n + p)
    assert t.p == j.p and all(t.neighbors(i) == j.neighbors(i) for i in range(j.p))
    for i in range(j.p):
        _x_close(t.init_local(i), j.init_local(i))
    xs = _blocks(j, seed=p)
    for i in range(j.p):
        jd, td = _views(j, t, xs, i)
        xi = _t(xs[i])
        _x_close(t.update(i, xi, td), j.update(i, xs[i], jd))
        _r_close(t.local_residual(i, xi, td), j.local_residual(i, xs[i], jd), ord)
        _r_close(t.local_residual_fast(i, xi, td), j.local_residual_fast(i, xs[i], jd), ord)
        jn, jr = j.update_with_residual(i, xs[i], jd)
        tn, tr = t.update_with_residual(i, xi, td)
        _x_close(tn, jn)
        _r_close(tr, jr, ord)
        tn, tr = t.update_with_residual(i, xi, td, need_residual=False)
        _x_close(tn, jn)
        assert tr is None
    _r_close(t.exact_residual([_t(x) for x in xs]), j.exact_residual(xs), ord)
    _x_close(t.assemble([_t(x) for x in xs]), j.assemble(xs))
    assert t.syncs == 3 * j.p + 1


def test_convdiff_odd_offset_phase():
    """(15, 3): blocks of 5 at x offsets 0, 5, 10 — the checkerboard phase of
    the middle block is odd; a wrong phase shows there."""
    j, t = _convdiff(15, 3, "hybrid", INF)
    assert [t._events().offsets[i] for i in range(3)] == [(0, 0), (5, 0), (10, 0)]
    xs = _blocks(j, seed=7)
    jd, td = _views(j, t, xs, 1)
    jn, _ = j.update_with_residual(1, xs[1], jd)
    tn, _ = t.update_with_residual(1, _t(xs[1]), td)
    _x_close(tn, jn)
    wrong = j.st.redblack_gs_sweep(
        j._ghosted(1, xs[1], jd), j._b[1], 0, 0)     # phase 0: the wrong colours
    assert np.abs(wrong - jn).max() > 1e-3 * np.abs(jn).max()


@pytest.mark.parametrize("sweep", ["hybrid", "jacobi"])
def test_convdiff_stale_face_and_zero_face(sweep):
    """The fused path keeps a neighbour's last face when its dependency is
    missing (a persistent buffer); the unfused path reads zero there."""
    j, t = _convdiff(12, 4, sweep, INF, seed=3)
    xs, ys = _blocks(j, seed=1), _blocks(j, seed=2)
    i = 0
    jd, td = _views(j, t, xs, i)
    j.update_with_residual(i, xs[i], jd)
    t.update_with_residual(i, _t(xs[i]), td)
    gone = j.neighbors(i)[0]
    jd2, td2 = _views(j, t, ys, i, drop=(gone,))
    jn, jr = j.update_with_residual(i, ys[i], jd2)
    tn, tr = t.update_with_residual(i, _t(ys[i]), td2)
    _x_close(tn, jn)
    _r_close(tr, jr, INF)
    _r_close(t.local_residual_fast(i, _t(ys[i]), td2), j.local_residual_fast(i, ys[i], jd2), INF)
    # unfused: the missing face is zero, which differs from the stale one
    ju = j.update(i, ys[i], jd2)
    _x_close(t.update(i, _t(ys[i]), td2), ju)
    _r_close(t.local_residual(i, _t(ys[i]), td2), j.local_residual(i, ys[i], jd2), INF)
    assert np.abs(ju - jn).max() > 0


def test_convdiff_solve_reference_matches_jax():
    j, t = _convdiff(8, 4, "hybrid", INF)
    _x_close(t.solve_reference(tol=1e-12), j.solve_reference(tol=1e-12))


def test_convdiff_ord1_reference_fault():
    """At ord 1 the JAX package's event contribution (and its exact
    residual) is Σr² and √Σr² — l2, not l1 (``convdiff.py:362-364,
    408-410``).  The port's is the exact Σ|b − Ax|."""
    j, t = _convdiff(12, 4, "hybrid", 1.0, seed=4)
    xs = _blocks(j, seed=5)
    i = 1
    jd, td = _views(j, t, xs, i)
    g = j._ghosted(i, xs[i], jd)
    r = j.st.residual_block(g, j._b[i])
    exact_l1 = float(np.abs(r).sum())
    _, jr = j.update_with_residual(i, xs[i], jd)
    _, tr = t.update_with_residual(i, _t(xs[i]), td)
    assert jr == pytest.approx(float(np.sum(r * r)), rel=1e-12)
    assert jr != pytest.approx(exact_l1, rel=1e-3)
    _r_close(tr, exact_l1, 1.0)
    _r_close(t.local_residual(i, _t(xs[i]), td), exact_l1, 1.0)
    _r_close(t.local_residual_fast(i, _t(xs[i]), td), exact_l1, 1.0)
    gg = np.zeros((14,) * 3)
    gg[1:-1, 1:-1, 1:-1] = j.assemble(xs)
    rg = j.st.residual_block(gg, j.b_global)
    _r_close(t.exact_residual([_t(x) for x in xs]), float(np.abs(rg).sum()), 1.0)
    assert j.exact_residual(xs) == pytest.approx(float(np.sqrt(np.sum(rg * rg))), rel=1e-12)


def test_convdiff_rejects_orders_without_a_kernel_mode():
    j, t = _convdiff(8, 4, "jacobi", 3.0)
    x = t.init_local(0)
    deps = {k: t.interface(k, t.init_local(k), 0) for k in t.neighbors(0)}
    with pytest.raises(ValueError, match="ord 1, 2 or inf"):
        t.update_with_residual(0, x, deps)


# ---------------------------------------------------------------------------
# PageRankProblem
# ---------------------------------------------------------------------------


def _pagerank_blocks(j, seed):
    rng = np.random.default_rng(seed)
    return [j.init_local(i) * (1.0 + 0.3 * rng.standard_normal(j.block)) for i in range(j.p)]


def test_pagerank_empty_interface():
    """Where block j never reads from block i the interface is empty (0
    bytes on the wire) in both packages."""
    j, t = JPR(n=64, p=16, seed=0), PageRankProblem(n=64, p=16, seed=0, device="cpu")
    xs = _pagerank_blocks(j, 0)
    empty = [(i, k) for i in range(16) for k in j.neighbors(i)
             if j.interface(k, xs[k], i).size == 0]
    assert len(empty) == 50
    for i, k in empty:
        got = t.interface(k, _t(xs[k]), i)
        assert got.numel() == 0 and got.nbytes == 0 and got.dtype == torch.float64


@pytest.mark.parametrize("ord", [1.0, 2.0, INF])
@pytest.mark.parametrize("n,p,seed", [(256, 4, 0), (64, 16, 0)])
def test_pagerank_methods_match_jax(n, p, seed, ord):
    kw = dict(n=n, p=p, ord=ord, seed=seed)
    j, t = JPR(**kw), PageRankProblem(device="cpu", **kw)
    xs = _pagerank_blocks(j, seed)
    for i in range(p):
        assert t.neighbors(i) == j.neighbors(i)
        _x_close(t.init_local(i), j.init_local(i))
        jd, td = _views(j, t, xs, i)
        xi = _t(xs[i])
        _x_close(t.update(i, xi, td), j.update(i, xs[i], jd))
        jn, jr = j.update_with_residual(i, xs[i], jd)
        tn, tr = t.update_with_residual(i, xi, td)
        _x_close(tn, jn)
        _r_close(tr, jr, ord)
        _r_close(t.local_residual(i, xi, td), j.local_residual(i, xs[i], jd), ord)
        assert t.update_with_residual(i, xi, td, need_residual=False)[1] is None
        # a partial view (a snapshot record mid-round): the per-neighbour
        # products instead of the packed one
        for gone in j.neighbors(i):
            jd2, td2 = _views(j, t, xs, i, drop=(gone,))
            _x_close(t.update(i, xi, td2), j.update(i, xs[i], jd2))
    assert t.exact_residual([_t(x) for x in xs]) == pytest.approx(j.exact_residual(xs),
                                                                   rel=1e-12)
    _x_close(t.assemble([_t(x) for x in xs]), j.assemble(xs))


def test_pagerank_solve_reference_matches_jax():
    j, t = JPR(n=64, p=4, seed=2), PageRankProblem(n=64, p=4, seed=2, device="cpu")
    _x_close(t.solve_reference(), j.solve_reference())


# ---------------------------------------------------------------------------
# MLFixedPointProblem
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ord", [1.0, 2.0, INF])
@pytest.mark.parametrize("task", ["lstsq", "logistic"])
def test_mlfixed_methods_match_jax(task, ord):
    kw = dict(n=16, p=4, m_rows=64, task=task, ord=ord, seed=1)
    j, t = JML(**kw), MLFixedPointProblem(device="cpu", **kw)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(16)
    xs = j.split(x)
    for a, b in zip(t.split(x), xs):
        _x_close(a, b)
    for i in range(4):
        assert t.neighbors(i) == j.neighbors(i)
        _x_close(t.init_local(i), j.init_local(i))
        for drop in ((), (j.neighbors(i)[-1],)):     # a missing block reads x0 = 0
            jd, td = _views(j, t, xs, i, drop=drop)
            xi = _t(xs[i])
            _x_close(t._assemble_view(i, xi, td), j._assemble_view(i, xs[i], jd))
            _x_close(t.update(i, xi, td), j.update(i, xs[i], jd))
            jn, jr = j.update_with_residual(i, xs[i], jd)
            tn, tr = t.update_with_residual(i, xi, td)
            _x_close(tn, jn)
            _r_close(tr, jr, ord)
            _r_close(t.local_residual(i, xi, td), j.local_residual(i, xs[i], jd), ord)
            assert t.update_with_residual(i, xi, td, need_residual=False)[1] is None
    assert t.exact_residual([_t(v) for v in xs]) == pytest.approx(j.exact_residual(xs),
                                                                   rel=1e-12)
