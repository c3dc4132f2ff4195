"""The port's ``MLFixedPointProblem`` against the JAX package's.

* The same seed draws the same data: ``A``, ``x_true``, ``H``, ``c``, ``s``,
  ``L``, ``mu`` and ``gamma`` bitwise, for both tasks and several
  (n, m_rows, cond, seed); ``grad`` and ``exact_residual`` equal; the
  constructor raises where JAX's raises.
* The batched step against JAX ``update_with_residual_batched`` in f32
  (n = 16, m_rows = 48, as ``tests/test_batched.py``), with the instance's
  2-D operators and with stacked per-lane operands as the detection
  service passes them: states within rtol 1e-5, contributions within rtol
  2e-5 (library products sum in other orders), at ord 1, 2 and ∞.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solvers.mlfixed import MLFixedPointProblem as JML
from repro_torch.solvers.mlfixed import MLFixedPointProblem

INF = float("inf")


@pytest.mark.parametrize("task", ["lstsq", "logistic"])
@pytest.mark.parametrize("n,m_rows,cond,seed", [(16, 48, 10.0, 0), (16, 48, 10.0, 5),
                                                (32, 192, 20.0, 1), (24, 24, 1.0, 3)])
def test_data_draw_bitwise_matches_jax(task, n, m_rows, cond, seed):
    kw = dict(n=n, p=4, m_rows=m_rows, task=task, cond=cond, seed=seed)
    j, t = JML(**kw), MLFixedPointProblem(**kw)
    fields = ["A", "x_true", "y"] + (["H", "c"] if task == "lstsq" else ["s"])
    for f in fields:
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), err_msg=f)
    for f in ("L", "mu", "gamma", "m", "l2", "ord", "block"):
        assert getattr(t, f) == getattr(j, f), f
    for k, v in j.lane_operands().items():
        np.testing.assert_array_equal(t.lane_operands()[k], v, err_msg=k)
    np.testing.assert_array_equal(t.lane_x0(), j.lane_x0())
    x = np.random.default_rng(seed).standard_normal(n)
    np.testing.assert_array_equal(t.grad(x), j.grad(x))
    for ord in (1.0, 2.0, INF):
        j.ord = t.ord = ord
        assert t.exact_residual(np.split(x, 4)) == j.exact_residual(np.split(x, 4))


@pytest.mark.parametrize("bad", [dict(n=10, p=4), dict(task="svm"), dict(m_rows=8),
                                 dict(l2=-1.0), dict(cond=0.5), dict(gamma=10.0),
                                 dict(task="logistic", gamma=-1.0)])
def test_constructor_errors_match_jax(bad):
    kw = dict(n=16, p=4, m_rows=48, seed=0)
    kw.update(bad)
    with pytest.raises(ValueError) as want:
        JML(**kw)
    with pytest.raises(ValueError) as got:
        MLFixedPointProblem(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("ord", [2.0, 1.0, INF])
@pytest.mark.parametrize("operands", ["instance", "stacked"])
@pytest.mark.parametrize("task", ["lstsq", "logistic"])
def test_batched_step_matches_jax(task, operands, ord):
    kw = dict(n=16, p=4, m_rows=48, task=task, cond=10.0, ord=ord)
    j, t = JML(seed=2, **kw), MLFixedPointProblem(seed=2, **kw)
    X = np.random.default_rng(4).standard_normal((3, 16)).astype(np.float32)
    if operands == "instance":
        # the instance's own 2-D operators and γ, cast to f32 as a lane holds them
        ops = t.lane_operands()
        ops["gamma"] = np.float32(t.gamma)
    else:
        per = [MLFixedPointProblem(seed=s, **kw).lane_operands() for s in range(3)]
        ops = {k: np.stack([np.asarray(o[k]) for o in per]) for k in per[0]}
    jy, jc = j.update_with_residual_batched(
        jnp.asarray(X), **{k: jnp.asarray(v) for k, v in ops.items()})
    ty, tc = t.update_with_residual_batched(
        torch.tensor(X), **{k: torch.tensor(v) for k, v in ops.items()})
    assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-5)

