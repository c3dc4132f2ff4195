"""The port's monitor and residual helpers against the JAX package's.

The same contribution series (made with numpy from a seed) is fed to
``repro.core.detection.step`` and ``repro_torch.core.detection.step``: the
firing step, the detected residual (f32, exact) and the NFAIS2 verification
count must be equal for every mode and staleness.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import detection as jdet
from repro.core import residual as jres
from repro_torch import interop
from repro_torch.core import detection as tdet
from repro_torch.core import residual as tres

INF = float("inf")


def _series(seed: int, ord: float, T: int = 80) -> np.ndarray:
    """A noisy, non-monotone decaying contribution series (pre-σ, f32)
    whose σ crosses 1e-4 a few times, so persistence counters reset."""
    rng = np.random.default_rng(seed)
    g = 0.6 * 0.88 ** np.arange(T) * np.exp(0.6 * rng.standard_normal(T))
    return (g if np.isinf(ord) else g**ord).astype(np.float32)


def _run(step, init, cfg, series, exact_vals, to_scalar, make_exact):
    """Feed ``series``; return (first converged check, detected residual,
    verifications) after the whole series."""
    state = init(cfg)
    fired = -1
    for t, c in enumerate(series):
        thunk = None if exact_vals is None else make_exact(exact_vals[t])
        state = step(cfg, state, to_scalar(c), thunk)
        if fired < 0 and bool(state.converged):
            fired = t
    return fired, np.float32(state.detected_residual), int(state.verifications)


@functools.partial(jax.jit, static_argnums=(0, 4))
def _jax_step(cfg, state, c, e, with_exact):
    """``jdet.step`` compiled once per config; the verifier's value is a
    traced argument so every check reuses the program."""
    return jdet.step(cfg, state, c, axis_names=None,
                     exact_residual_fn=(lambda: e) if with_exact else None)


def _jax(cfg, series, exact_vals):
    return _run(lambda c, s, v, e: _jax_step(c, s, v, jnp.float32(0 if e is None else e),
                                             e is not None),
                jdet.init_state, cfg, series, exact_vals, jnp.float32,
                lambda e: e)


def _torch(cfg, series, exact_vals):
    return _run(lambda c, s, v, f: tdet.step(c, s, v, exact_residual_fn=f),
                lambda c: tdet.init_state(c, "cpu"), cfg, series, exact_vals,
                lambda v: torch.tensor(v, dtype=torch.float32),
                lambda e: (lambda: torch.tensor(e, dtype=torch.float32)))


@pytest.mark.parametrize("ord", [2.0, INF])
@pytest.mark.parametrize("K", [0, 2, 4])
@pytest.mark.parametrize("mode", list(tdet.MODES))
def test_monitor_matches_jax(mode, K, ord):
    series = _series(7 + K, ord)
    jcfg = jdet.for_mode(mode, eps_tilde=1e-3, margin=10.0, staleness=K,
                         persistence=3, ord=ord)
    tcfg = interop.monitor_from(jcfg)
    assert tcfg.ring_len == jcfg.ring_len
    # NFAIS2's exact verifier: the σ of the current contribution, scaled up
    # on early checks so the first verifications are refused
    sig = series.astype(np.float64) if np.isinf(ord) else np.sqrt(series)
    exact = (sig * np.where(np.arange(series.size) < 30, 50.0, 0.5)).astype(np.float32)
    for exact_vals in ([None, exact] if mode == "nfais2" else [None]):
        want = _jax(jcfg, series, exact_vals)
        got = _torch(tcfg, series, exact_vals)
        assert got == want, (mode, K, ord, exact_vals is not None)
        assert want[0] >= 0, "the series must make every mode fire"


def test_nfais2_verifier_refusals_are_counted():
    series = _series(3, INF)
    cfg = tdet.for_mode("nfais2", eps_tilde=1e-3, staleness=2, persistence=2,
                        ord=INF)
    never = np.full(series.size, 1.0, np.float32)  # every verification fails
    fired, det, ver = _torch(cfg, series, never)
    assert fired == -1 and not np.isfinite(det) and ver >= 2


def test_monitor_state_layout():
    cfg = tdet.MonitorConfig(mode="pfait", staleness=3)
    s = tdet.init_state(cfg, "cpu")
    assert s.ring.dtype == torch.float32 and s.ring.shape == (4,)
    assert bool(torch.isinf(s.ring).all())
    assert s.step.dtype == torch.int32 and s.confirm_at.dtype == torch.int32
    assert int(s.confirm_at) == np.iinfo(np.int32).max
    assert tdet.MonitorConfig(mode="sync", staleness=5).staleness == 0
    with pytest.raises(ValueError, match="mode"):
        tdet.MonitorConfig(mode="snapshot")
    assert tdet.for_mode("pfait", eps_tilde=1e-6, margin=10.0).eps == pytest.approx(1e-7)


def test_push_ring_matches_jax():
    ring_t = torch.full((3,), INF)
    ring_j = jnp.full((3,), jnp.inf, jnp.float32)
    for k, v in enumerate(np.linspace(1.0, 2.0, 7, dtype=np.float32)):
        ring_t, vis_t = tdet._push_ring(ring_t, torch.tensor(v), torch.tensor(k, dtype=torch.int32))
        ring_j, vis_j = jdet._push_ring(ring_j, jnp.float32(v), jnp.int32(k))
        np.testing.assert_array_equal(ring_t.numpy(), np.asarray(ring_j))
        assert float(vis_t) == float(vis_j)


@pytest.mark.parametrize("ord", [2.0, INF, 3.0])
def test_local_contribution_and_sigma_match_jax(ord):
    rng = np.random.default_rng(11)
    d = rng.standard_normal((5, 6, 7)) * 1e-3
    got = tres.local_contribution(torch.as_tensor(d), ord)
    want = np.asarray(jres.local_contribution(jnp.asarray(d), ord))
    assert got.dtype == torch.float32
    # f32 reductions in another order: a few ulp of the sum
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    parts = rng.random(5).astype(np.float32)
    np.testing.assert_allclose(tres.sigma(torch.as_tensor(parts), ord).numpy(),
                               np.asarray(jres.sigma(jnp.asarray(parts), ord)),
                               rtol=1e-6)
    assert tres.combine_contributions(parts, ord) == jres.combine_contributions(parts, ord)
    stacked = torch.as_tensor(parts)[:, None].repeat(1, 2)
    np.testing.assert_allclose(tres.psum_sigma(stacked, ord, dim=0).numpy(),
                               [tres.sigma(torch.as_tensor(parts), ord).item()] * 2,
                               rtol=1e-6)


def test_local_contribution_casts_difference_before_abs():
    # an f64 difference far below f32's resolution of the states survives
    d = torch.tensor([1e-13, -3e-13], dtype=torch.float64)
    assert float(tres.local_contribution(d, INF)) == pytest.approx(3e-13, rel=1e-6)
    assert float(tres.local_contribution(torch.zeros(0), INF)) == 0.0
