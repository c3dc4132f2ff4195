"""The port's Mamba2 SSD (``models/ssm.py``) against the JAX package's and
the sequential recurrence oracle of ``tests/test_ssm.py``, on numpy-seeded
f32 inputs (f64 for the oracle).

Tolerances: chunked SSD against JAX's 1e-5 (atol and rtol; the same f32
arithmetic in another summation order), against the sequential oracle
JAX's own bar (atol 2e-4, rtol 1e-3); continuation, decode steps and the
block's prefill + decode against the whole sequence 1e-5; the gradients at
chunk 128 against JAX's at chunk 32 rtol 1e-4 of each tensor's largest
(the same function, chunked differently).

The JAX ``ssd_chunked`` takes ``exp`` of every intra-chunk exponent and
masks s > t after, so at chunk 128 its backward pass gives NaN (the port
masks first): ``test_grads_at_chunk_128_are_finite_and_match_jax_at_32``
holds the port's chunk-128 gradients to JAX's chunk-32 ones and keeps the
reference's non-finite chunk-128 gradients on record.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import ssm as jssm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import ssm as tssm

TOL = 1e-5


def sequential_ssd(x, dt, A, Bm, Cm, h0=None):
    """O(S) reference recurrence in f64: h_t = exp(dt_t A) h_{t−1} +
    dt_t B_t ⊗ x_t, y_t = h_t C_t (``tests/test_ssm.py``)."""
    x, dt, A, Bm, Cm = (np.asarray(a, np.float64) for a in (x, dt, A, Bm, Cm))
    Bsz, S, nh, P = x.shape
    rep = nh // Bm.shape[2]
    h = np.zeros((Bsz, nh, P, Bm.shape[3])) if h0 is None else np.array(h0, np.float64)
    ys = np.zeros((Bsz, S, nh, P))
    for t in range(S):
        for hh in range(nh):
            a = np.exp(dt[:, t, hh] * A[hh])[:, None, None]
            upd = dt[:, t, hh, None, None] * x[:, t, hh, :, None] * Bm[:, t, hh // rep, None, :]
            h[:, hh] = a * h[:, hh] + upd
            ys[:, t, hh] = np.einsum("bpn,bn->bp", h[:, hh], Cm[:, t, hh // rep])
    return ys, h


def _draw(seed, Bsz, S, nh, P, G, N):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((Bsz, S, nh, P)).astype(f),
            rng.uniform(0.05, 0.5, (Bsz, S, nh)).astype(f),
            (-rng.uniform(0.5, 2.0, (nh,))).astype(f),
            rng.standard_normal((Bsz, S, G, N)).astype(f),
            rng.standard_normal((Bsz, S, G, N)).astype(f))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,chunk", [(8, 4), (16, 8), (12, 12), (256, 128)])
def test_ssd_chunked_matches_jax_and_sequential(S, chunk):
    arrays = _draw(0, 2, S, 4, 8, 2, 16)
    y, h = tssm.ssd_chunked(*_t(*arrays), chunk=chunk)
    jy, jh = jssm.ssd_chunked(*_j(*arrays), chunk=chunk)
    assert y.dtype == torch.float32 and h.shape == (2, 4, 8, 16)
    _close(y, jy)
    _close(h, jh)
    y_ref, h_ref = sequential_ssd(*arrays)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(h.numpy(), h_ref, atol=2e-4, rtol=1e-3)


def test_ssd_chunked_refuses_a_chunk_that_does_not_divide():
    arrays = _draw(0, 1, 12, 2, 4, 1, 8)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(*_t(*arrays), chunk=8)


def test_ssd_chunked_with_initial_state_continuation():
    """[first half] then [second half | h] equals the whole, and the
    second half from a carried state equals JAX's."""
    x, dt, A, Bm, Cm = _t(*_draw(1, 1, 16, 2, 4, 1, 8))
    y_full, h_full = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=4)
    y1, h1 = tssm.ssd_chunked(x[:, :8], dt[:, :8], A, Bm[:, :8], Cm[:, :8], chunk=4)
    y2, h2 = tssm.ssd_chunked(x[:, 8:], dt[:, 8:], A, Bm[:, 8:], Cm[:, 8:], chunk=4, h0=h1)
    _close(torch.cat([y1, y2], 1), y_full.numpy())
    _close(h2, h_full.numpy())
    jx, jdt, jA, jB, jC = (jnp.asarray(a.numpy()) for a in (x, dt, A, Bm, Cm))
    jy2, jh2 = jssm.ssd_chunked(jx[:, 8:], jdt[:, 8:], jA, jB[:, 8:], jC[:, 8:], chunk=4,
                                h0=jnp.asarray(h1.numpy()))
    _close(y2, jy2)
    _close(h2, jh2)


def test_ssd_decode_steps_match_chunked_and_jax():
    x, dt, A, Bm, Cm = _t(*_draw(2, 2, 6, 4, 4, 2, 8))
    y_full, _ = tssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=6)
    h = torch.zeros((2, 4, 4, 8))
    jh = jnp.zeros((2, 4, 4, 8))
    ys = []
    for t in range(6):
        step = (x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
        y, h = tssm.ssd_decode_step(*step, h)
        jy, jh = jssm.ssd_decode_step(*(jnp.asarray(a.numpy()) for a in step), jh)
        _close(y, jy)
        _close(h, jh)
        ys.append(y)
    _close(torch.stack(ys, dim=1), y_full.numpy())


def test_causal_conv_state_continuation_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tx, tw = _t(x, w)
    y_full, st_full = tssm.causal_conv(tx, tw)
    jy, jst = jssm.causal_conv(*_j(x, w))
    _close(y_full, jy)
    _close(st_full, jst)
    y1, st1 = tssm.causal_conv(tx[:, :4], tw)
    y2, st2 = tssm.causal_conv(tx[:, 4:], tw, state=st1)
    _close(torch.cat([y1, y2], 1), y_full.numpy(), 1e-6)
    assert torch.equal(st2, st_full)


def _block(d_model=32):
    kw = dict(name="t", family="ssm", num_layers=1, d_model=d_model, vocab_size=64,
              ssm_state=8, ssm_head_dim=8, ssm_expand=2)
    jplan = jssm.plan_ssm(JModelConfig(**kw), tp=1)
    plan = tssm.plan_ssm(ModelConfig(**kw), tp=1)
    jp = jssm.ssm_init(jax.random.PRNGKey(0), jplan, jnp.float32)
    p = tssm.SSM(plan, torch.float32)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    return jplan, jp, plan, p


def _plan_fields(plan):
    return tuple(getattr(plan, f) for f in ("d_model", "heads", "heads_padded", "head_dim",
                                            "state", "groups", "conv_width", "tp"))


def test_plan_and_init_match_jax():
    """The plan field for field (padded heads at tp = 16), and ``SSM``
    against ``ssm_init``: shapes, dtypes, constants, scales, and zero
    ``out_proj`` rows for the padded heads."""
    kw = dict(name="t", family="ssm", num_layers=1, d_model=64, vocab_size=64,
              ssm_state=8, ssm_head_dim=16, ssm_expand=2, ssm_heads=6)
    for tp in (1, 16):
        jplan = jssm.plan_ssm(JModelConfig(**kw), tp)
        plan = tssm.plan_ssm(ModelConfig(**kw), tp)
        assert _plan_fields(plan) == _plan_fields(jplan)
        assert (plan.d_inner, plan.conv_dim) == (jplan.d_inner, jplan.conv_dim)
        np.testing.assert_array_equal(tssm.head_valid_mask(plan).numpy(),
                                      np.asarray(jssm.head_valid_mask(jplan)))
        jp = jssm.ssm_init(jax.random.PRNGKey(0), jplan, jnp.bfloat16)
        p = tssm.SSM(plan, torch.bfloat16).init_(torch.Generator().manual_seed(0))
        for name, t in p.named_parameters():
            assert tuple(t.shape) == jp[name].shape and str(t.dtype) == f"torch.{jp[name].dtype}"
        assert torch.equal(p.A_log, torch.zeros(plan.heads_padded))
        assert torch.equal(p.D_skip, torch.ones(plan.heads_padded))
        rows = p.out_proj.float().reshape(plan.heads_padded, plan.head_dim, -1)
        assert not rows[plan.heads:].any() and rows[:plan.heads].all()
        assert abs(float(rows[:plan.heads].std()) * np.sqrt(plan.d_inner) - 1) < 0.1
        assert abs(float(p.conv_x.float().std()) / 0.2 - 1) < 0.1


def test_ssm_apply_matches_jax_and_prefill_then_decode_matches_full():
    """The block at full length, and prefill 8 then decode 1 against the
    full output's last position, each against JAX's (``tests/test_ssm.py``'s
    case)."""
    jplan, jp, plan, p = _block()
    x = np.random.default_rng(4).standard_normal((2, 9, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    y_full, cache_full = tssm.ssm_apply(p, tx, plan, chunk=3)
    jy_full, jcache = jssm.ssm_apply(jp, jnp.asarray(x), jplan, chunk=3)
    _close(y_full, jy_full)
    for a, b in zip(cache_full, jcache):
        _close(a, b)
    y1, cache = tssm.ssm_apply(p, tx[:, :8], plan, chunk=4)
    y2, cache = tssm.ssm_apply(p, tx[:, 8:9], plan, chunk=1, cache=cache)
    _close(torch.cat([y1, y2], 1), y_full.detach().numpy())
    for a, b in zip(cache, cache_full):
        _close(a, b.detach().numpy())


def _sum_sq_loss_grads_jax(jp, jplan, x, chunk):
    def loss(p):
        y, _ = jssm.ssm_apply(p, x, jplan, chunk=chunk)
        return jnp.sum(y ** 2)
    return jax.jit(jax.value_and_grad(loss))(jp)


def test_grads_at_chunk_128_are_finite_and_match_jax_at_32():
    """Σ y² through the block at S = 256 (f32, random init: A = −1, dt ≈
    softplus(N(0, 1))).  The port's gradients at chunk 128 are finite and
    equal JAX's at chunk 32, where JAX's are finite; JAX's own at chunk
    128 are not (a fault of the reference, left unedited)."""
    jplan, jp, plan, p = _block(d_model=64)
    x = np.random.default_rng(5).standard_normal((2, 256, 64)).astype(np.float32)
    jl32, jg32 = _sum_sq_loss_grads_jax(jp, jplan, jnp.asarray(x), 32)
    jl128, jg128 = _sum_sq_loss_grads_jax(jp, jplan, jnp.asarray(x), 128)
    assert np.isfinite(float(jl128)) and float(jl128) == pytest.approx(float(jl32), rel=1e-5)
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree.leaves(jg128))
    p.requires_grad_(True)
    y, _ = tssm.ssm_apply(p, torch.from_numpy(x), plan, chunk=128)
    loss = y.square().sum()
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl32), rel=1e-5)
    for name, t in p.named_parameters():
        want = np.asarray(jg32[name])
        assert bool(torch.isfinite(t.grad).all()), name
        err = float(np.abs(t.grad.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)
