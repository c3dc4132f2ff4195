"""The port's kernel modules against the JAX package's oracle paths.

On the CPU every kernel wrapper runs its plain version, so these tests hold
the plain versions and the ``ops`` layers to the JAX functions the JAX
package's own CPU tests use (``interpret=None`` off-TPU dispatches to the
oracles; ``diff_norm_partials`` also runs in Pallas interpret mode).  They
also check the dispatch: a CUDA tensor launches the kernel and never
reaches the plain version.  The tests that need the card are in
``test_torch_cuda.py``, which imports nothing of JAX.

Tolerances: f64 atol 1e-12 on blocks; partials relative 1e-6 (f32 sums in
another order); max-partials exact.  At ord 1 (Σ|r| partials) the JAX
kernel ops are no reference (they pick Σr² for every finite order): the
port is held to JAX ``local_contribution(r, 1)`` instead.
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import residual as jres
from repro.kernels.jacobi3d import ops as jops
from repro.kernels.jacobi3d import ref as jref
from repro.kernels.residual_norm import ops as jrn_ops
from repro.kernels.residual_norm import ref as jrn_ref
from repro.kernels.residual_norm.residual_norm import diff_norm_partials as jdiff_pallas
from repro.solvers import gauss_seidel as jgs
from repro.solvers.convdiff import Stencil as JStencil
from repro_torch import interop
from repro_torch.core import detection as tdet
from repro_torch.kernels import _build
from repro_torch.kernels.jacobi3d import jacobi3d as tk
from repro_torch.kernels.jacobi3d import ops as tops
from repro_torch.kernels.jacobi3d import ref as tref
from repro_torch.kernels.residual_norm import ops as trn_ops
from repro_torch.kernels.residual_norm import ref as trn_ref
from repro_torch.kernels.residual_norm import residual_norm as trk
from repro_torch.solvers import fixed_point as tfp
from repro_torch.solvers import gauss_seidel as tgs
from repro_torch.solvers import jacobi as tjac

INF = float("inf")
_ORD = {True: INF, False: 2.0}   # the port's order for a JAX ``linf`` flag


def _stencil(n=8):
    st_j = JStencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.9)
    return st_j, interop.stencil_from(st_j)


def _block(shape, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    bx, by, bz = shape
    x = rng.standard_normal(shape).astype(dtype)
    ghosts = tuple(rng.standard_normal(s).astype(dtype)
                   for s in ((by, bz), (by, bz), (bx, bz), (bx, bz)))
    b = rng.standard_normal(shape).astype(dtype)
    return x, ghosts, b


def _t(a):
    return tuple(torch.as_tensor(v) for v in a) if isinstance(a, tuple) else torch.as_tensor(a)


def _j(a):
    return tuple(jnp.asarray(v) for v in a) if isinstance(a, tuple) else jnp.asarray(a)


def _close_rel(got, want, rtol):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale, want / scale,
                               rtol=0, atol=rtol)


# ---------------------------------------------------------------------------
# Ghost assembly and partials layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pad", ["ghost_pad1", "ghost_pad2"])
def test_ghost_pads_match_jax(pad):
    x, ghosts, _ = _block((5, 6, 7))
    got = getattr(tops, pad)(_t(x), _t(ghosts))
    want = getattr(jops, pad)(_j(x), _j(ghosts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("linf", [True, False])
def test_residual_partials_layout_matches_jax(linf):
    rng = np.random.default_rng(1)
    r = rng.standard_normal((8, 12, 5))
    got = tref.residual_partials(torch.as_tensor(r), tile=(4, 4), ord=_ORD[linf])
    want = np.asarray(jref.residual_partials(jnp.asarray(r), tile=(4, 4), linf=linf))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0 if linf else 1e-6)


@pytest.mark.parametrize("linf", [True, False])
def test_residual_partials_ragged_tiles(linf):
    """The port masks a ragged edge (the Pallas wrapper required the tile
    to divide the block): each partial covers what is left of its tile."""
    rng = np.random.default_rng(2)
    r = rng.standard_normal((13, 7, 5))
    got = tref.residual_partials(torch.as_tensor(r), tile=(4, 3), ord=_ORD[linf]).numpy()
    assert got.shape == (4, 3)
    for i in range(4):
        for j in range(3):
            t = r[4 * i:4 * i + 4, 3 * j:3 * j + 3].astype(np.float32)
            want = np.abs(t).max() if linf else (t * t).sum()
            np.testing.assert_allclose(got[i, j], want, rtol=1e-6)
    with pytest.raises(ValueError, match="tile"):
        tref.residual_partials(torch.as_tensor(r), tile=(0, 3))


# ---------------------------------------------------------------------------
# Plain kernel versions against the JAX oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("linf", [True, False])
@pytest.mark.parametrize("op", ["sweep", "residual"])
def test_fused_sweep_residual_ref_matches_jax(op, linf, dtype):
    st_j, st = _stencil()
    x, ghosts, b = _block((8, 8, 6), dtype=dtype)
    g = tops.ghost_pad1(_t(x), _t(ghosts))
    new, parts = tk.fused_sweep_residual(g, _t(b), st.coefs, tile=(4, 4), op=op,
                                         ord=_ORD[linf])
    coefs = jnp.asarray(st.coefs, jnp.asarray(b).dtype)
    jnew, jparts = jref.fused_sweep_residual_ref(jnp.asarray(g.numpy()), jnp.asarray(b),
                                                 coefs, tile=(4, 4), op=op, linf=linf)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    _close_rel(new.numpy(), jnew, tol)
    _close_rel(parts.numpy(), jparts, 1e-6 if dtype == np.float64 else 1e-5)
    assert sum(tk.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("phase", [(0, 0), (3, 5), (1, 0)])
@pytest.mark.parametrize("linf", [True, False])
def test_fused_rbgs_ref_matches_jax_composition(linf, phase, dtype):
    """As ops.py composes it off-TPU: ghost_pad1 + the RB-GS sweep with the
    input residual + residual_partials."""
    st_j, st = _stencil()
    ox, oy = phase
    x, ghosts, b = _block((8, 8, 6), seed=3, dtype=dtype)
    g2 = tops.ghost_pad2(_t(x), _t(ghosts))
    new, parts = tk.fused_rbgs_sweep_residual(g2, _t(b), st.coefs, ox + oy,
                                              tile=(4, 4), ord=_ORD[linf])
    jnew, r = jgs.redblack_gs_sweep_residual(st_j, jops.ghost_pad1(_j(x), _j(ghosts)),
                                             jnp.asarray(b), ox, oy)
    jparts = jref.residual_partials(r, tile=(4, 4), linf=linf)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    _close_rel(new.numpy(), jnew, tol)
    _close_rel(parts.numpy(), jparts, 1e-6 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kernel", ["sweep", "residual", "rbgs"])
def test_l1_partials_match_jax_local_contribution(kernel, dtype):
    """ord 1: each tile's partial is JAX ``local_contribution(r, 1)`` of the
    tile's input residual (f32(|r|) summed), on a block the tile does not
    divide."""
    st_j, st = _stencil()
    x, ghosts, b = _block((9, 10, 6), seed=10, dtype=dtype)
    tile = (4, 4)
    if kernel == "rbgs":
        _, parts = tk.fused_rbgs_sweep_residual(tops.ghost_pad2(_t(x), _t(ghosts)), _t(b),
                                                st.coefs, 3, tile=tile, ord=1.0)
        _, r = jgs.redblack_gs_sweep_residual(st_j, jops.ghost_pad1(_j(x), _j(ghosts)),
                                              jnp.asarray(b), 3, 0)
    else:
        g = tops.ghost_pad1(_t(x), _t(ghosts))
        _, parts = tk.fused_sweep_residual(g, _t(b), st.coefs, tile=tile, op=kernel, ord=1.0)
        from repro.solvers import jacobi as jjac

        r = jjac.residual_block(st_j, jnp.asarray(g.numpy()), jnp.asarray(b))
    assert parts.shape == (3, 3) and parts.dtype == torch.float32
    r = np.asarray(r)
    for i in range(3):
        for j in range(3):
            want = jres.local_contribution(jnp.asarray(r[4 * i:4 * i + 4, 4 * j:4 * j + 4]), 1)
            np.testing.assert_allclose(parts[i, j].item(), float(want),
                                       rtol=1e-6 if dtype == np.float64 else 1e-5)


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_l1_diff_norm_partials_match_jax(dtype):
    """ord 1: each block's partial is JAX ``local_contribution(a − b, 1)``
    with the difference taken in the wider of (dtype, f32)."""
    rng = np.random.default_rng(11)
    a, b = rng.standard_normal((7, 9, 11)), rng.standard_normal((7, 9, 11))
    tdt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    got = trn_ref.diff_norm_partials_ref(torch.as_tensor(a).to(tdt), torch.as_tensor(b).to(tdt),
                                         block=128, ord=1.0)
    ja, jb = (jnp.asarray(v).astype(jdt).reshape(-1) for v in (a, b))
    wide = jnp.promote_types(jdt, jnp.float32)
    d = ja.astype(wide) - jb.astype(wide)
    want = [float(jres.local_contribution(d[k:k + 128], 1)) for k in range(0, d.size, 128)]
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# ops layer against the JAX ops (off-TPU oracle path)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ord", [INF, 2.0])
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid"])
def test_ops_match_jax_ops(sweep, ord):
    st_j, st = _stencil()
    x, ghosts, b = _block((8, 8, 6), seed=4)
    ox, oy = (8, 0)
    tops.reset_pass_counts()
    new, c = tops.sweep_with_contribution(st, _t(x), _t(ghosts), _t(b), sweep=sweep,
                                          ox=ox, oy=oy, ord=ord, tile=(4, 4))
    jnew, jc = jops.sweep_with_contribution(st_j, _j(x), _j(ghosts), jnp.asarray(b),
                                            sweep=sweep, ox=ox, oy=oy, ord=ord,
                                            tile=(4, 4))
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-12, rtol=0)
    np.testing.assert_allclose(float(c), float(jc), rtol=0 if np.isinf(ord) else 1e-6)
    only = tops.sweep(st, _t(x), _t(ghosts), _t(b), sweep=sweep, ox=ox, oy=oy)
    np.testing.assert_array_equal(only.numpy(), new.numpy())
    g = tops.ghost_pad1(_t(x), _t(ghosts))
    rc = tops.residual_contribution(st, g, _t(b), ord=ord, tile=(4, 4))
    jrc = jops.residual_contribution(st_j, jnp.asarray(g.numpy()), jnp.asarray(b),
                                     ord=ord, tile=(4, 4))
    np.testing.assert_allclose(float(rc), float(jrc), rtol=0 if np.isinf(ord) else 1e-6)
    assert tops.PASS_COUNTS == {"sweep": 1, "fused": 1, "residual": 1}


@pytest.mark.parametrize("ord", [INF, 2.0, 1.0])
@pytest.mark.parametrize("sweep", ["jacobi", "hybrid"])
def test_ops_contribution_on_ragged_block(sweep, ord):
    """Default tile on a block it does not divide: the reduced contribution
    equals the JAX solver's whole-block contribution."""
    st_j, st = _stencil()
    x, ghosts, b = _block((13, 37, 5), seed=5)
    _, c = tops.sweep_with_contribution(st, _t(x), _t(ghosts), _t(b), sweep=sweep,
                                        ox=3, oy=0, ord=ord)
    g = jops.ghost_pad1(_j(x), _j(ghosts))
    if sweep == "jacobi":
        from repro.solvers import jacobi as jjac

        _, r = jjac.jacobi_sweep_residual(st_j, g, jnp.asarray(b))
    else:
        _, r = jgs.redblack_gs_sweep_residual(st_j, g, jnp.asarray(b), 3, 0)
    want = float(jres.local_contribution(r, ord))
    np.testing.assert_allclose(float(c), want, rtol=0 if np.isinf(ord) else 1e-6)


def test_ops_reject_unsupported_norms_and_sweeps():
    _, st = _stencil()
    x, ghosts, b = _block((4, 4, 4))
    with pytest.raises(ValueError, match="ord"):
        tops.sweep_with_contribution(st, _t(x), _t(ghosts), _t(b), ord=3.0)
    with pytest.raises(ValueError, match="sweep"):
        tops.sweep(st, _t(x), _t(ghosts), _t(b), sweep="sor")
    with pytest.raises(ValueError, match="op"):
        tk.fused_sweep_residual(tops.ghost_pad1(_t(x), _t(ghosts)), _t(b), st.coefs,
                                op="norm")


# ---------------------------------------------------------------------------
# residual_norm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("linf", [True, False])
@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
def test_diff_norm_partials_ref_matches_jax(dtype, linf):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((7, 9, 11))
    b = rng.standard_normal((7, 9, 11))
    tdt = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    jdt = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    got = trn_ref.diff_norm_partials_ref(torch.as_tensor(a).to(tdt),
                                         torch.as_tensor(b).to(tdt), block=128,
                                         ord=_ORD[linf])
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    want = np.asarray(jrn_ref.diff_norm_partials_ref(ja, jb, block=128, linf=linf))
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0 if linf else 1e-6)
    pallas = np.asarray(jdiff_pallas(ja, jb, block=128, linf=linf, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=0 if linf else 1e-6)


def test_diff_norm_keeps_tiny_f64_differences():
    rng = np.random.default_rng(7)
    a = 1.0 + rng.random(5000)
    b = a + 1e-13 * rng.random(5000)
    got = trn_ref.diff_norm_partials_ref(torch.as_tensor(a), torch.as_tensor(b), block=1024)
    want = np.asarray(jrn_ref.diff_norm_partials_ref(jnp.asarray(a), jnp.asarray(b),
                                                     block=1024))
    assert (got.numpy() > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0)


@pytest.mark.parametrize("ord", [INF, 2.0, 1.0])
def test_update_contribution_and_diff_norm_match_jax(ord):
    rng = np.random.default_rng(8)
    new, old = rng.standard_normal((6, 5, 4)), rng.standard_normal((6, 5, 4))
    got = trn_ops.update_contribution(torch.as_tensor(new), torch.as_tensor(old),
                                      ord=ord, scale=-3.5)
    want = jrn_ops.update_contribution(jnp.asarray(new), jnp.asarray(old), ord=ord,
                                       scale=-3.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=0 if np.isinf(ord) else 1e-6)
    # JAX's diff_norm treats every finite order as 2; at ord 1 the port's is
    # held to the exact l1 norm instead
    want = jres.global_residual(jnp.asarray(new), jnp.asarray(old), ord) if ord == 1.0 \
        else jrn_ops.diff_norm(jnp.asarray(new), jnp.asarray(old), ord)
    np.testing.assert_allclose(
        float(trn_ops.diff_norm(torch.as_tensor(new), torch.as_tensor(old), ord)),
        float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# Dispatch: CPU → plain version; CUDA → kernel or raise, never the plain one
# ---------------------------------------------------------------------------


def forbidden(*a, **k):
    raise AssertionError("a CUDA tensor reached the plain version")


class _FakeLib:
    """Stands in for a loaded kernel library: records calls, returns rc."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return self.rc
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    """Treat CPU tensors as if they lay on the card, with a fake kernel
    library, and make every plain version raise if it is reached."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))

    for mod, name in ((tk, "fused_sweep_residual_ref"),
                      (tk, "fused_rbgs_sweep_residual_ref"),
                      (tk, "fused_sweep_residual_halo_ref"),
                      (tk, "fused_rbgs_sweep_residual_halo_ref"),
                      (tfp, "ghosted6"),
                      (trk, "diff_norm_partials_ref"),
                      (tjac, "jacobi_sweep"), (tjac, "jacobi_sweep_residual"),
                      (tjac, "residual_block"), (tgs, "redblack_gs_sweep"),
                      (tgs, "redblack_gs_sweep_residual")):
        monkeypatch.setattr(mod, name, forbidden)
    tk.reset_launches()
    trk.reset_launches()
    yield lib
    tk.reset_launches()
    trk.reset_launches()


def test_cuda_tensors_launch_kernels_never_plain(fake_card):
    _, st = _stencil()
    x, ghosts, b = _block((13, 37, 5))
    xt, gt, bt = _t(x), _t(ghosts), _t(b)
    tops.sweep_with_contribution(st, xt, gt, bt, sweep="jacobi")
    tops.sweep_with_contribution(st, xt, gt, bt, sweep="hybrid", ox=2, oy=1)
    tops.residual_contribution(st, tops.ghost_pad1(xt, gt), bt, ord=2.0)
    trn_ops.update_contribution(bt, xt, ord=INF, scale=2.0)
    trn_ops.update_contribution(bt.float(), xt.float(), ord=2.0)
    names = [c[0] for c in fake_card.calls]
    assert names == ["fused_sweep_residual_f64", "fused_rbgs_sweep_residual_f64",
                     "fused_sweep_residual_f64", "diff_norm_partials_f64",
                     "diff_norm_partials_f32"]
    # (…, bx, by, bz, tx, ty, flag, mode, coefs…): ragged default tile, phase 3
    args = fake_card.calls[1][1]
    assert args[4:11] == (13, 37, 5) + tref.DEFAULT_TILE + (3, 1)
    assert fake_card.calls[2][1][9:11] == (0, 0)   # residual-only, l2
    assert tk.LAUNCHES == {"fused_sweep_residual": 2, "fused_rbgs_sweep_residual": 1,
                           "fused_sweep_residual_halo": 0,
                           "fused_rbgs_sweep_residual_halo": 0}
    assert trk.LAUNCHES == {"diff_norm_partials": 2}


def test_cuda_tensors_at_l1_launch_kernels_in_l1_mode(fake_card):
    """ord 1 on the card: every entry launches its kernel with mode 2 (Σ|r|),
    and nothing reaches a plain version; ord 3 raises before any launch."""
    _, st = _stencil()
    x, ghosts, b = _block((13, 37, 5))
    xt, gt, bt = _t(x), _t(ghosts), _t(b)
    halos = gt + (torch.zeros((13, 37)).double(),) * 2
    tops.sweep_with_contribution(st, xt, gt, bt, sweep="jacobi", ord=1.0)
    tops.sweep_with_contribution(st, xt, gt, bt, sweep="hybrid", ord=1.0)
    tops.residual_contribution(st, tops.ghost_pad1(xt, gt), bt, ord=1.0)
    tops.sweep_with_contribution_halo(st, xt, halos, bt, sweep="jacobi", ord=1.0)
    tops.sweep_with_contribution_halo(st, xt, halos, bt, sweep="hybrid", ord=1.0)
    tops.residual_contribution_halo(st, xt, halos, bt, ord=1.0)
    trn_ops.update_contribution(bt, xt, ord=1.0, scale=2.0)
    trn_ops.diff_norm(bt, xt, ord=1.0)
    names = [c[0] for c in fake_card.calls]
    assert names == ["fused_sweep_residual_f64", "fused_rbgs_sweep_residual_f64",
                     "fused_sweep_residual_f64", "fused_sweep_residual_halo_f64",
                     "fused_rbgs_sweep_residual_halo_f64", "fused_sweep_residual_halo_f64",
                     "diff_norm_partials_f64", "diff_norm_partials_f64"]
    modes = [args[10] for _, args in fake_card.calls[:3]] + \
        [args[16] for _, args in fake_card.calls[3:6]] + \
        [args[5] for _, args in fake_card.calls[6:]]
    assert modes == [2] * 8
    for fn in (lambda: tops.sweep_with_contribution(st, xt, gt, bt, ord=3.0),
               lambda: tops.residual_contribution_halo(st, xt, halos, bt, ord=3.0),
               lambda: trn_ops.diff_norm(bt, xt, ord=3.0)):
        with pytest.raises(ValueError, match="ord 1, 2 or inf"):
            fn()
    assert len(fake_card.calls) == 8


def test_kernel_launch_errors_and_bad_inputs_raise(fake_card):
    _, st = _stencil()
    x, ghosts, b = _block((4, 4, 4))
    g = tops.ghost_pad1(_t(x), _t(ghosts))
    with pytest.raises(TypeError, match="f32/f64"):
        tk.fused_sweep_residual(g, _t(b).float(), st.coefs)
    with pytest.raises(ValueError, match="shape"):
        tk.fused_sweep_residual(g[:-1], _t(b), st.coefs)
    with pytest.raises(ValueError, match="contiguous"):
        trk.diff_norm_partials(_t(b).transpose(0, 1), _t(b).transpose(0, 1))
    with pytest.raises(ValueError, match="ord 1, 2 or inf"):
        trn_ops.update_contribution(_t(b), _t(x), ord=3.0)
    fake_card.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tk.fused_sweep_residual(g, _t(b), st.coefs)
    assert tk.LAUNCHES["fused_sweep_residual"] == 0


def test_cuda_halo_tensors_launch_kernels_never_plain(fake_card):
    _, st = _stencil()
    bx, by, bz = 13, 37, 5
    rng = np.random.default_rng(9)
    x, b = (torch.as_tensor(rng.standard_normal((bx, by, bz))) for _ in range(2))
    halos = tuple(torch.as_tensor(rng.standard_normal(s)).float() for s in
                  ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by)))
    new, _ = tops.sweep_with_contribution_halo(st, x, halos, b, sweep="jacobi")
    tops.sweep_halo(st, x, halos, b, sweep="hybrid", ox=2, oy=1, oz=4)
    same, _ = tk.fused_sweep_residual_halo(x, halos, b, st.coefs, op="residual")
    tops.residual_contribution_halo(st, x.float(), halos, b.float(), ord=2.0)
    names = [c[0] for c in fake_card.calls]
    assert names == ["fused_sweep_residual_halo_f64", "fused_rbgs_sweep_residual_halo_f64",
                     "fused_sweep_residual_halo_f64", "fused_sweep_residual_halo_f32"]
    # (x, 6 planes, b, out, parts, bx, by, bz, tx, ty, flag, mode, coefs…)
    args = fake_card.calls[1][1]
    assert args[10:17] == (bx, by, bz) + tref.DEFAULT_TILE + (7, 1)
    assert fake_card.calls[2][1][8] is None and same is x   # residual: no block
    assert fake_card.calls[3][1][15:17] == (0, 0)            # residual-only, l2
    assert new.shape == x.shape
    assert tk.LAUNCHES == {"fused_sweep_residual": 0, "fused_rbgs_sweep_residual": 0,
                           "fused_sweep_residual_halo": 3,
                           "fused_rbgs_sweep_residual_halo": 1}
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_sweep_residual_halo(x.transpose(0, 2).contiguous().transpose(0, 2),
                                     halos, b, st.coefs)
    fake_card.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tk.fused_rbgs_sweep_residual_halo(x, halos, b, st.coefs, 0)
    assert tk.LAUNCHES["fused_rbgs_sweep_residual_halo"] == 1


@pytest.mark.parametrize("shape,overlap,sweep,per_step", [
    # per outer step: one fused sweep per shard, plus two face slabs per
    # partitioned direction with overlap
    ((2, 2), True, "jacobi", {"fused_sweep_residual_halo": 4 * (1 + 4)}),
    ((2, 1, 2), False, "hybrid", {"fused_rbgs_sweep_residual_halo": 4}),
])
def test_mesh_runtime_on_card_launches_halo_kernels(fake_card, shape, overlap, sweep,
                                                    per_step):
    """The mesh runtime's sweeps, contributions and overlap slabs all go
    through the halo kernels on the card.  The fake kernels write nothing,
    so only the count per outer step is checked."""
    from repro_torch.runtime import shard_runtime as tsr

    _, st = _stencil()
    cfg = tsr.ShardRuntimeConfig(monitor=tdet.for_mode("pfait", 1e-6, ord=INF),
                                 max_outer=3, sweep=sweep, overlap=overlap)
    out = tsr.make_convdiff_runtime(cfg, shape, st, 8, device="cpu")(
        np.zeros((8, 8, 8)), np.ones((8, 8, 8)))
    assert 1 <= out.outer_iters <= 3
    want = dict.fromkeys(tk.LAUNCHES, 0)
    want.update({k: v * out.outer_iters for k, v in per_step.items()})
    assert tk.LAUNCHES == want
    assert trk.LAUNCHES == {"diff_norm_partials": 0}


@pytest.mark.parametrize("sweep,fuse,per_iter", [
    ("hybrid", True, {"fused_sweep_residual": 0, "fused_rbgs_sweep_residual": 2}),
    ("jacobi", True, {"fused_sweep_residual": 2, "fused_rbgs_sweep_residual": 0}),
    ("hybrid", False, {"fused_sweep_residual": 1, "fused_rbgs_sweep_residual": 2}),
])
def test_default_solver_config_on_card_launches_kernels(fake_card, sweep, fuse,
                                                         per_iter):
    """``use_kernel`` keeps its default (off): a card's tensors still take
    the kernels, never the plain sweeps.  The fake kernels write nothing,
    so only the count per outer iteration is checked."""
    _, st = _stencil()
    cfg = tfp.SolverConfig(stencil=st, monitor=tdet.for_mode("pfait", 1e-6, ord=INF),
                           inner_sweeps=2, max_outer=3, sweep=sweep,
                           fuse_residual=fuse)
    assert not cfg.use_kernel
    out = tfp.solve_single(cfg, np.zeros((6, 5, 4)), device="cpu")
    assert 1 <= out.outer_iters <= 3
    assert tk.LAUNCHES == {**dict.fromkeys(tk.LAUNCHES, 0),
                           **{k: v * out.outer_iters for k, v in per_iter.items()}}
    bad = tfp.SolverConfig(stencil=st, monitor=tdet.for_mode("pfait", 1e-6, ord=3.0))
    with pytest.raises(ValueError, match="ord 1, 2 or inf"):
        tfp.solve_single(bad, np.zeros((6, 5, 4)), device="cpu")


def test_tensors_off_cpu_and_cuda_raise():
    # ``meta`` alone is a dry rank's path (tests/test_torch_solver_cell.py);
    # inputs that mix it with the CPU raise
    a = torch.empty((4, 4, 4), device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        trk.diff_norm_partials(a, torch.empty((4, 4, 4)))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        trk.diff_norm_partials(torch.empty((4, 4, 4)), a)
