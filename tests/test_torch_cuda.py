"""Tests that need the card: each CUDA kernel against its plain version, and
the main paths (``solve_single``, the 1-D and the mesh shard runtimes, the
serving loop of a reduced dense model) on the card against the same runs
on the CPU.

They import nothing of JAX, so they run on a machine with a GPU and no JAX
(``tests/conftest.py`` imports JAX, hence ``--noconftest``)::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Elsewhere each test skips, deciding inside the test.  Tolerances: f64
blocks 1e-12 (FMA contraction), f32 blocks 1e-5, f32 partial sums 2e-5
relative (summation order), f64 l∞ partials 1e-6 (the f32 cast), the
stencil sweeps' partials bitwise equal across two calls; solves on the card
and on the CPU must take the same number of outer iterations and agree to
1e-10 in x.  Flash attention:
2e-5 (f32, on the f32 kernel: a bf16 or TF32 product would miss it) and
3e-2 (bf16, on the tensor-core kernel) of the largest output magnitude, as
``tests/test_kernels.py:83``, and in bf16 against the flat plain version
also element by element under ``flash_attention.ref.bf16_output_bar``,
|Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|) (one bf16 step of
the output plus the rounding of p to bf16 for the P·V product); an f32
model served on the card gives the CPU's tokens, for the dense family and
each of the moe, ssm, hybrid and frontend families.  Diff-norm partials: l∞
1e-6 and l2 / l1 2e-5 relative (summation order), bitwise equal across
calls.  The stencil and diff-norm kernels are checked in all three partial
modes (l∞ max|r|, l2 Σr², l1 Σ|r|); an l1 run on the card takes the CPU's
iterations.  PageRank through ``runtime.api.run_shard`` on the card takes the
CPU's iterations, with x within 1e-12 and the residual history within rtol
5e-5; #5 in l1 at its PageRank blocks is held at 2e-5.  A world of ranks
on the card (gloo sharing it, NCCL at world size 1) equals the stacked run
on the card bitwise.  The data-parallel training runtime's #5 shapes (the
[p, n] replica stacks at block n, a replica alone) and the elastic path's
(an 8192-row PageRank block, the 30×150×150 block of one of 5 shards) are
held at the same bars; a stacked training run and an elastic run on the
card take the CPU's rounds and segments, with X within rtol 1e-10.  A
reduced f32 LM's train steps on the card give the CPU's losses and grad
norms within rtol 1e-4, launch none of the kernels, and ``train`` on the
card fires where the detection rule replayed on its loss series fires.
Tensor parallelism over two gloo ranks sharing the card gives the
one-device prefill logits of a reduced f32 qwen2 within 1e-5 of the
largest, #6 launching once a layer in each rank.  A stacked solve under
the span recorder counts as many host syncs as torch's sync debug mode
sees, no ghost-assembly bytes, and its kernel bytes exactly; #3 at the
1-D runtime's planes matches #1 on the block assembled from them.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import registry as treg
from repro_torch.configs.base import reduced
from repro_torch.core import detection
from repro_torch.kernels.flash_attention import flash_attention as tfk
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention.ref import bf16_output_bar
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tflash_ref
from repro_torch.launch import serve as tserve
from repro_torch.models.attention import attention_fwd as tattention_fwd
from repro_torch.models.model import Model
from repro_torch.kernels.jacobi3d import jacobi3d as tk
from repro_torch.kernels.jacobi3d import ref as tref
from repro_torch.kernels.residual_norm import ref as trn_ref
from repro_torch.kernels.residual_norm import residual_norm as trk
from repro_torch.runtime import shard_runtime as tsr
from repro_torch.solvers import fixed_point as tfp
from repro_torch.solvers.convdiff import Stencil, make_rhs

INF = float("inf")
ORDS = (INF, 2.0, 1.0)   # the partial modes: max|r|, Σr², Σ|r|


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(card):
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(0)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        b = torch.rand((13, 37, 19), generator=gen, device=card, dtype=dtype)
        g = torch.rand((15, 39, 21), generator=gen, device=card, dtype=dtype)
        g2 = torch.rand((17, 41, 21), generator=gen, device=card, dtype=dtype)
        for ord in ORDS:
            for op in ("sweep", "residual"):
                got = tk.fused_sweep_residual(g, b, st.coefs, op=op, ord=ord)
                want = tref.fused_sweep_residual_ref(g, b, st.coefs, op=op, ord=ord)
                torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
                torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=0)
            for oxy in (0, 1):
                got = tk.fused_rbgs_sweep_residual(g2, b, st.coefs, oxy, ord=ord)
                want = tref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, oxy, ord=ord)
                torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
                torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=0)
            torch.testing.assert_close(
                trk.diff_norm_partials(g, g.flip(0), block=4096, ord=ord),
                trn_ref.diff_norm_partials_ref(g, g.flip(0), block=4096, ord=ord),
                rtol=2e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep,fuse", [("hybrid", True), ("jacobi", True),
                                        ("hybrid", False)])
@pytest.mark.parametrize("mode", ["pfait", "nfais2"])
def test_solve_single_on_card_matches_cpu(card, mode, sweep, fuse):
    n = 12
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode(mode, eps_tilde=1e-6, margin=10.0, staleness=3,
                             persistence=3, ord=INF)
    cfg = tfp.SolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=2000,
                           sweep=sweep, use_kernel=True, fuse_residual=fuse)
    b = make_rhs(n, seed=0)
    tk.reset_launches()
    gpu = tfp.solve_single(cfg, b, device=card)
    assert sum(tk.LAUNCHES.values()) >= 2 * gpu.outer_iters
    cpu = tfp.solve_single(cfg, b, device="cpu")
    assert gpu.converged and gpu.outer_iters == cpu.outer_iters
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), atol=1e-10, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4095, 16384])
def test_diff_norm_l1_at_pagerank_blocks_on_card(card, n):
    """The PageRank shard block (4096 f64: one partial, split over a
    cluster), a ragged n and a whole n = 16384 state, in l1: against the
    plain version, bitwise equal across calls, a NaN reaching its partial."""
    gen = torch.Generator(device=card).manual_seed(5)
    a = torch.rand((n,), generator=gen, device=card, dtype=torch.float64) / n
    b = a + 1e-13 * torch.rand((n,), generator=gen, device=card, dtype=torch.float64)
    got = trk.diff_norm_partials(a, b, ord=1.0)
    assert got.shape == (1,)
    for _ in range(3):
        assert torch.equal(got, trk.diff_norm_partials(a, b, ord=1.0))
    torch.testing.assert_close(got, trn_ref.diff_norm_partials_ref(a, b, ord=1.0),
                               rtol=2e-5, atol=0)
    b[n // 3] = float("nan")
    assert bool(trk.diff_norm_partials(a, b, ord=1.0).isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("reduction,mode", [("blocking", "sync"), ("nonblocking", "pfait"),
                                            ("rdoubling", "pfait"), ("nonblocking", "nfais2")])
def test_run_shard_pagerank_on_card_matches_cpu(card, reduction, mode):
    from repro_torch.runtime import api as tapi
    from repro_torch.solvers.pagerank import PageRankProblem

    n, p = 1024, 4
    prob = PageRankProblem(n=n, p=p, seed=0)
    mon = (detection.MonitorConfig(mode="sync", eps=1e-9, staleness=0, ord=1.0)
           if mode == "sync" else
           detection.for_mode(mode, eps_tilde=1e-9, margin=10.0, staleness=2, ord=1.0))
    knobs = {} if reduction == "blocking" else dict(
        inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2), contrib_lag=(0, 1, 0, 1))
    cfg = tapi.RuntimeConfig(monitor=mon, reduction=reduction, max_outer=500,
                             record_trace=True, **knobs)
    args = ("pagerank", cfg, p, n, np.full(n, 1.0 / n), prob.to_dense())
    trk.reset_launches()
    gpu = tapi.run_shard(*args, damping=prob.d, device=card)
    launches = trk.LAUNCHES["diff_norm_partials"]
    cpu = tapi.run_shard(*args, damping=prob.d, device="cpu")
    assert gpu.converged and gpu.outer_iters == cpu.outer_iters
    assert gpu.detect_step == cpu.detect_step
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), atol=1e-12, rtol=0)
    np.testing.assert_allclose(gpu.residual_history, cpu.residual_history, rtol=5e-5)
    assert prob.exact_residual([gpu.x.cpu().numpy()]) < 1e-9
    gpu.trace.validate()
    # a build run and a timed run, each launching #5 once per shard and step
    assert launches == (0 if reduction == "blocking" else 2 * p * gpu.outer_iters)


@pytest.mark.cuda
@pytest.mark.parametrize("reduction,sweep", [("nonblocking", "jacobi"),
                                             ("nonblocking", "hybrid"),
                                             ("blocking", "jacobi"),
                                             ("rdoubling", "jacobi")])
def test_shard_runtime_on_card_matches_cpu(card, reduction, sweep):
    n, p = 12, 4
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, ord=INF)
    knobs = {} if reduction == "blocking" else dict(
        inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 2, 1), contrib_lag=(0, 1, 0, 1))
    cfg = tsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, sweep=sweep,
                                 max_outer=2000, trace_len=64, **knobs)
    b = make_rhs(n, seed=0)
    x0 = np.zeros_like(b)
    trk.reset_launches()
    gpu = tsr.make_convdiff_runtime(cfg, p, st, n, device=card)(x0, b)
    cpu = tsr.make_convdiff_runtime(cfg, p, st, n, device="cpu")(x0, b)
    assert gpu.converged and gpu.outer_iters == cpu.outer_iters
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(gpu.trace.cpu().numpy(), cpu.trace.numpy(), rtol=5e-5)
    if reduction != "blocking" and sweep == "jacobi":
        assert trk.LAUNCHES["diff_norm_partials"] == p * gpu.outer_iters


@pytest.mark.cuda
@pytest.mark.parametrize("backend,k,shape", [("gloo", 4, (2, 2)), ("gloo", 2, (2,)),
                                             ("nccl", 1, (1,))])
def test_world_on_card_equals_stacked_on_card(card, tmp_path, backend, k, shape):
    """One shard per rank on the card (gloo ranks share it and stage through
    host memory; NCCL at world size 1) against the stacked runtime on the
    card: same iterations, x and the l∞ trace bitwise, launches in the
    ranks, bytes staged under gloo only."""
    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import Case, Inputs, make_inputs, run_cases

    n = 12
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, ord=INF)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, max_outer=2000, trace_len=64,
                                 overlap=len(shape) > 1, inner_sweeps=2)
    case = Case("card", "runtime", cfg, shape, Inputs("convdiff", n))
    ranks = spawn_world(run_cases, k, str(tmp_path), args=(backend, [case], None),
                        timeout=300)
    x0, b, kw = make_inputs(case.inputs)
    want = tsr.make_convdiff_runtime(cfg, shape if len(shape) > 1 else shape[0],
                                     kw["stencil"], n, device=card)(x0, b)
    got = ranks[0]["cases"][0]
    assert got["outer_iters"] == want.outer_iters and got["converged"]
    np.testing.assert_array_equal(got["x"], want.x.cpu().numpy())
    np.testing.assert_array_equal(got["trace"], want.trace.cpu().numpy())
    for r in ranks:
        c = r["cases"][0]
        assert sum(c["launches"].values()) > 0
        assert sum(c["launch_shapes"].values()) > 0
        assert (c["staged_bytes"] > 0) == (backend == "gloo" and k > 1)


def _halo_planes(shape, gen, card, dtype):
    bx, by, bz = shape
    return [torch.rand(s, generator=gen, device=card, dtype=dtype) for s in
            ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by))]


@pytest.mark.cuda
def test_halo_kernels_match_plain_on_card(card):
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(1)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for shape in ((13, 37, 19), (1, 6, 9), (5, 1, 33)):
            x = torch.rand(shape, generator=gen, device=card, dtype=dtype)
            b = torch.rand(shape, generator=gen, device=card, dtype=dtype)
            h = _halo_planes(shape, gen, card, dtype)
            for ord in ORDS:
                for op in ("sweep", "residual"):
                    got = tk.fused_sweep_residual_halo(x, h, b, st.coefs, op=op, ord=ord)
                    want = tref.fused_sweep_residual_halo_ref(x, h, b, st.coefs, op=op,
                                                              ord=ord)
                    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
                    torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=0)
                for oxyz in (0, 1, 5):
                    got = tk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, oxyz,
                                                            ord=ord)
                    want = tref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, oxyz,
                                                                   ord=ord)
                    torch.testing.assert_close(got[0], want[0], rtol=tol, atol=tol)
                    torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=0)


@pytest.mark.cuda
def test_halo_kernel_face_slab_is_bitwise_the_block_face(card):
    """The comm overlap's premise: a thickness-1 slab swept by the halo
    kernel gives bitwise the face of the whole block's sweep — at a small
    block and at the (3, 2) mesh's 50×75×150 block, where the grid splits
    each tile over a cluster (and the x slab's does too)."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(2)
    for shape in ((6, 7, 40), (50, 75, 150)):
        x = torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
        b = torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
        h = _halo_planes(shape, gen, card, torch.float64)
        full, _ = tk.fused_sweep_residual_halo(x, h, b, st.coefs)
        for d in range(3):
            for idx in (0, shape[d] - 1):
                sg = []
                for e in range(3):
                    if e == d:
                        sg += [h[2 * d] if idx == 0 else x.select(d, idx - 1),
                               x.select(d, idx + 1) if idx == 0 else h[2 * d + 1]]
                    else:
                        pos = d if d < e else d - 1
                        sg += [h[2 * e].narrow(pos, idx, 1), h[2 * e + 1].narrow(pos, idx, 1)]
                slab, _ = tk.fused_sweep_residual_halo(
                    x.narrow(d, idx, 1).contiguous(), sg, b.narrow(d, idx, 1).contiguous(),
                    st.coefs)
                assert torch.equal(slab, full.narrow(d, idx, 1)), (shape, d, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 1024), (3, 37, 19)])
def test_halo_kernel_at_the_1d_planes_matches_the_ghosted_kernel(card, shape):
    """#3 on a block and the 1-D runtime's planes (two x faces, four zero
    planes) against #1 on the block ``ghost_pad1`` assembles from the same
    planes, at the solver cell's shard block and a ragged one, f64 and
    f32, both ops, every partial mode.  Not bitwise: #1 is compiled with
    FMA contraction and #3 with round-to-nearest intrinsics that are never
    contracted, so an update differs in its last bits and an f32 partial
    sums slightly different values in the same order.  Held at
    ``test_halo_kernels_match_plain_on_card``'s bars: blocks 1e-12 (f64) /
    1e-5 (f32) of the largest, partials 2e-5 relative."""
    from repro_torch.kernels.jacobi3d import ops as jops

    st = Stencil.for_contraction(1024, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(7)
    bx, by, bz = shape
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        x, b = (torch.rand(shape, generator=gen, device=card, dtype=dtype) for _ in range(2))
        gxm, gxp = (torch.rand((by, bz), generator=gen, device=card, dtype=dtype)
                    for _ in range(2))
        zy = torch.zeros((bx, by), device=card, dtype=dtype)   # by == bz or not: y and z
        zz = torch.zeros((bx, bz), device=card, dtype=dtype)
        halos = (gxm, gxp, zz, zz, zy, zy)
        g = jops.ghost_pad1(x, (gxm, gxp, zz, zz))
        for ord in ORDS:
            for op in ("sweep", "residual"):
                got = tk.fused_sweep_residual_halo(x, halos, b, st.coefs, op=op, ord=ord)
                want = tk.fused_sweep_residual(g, b, st.coefs, op=op, ord=ord)
                assert _rel_close(got[0], want[0], tol), (shape, dtype, ord, op)
                torch.testing.assert_close(got[1], want[1], rtol=2e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1024, 1024), (3, 37, 19)])
def test_halo_kernel_reports_its_meta_work_on_card(card, shape):
    """#3's work reported at a launch on the card equals what its ``meta``
    path reports and ``work_halo``, both ops, f64 and f32."""
    from repro_torch.kernels import _build

    def reported(fn):
        sink = [0.0, 0.0]
        _build.WORK_SINKS.append(sink)
        try:
            fn()
        finally:
            _build.WORK_SINKS.remove(sink)
        return tuple(sink)

    st = Stencil.for_contraction(1024, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(8)
    for dtype in (torch.float64, torch.float32):
        x, b = (torch.rand(shape, generator=gen, device=card, dtype=dtype) for _ in range(2))
        h = _halo_planes(shape, gen, card, dtype)
        xm, bm = (torch.empty_like(t, device="meta") for t in (x, b))
        hm = [torch.empty_like(t, device="meta") for t in h]
        for op in ("sweep", "residual"):
            on_card = reported(lambda: tk.fused_sweep_residual_halo(x, h, b, st.coefs, op=op))
            on_meta = reported(lambda: tk.fused_sweep_residual_halo(xm, hm, bm, st.coefs, op=op))
            assert on_card == on_meta == tk.work_halo(shape, x.element_size(), op)


def _rel_close(got, want, tol):
    """max|got − want| ≤ tol × max|want|: chip_smoke.py's bar."""
    g, w = got.double(), want.double()
    return float((g - w).abs().max()) <= tol * max(float(w.abs().max()), 1e-30)


# chip_smoke.py's tolerances: blocks (f64 FMA contraction, f32 rounding), and
# partials (l∞ max of f32-cast values, l2 and l1 f32 summation order)
_BLOCK_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _part_tol(dtype, ord):
    if ord != INF:
        return 2e-5
    return 1e-6 if dtype == torch.float64 else 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((50, 75, 150), [(4, 8)]), ((75, 75, 75), [(4, 8)]), ((25, 150, 150), [(4, 8)]),
    ((1, 75, 150), [(4, 8)]), ((185, 185, 185), [(4, 8)]),
    ((13, 37, 19), [(4, 8), (3, 5), (8, 128)]),
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_halo_sweep_split_and_unsplit_grids_on_card(card, shape, tiles, dtype):
    """#3 with each tile split over a cluster (the mesh blocks, the shard
    block, the x overlap slab) and with one CTA per tile (185³, the
    ragged block, tiles that do not divide it): against the plain
    version, and its partials bitwise equal across two calls."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(5)
    x = torch.rand(shape, generator=gen, device=card, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, device=card, dtype=dtype) * 2 - 1
    h = _halo_planes(shape, gen, card, dtype)
    for tile in tiles:
        for ord in ORDS:
            for op in ("sweep", "residual"):
                got = tk.fused_sweep_residual_halo(x, h, b, st.coefs, tile=tile, op=op,
                                                   ord=ord)
                again = tk.fused_sweep_residual_halo(x, h, b, st.coefs, tile=tile, op=op,
                                                     ord=ord)
                want = tref.fused_sweep_residual_halo_ref(x, h, b, st.coefs, tile=tile,
                                                          op=op, ord=ord)
                assert _rel_close(got[0], want[0], _BLOCK_TOL[dtype]), (tile, ord, op)
                assert got[1].shape == want[1].shape
                assert _rel_close(got[1], want[1], _part_tol(dtype, ord)), (tile, ord, op)
                assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((185, 185, 185), [(4, 8)]), ((25, 150, 150), [(4, 8)]), ((75, 150, 150), [(4, 8)]),
    ((13, 37, 19), [(4, 8), (3, 5), (8, 128)]),
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rbgs_sweep_split_and_unsplit_grids_on_card(card, shape, tiles, dtype):
    """#2 over sub-boxes split to fill the card (the shard block), split
    only for its shared-memory ring (185³, 75×150×150) and unsplit (the
    ragged block; a tall tile that takes more sub-boxes than a cluster
    holds CTAs): both checkerboard phases against the plain version, and
    its partials bitwise equal across two calls."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(6)
    bx, by, bz = shape
    g2 = torch.rand((bx + 4, by + 4, bz + 2), generator=gen, device=card, dtype=dtype)
    b = torch.rand(shape, generator=gen, device=card, dtype=dtype)
    for tile in tiles:
        for oxy in (0, 1):
            for ord in ORDS:
                got = tk.fused_rbgs_sweep_residual(g2, b, st.coefs, oxy, tile=tile, ord=ord)
                again = tk.fused_rbgs_sweep_residual(g2, b, st.coefs, oxy, tile=tile,
                                                     ord=ord)
                want = tref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, oxy, tile=tile,
                                                          ord=ord)
                assert _rel_close(got[0], want[0], _BLOCK_TOL[dtype]), (tile, oxy, ord)
                assert got[1].shape == want[1].shape
                assert _rel_close(got[1], want[1], _part_tol(dtype, ord)), (tile, oxy, ord)
                assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((75, 75, 75), [(4, 8)]), ((185, 185, 185), [(4, 8)]), ((50, 75, 150), [(4, 8)]),
    ((13, 37, 19), [(4, 8), (3, 5), (8, 128)]),
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_halo_rbgs_split_and_unsplit_grids_on_card(card, shape, tiles, dtype):
    """#4 over sub-boxes split to fill the card (75³, the (3, 2) mesh
    block), split only for its shared-memory ring (185³) and unsplit (the
    ragged block; a tall tile that takes more sub-boxes than a cluster
    holds CTAs): three phases against the plain version, and its partials
    bitwise equal across two calls."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(8)
    x = torch.rand(shape, generator=gen, device=card, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, device=card, dtype=dtype) * 2 - 1
    h = _halo_planes(shape, gen, card, dtype)
    for tile in tiles:
        for oxyz in (0, 1, 5):
            for ord in ORDS:
                got = tk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, oxyz, tile=tile,
                                                        ord=ord)
                again = tk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, oxyz,
                                                          tile=tile, ord=ord)
                want = tref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, oxyz,
                                                               tile=tile, ord=ord)
                assert _rel_close(got[0], want[0], _BLOCK_TOL[dtype]), (tile, oxyz, ord)
                assert got[1].shape == want[1].shape
                assert _rel_close(got[1], want[1], _part_tol(dtype, ord)), (tile, oxyz, ord)
                assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,tiles", [
    ((25, 150, 150), [(4, 8)]), ((75, 150, 150), [(4, 8)]), ((185, 185, 185), [(4, 8)]),
    ((13, 37, 19), [(4, 8), (3, 5), (8, 128)]),
])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jacobi_sweep_split_and_unsplit_grids_on_card(card, shape, tiles, dtype):
    """#1 with each tile split over a cluster (the 1-D shard blocks at p = 6
    and p = 2) and with one CTA per tile (185³, the ragged block, tiles
    that do not divide it): sweep and residual-only pass against the plain
    version, and its partials bitwise equal across two calls."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(9)
    bx, by, bz = shape
    g = torch.rand((bx + 2, by + 2, bz + 2), generator=gen, device=card, dtype=dtype) * 2 - 1
    b = torch.rand(shape, generator=gen, device=card, dtype=dtype) * 2 - 1
    for tile in tiles:
        for ord in ORDS:
            for op in ("sweep", "residual"):
                got = tk.fused_sweep_residual(g, b, st.coefs, tile=tile, op=op, ord=ord)
                again = tk.fused_sweep_residual(g, b, st.coefs, tile=tile, op=op, ord=ord)
                want = tref.fused_sweep_residual_ref(g, b, st.coefs, tile=tile, op=op,
                                                     ord=ord)
                assert _rel_close(got[0], want[0], _BLOCK_TOL[dtype]), (tile, ord, op)
                assert got[1].shape == want[1].shape
                assert _rel_close(got[1], want[1], _part_tol(dtype, ord)), (tile, ord, op)
                assert torch.equal(got[1], again[1]) and torch.equal(got[0], again[0])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(50, 75, 150), (25, 150, 150), (185, 185, 185), (13, 37, 19),
                                   (75, 75, 75)])
def test_stencil_nan_reaches_linf_partials_on_card(card, shape):
    """A NaN in the block reaches the l∞ partials of #1–#4 exactly where it
    reaches the plain version's, split grid or not."""
    st = Stencil.for_contraction(185, 1.0, (1.0, 1.0, 1.0), 0.95)
    gen = torch.Generator(device=card).manual_seed(7)
    bx, by, bz = shape
    i, j, z = bx // 2, by // 3, bz - 1
    x = torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
    b = torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
    h = _halo_planes(shape, gen, card, torch.float64)
    x[i, j, z] = float("nan")
    got = tk.fused_sweep_residual_halo(x, h, b, st.coefs)[1].isnan()
    want = tref.fused_sweep_residual_halo_ref(x, h, b, st.coefs)[1].isnan()
    assert bool(want.any()) and torch.equal(got, want)
    for oxyz in (0, 1):
        got = tk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, oxyz)[1].isnan()
        want = tref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, oxyz)[1].isnan()
        assert bool(want.any()) and torch.equal(got, want)
    g = torch.rand((bx + 2, by + 2, bz + 2), generator=gen, device=card, dtype=torch.float64)
    g[i + 1, j + 1, z + 1] = float("nan")
    got = tk.fused_sweep_residual(g, b, st.coefs)[1].isnan()
    want = tref.fused_sweep_residual_ref(g, b, st.coefs)[1].isnan()
    assert bool(want.any()) and torch.equal(got, want)
    g2 = torch.rand((bx + 4, by + 4, bz + 2), generator=gen, device=card, dtype=torch.float64)
    g2[i + 2, j + 2, z + 1] = float("nan")
    for oxy in (0, 1):
        got = tk.fused_rbgs_sweep_residual(g2, b, st.coefs, oxy)[1].isnan()
        want = tref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, oxy)[1].isnan()
        assert bool(want.any()) and torch.equal(got, want)


MESH_KNOBS = dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 2, 1),
                  contrib_lag=(0, 1, 0, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,reduction,sweep,overlap", [
    ((2, 2), "nonblocking", "jacobi", True),
    ((2, 1, 2), "nonblocking", "hybrid", False),
    ((2, 2), "blocking", "jacobi", False),
    ((2, 2, 2), "rdoubling", "jacobi", False),
])
def test_mesh_runtime_on_card_matches_cpu(card, shape, reduction, sweep, overlap):
    n = 12
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, ord=INF)
    knobs = MESH_KNOBS if len(shape) == 2 and reduction != "blocking" else {}
    cfg = tsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, sweep=sweep,
                                 max_outer=2000, trace_len=64, overlap=overlap, **knobs)
    b = make_rhs(n, seed=0)
    x0 = np.zeros_like(b)
    tk.reset_launches()
    gpu = tsr.make_convdiff_runtime(cfg, shape, st, n, device=card)(x0, b)
    kernel = "fused_rbgs_sweep_residual_halo" if sweep == "hybrid" else \
        "fused_sweep_residual_halo"
    assert tk.LAUNCHES[kernel] >= gpu.outer_iters
    cpu = tsr.make_convdiff_runtime(cfg, shape, st, n, device="cpu")(x0, b)
    assert gpu.converged and gpu.outer_iters == cpu.outer_iters
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), atol=1e-10, rtol=0)
    np.testing.assert_allclose(gpu.trace.cpu().numpy(), cpu.trace.numpy(), rtol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["solve_single", "1-D p=4 nonblocking", "mesh (2,2) blocking",
                                  "mesh (2,1,2) hybrid"])
def test_l1_paths_on_card_match_cpu(card, path):
    """ord 1 on the card: every path launches its kernels in their l1 mode
    (nothing falls back to plain torch) and takes the CPU's iterations,
    x within 1e-10 and the trace within rtol 5e-5."""
    n = 12
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode("pfait", eps_tilde=1e-4, margin=10.0, ord=1.0)
    b = make_rhs(n, seed=0)
    x0 = np.zeros_like(b)
    if path == "solve_single":
        cfg = tfp.SolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=2000)
        run = lambda dev: tfp.solve_single(cfg, b, device=dev)  # noqa: E731
    else:
        p, kw = {"1-D p=4 nonblocking": (4, MESH_KNOBS),
                 "mesh (2,2) blocking": ((2, 2), dict(reduction="blocking")),
                 "mesh (2,1,2) hybrid": ((2, 1, 2), dict(sweep="hybrid"))}[path]
        cfg = tsr.ShardRuntimeConfig(monitor=mon, max_outer=2000, trace_len=64, **kw)
        run = lambda dev: tsr.make_convdiff_runtime(cfg, p, st, n, device=dev)(x0, b)  # noqa: E731
    tk.reset_launches()
    trk.reset_launches()
    gpu = run(card)
    assert sum(tk.LAUNCHES.values()) >= gpu.outer_iters
    cpu = run("cpu")
    assert gpu.converged and gpu.outer_iters == cpu.outer_iters
    np.testing.assert_allclose(gpu.x.cpu().numpy(), cpu.x.numpy(), atol=1e-10, rtol=0)
    if path != "solve_single":
        np.testing.assert_allclose(gpu.trace.cpu().numpy(), cpu.trace.numpy(), rtol=5e-5)


@pytest.mark.cuda
def test_mesh_overlap_bitwise_on_card(card):
    n = 12
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, ord=INF)
    b = make_rhs(n, seed=1)
    r0, r1 = (tsr.make_convdiff_runtime(
        tsr.ShardRuntimeConfig(monitor=mon, max_outer=2000, trace_len=64, overlap=ov,
                               **MESH_KNOBS), (2, 2), st, n, device=card)(np.zeros_like(b), b)
        for ov in (False, True))
    assert r0.converged and r0.outer_iters == r1.outer_iters
    assert torch.equal(r0.x, r1.x) and torch.equal(r0.trace, r1.trace)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BN,S,H,causal,window", [
    (12, 2, 200, 128, True, 0), (8, 4, 256, 64, True, 0), (4, 4, 256, 128, False, 0),
    (6, 2, 384, 64, True, 128), (6, 1, 77, 16, True, 0), (4, 2, 130, 32, False, 40),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_card(card, BH, BN, S, H, causal, window, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((n, S, H), generator=gen, device=card).to(dtype)
               for n in (BH, BN, BN))
    tfk.reset_launches()
    got = tfk.flash_attention_flat(q, k, v, causal=causal, window=window)
    assert tfk.LAUNCHES["flash_attention_flat"] == 1
    want = tflash_ref(q, k, v, causal=causal, window=window)
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    err = float((got.float() - want.float()).abs().max())
    assert got.dtype == dtype and err <= tol * float(want.float().abs().max())
    if dtype == torch.bfloat16:
        bar = bf16_output_bar(want, q, k, v, causal=causal, window=window)
        assert bool(((got.double() - want.double()).abs() <= bar).all())
    # the model layout through the dispatcher, against the blocked plain version
    B, N = BN, 1
    qm = q.reshape(B, BH // BN, S, H).movedim(2, 1)[:, :, None]     # [B,S,1,P,H]
    km, vm = k[:, :, None], v[:, :, None]
    got = tflash_ops.flash_attention(qm, km, vm, causal=causal, window=window)
    want = tattention_fwd(qm, km, vm, causal=causal, window=window)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max())


@pytest.mark.cuda
def test_reduced_serve_on_card_matches_cpu(card, monkeypatch):
    arch = "qwen2-1.5b-f32-card-test"
    cfg = reduced(treg.get_arch("qwen2-1.5b"), dtype="float32", name=arch)
    monkeypatch.setitem(treg.ARCHS, arch, cfg)
    prompts = tserve.make_prompts(cfg.vocab_size, 3, 70, 0)
    outs = []
    for dev in (card, "cpu"):
        m = Model(cfg, device=dev)
        params = m.init(torch.Generator().manual_seed(0))   # CPU draws: the same weights
        tfk.reset_launches()
        outs.append(tserve.generate(m, params, prompts, 12))
        launches = tfk.LAUNCHES["flash_attention_flat"]
        assert launches == (cfg.num_layers if m.device.type == "cuda" else 0)
    gpu, cpu = outs
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])
    assert gpu["steps"] == cpu["steps"] and gpu["stopped_by"] == cpu["stopped_by"]
    out = tserve.serve("qwen2-1.5b", batch=2, prompt_len=40, max_new=6)   # bf16, on the card
    assert out["tokens"].shape == (2, 6)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "llama4-maverick-400b-a17b", "mamba2-130m",
                                  "hymba-1.5b", "musicgen-medium", "llava-next-34b"])
def test_reduced_family_serve_on_card_matches_cpu(card, arch):
    """Every other family, reduced and in f32, served on the card and on
    the CPU from the same weights: the same tokens, and #6 once a layer
    with attention in the card's prefill."""
    cfg = reduced(treg.get_arch(arch), dtype="float32")
    prompts = tserve.make_prompts(cfg.vocab_size, 2, 64, 0,
                                  cfg.frontend_dim if cfg.frontend else 0)
    outs = []
    for dev in (card, "cpu"):
        m = Model(cfg, device=dev)
        params = m.init(torch.Generator().manual_seed(0))   # CPU draws: the same weights
        tfk.reset_launches()
        outs.append(tserve.generate(m, params, prompts, 8))
        on_card = m.device.type == "cuda" and cfg.has_attention
        assert tfk.LAUNCHES["flash_attention_flat"] == (cfg.num_layers if on_card else 0)
    gpu, cpu = outs
    np.testing.assert_array_equal(gpu["tokens"], cpu["tokens"])
    assert gpu["steps"] == cpu["steps"] and gpu["logits_finite"]


def _flash_against_plain(card, BH, BN, S, H, causal, window, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    q, k, v = (torch.randn((n, S, H), generator=gen, device=card).to(dtype)
               for n in (BH, BN, BN))
    tfk.reset_launches()
    got = tfk.flash_attention_flat(q, k, v, causal=causal, window=window)
    assert tfk.LAUNCHES["flash_attention_flat"] == 1 and got.dtype == dtype
    want = tflash_ref(q, k, v, causal=causal, window=window)
    err = float((got.double() - want.double()).abs().max())
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    assert err <= tol * float(want.double().abs().max())
    return q, k, v, got, want


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 100, 1000, 2048])
@pytest.mark.parametrize("H", [16, 32, 64, 128])
def test_flash_bf16_tensor_core_kernel_on_card(card, H, S):
    """Every head dim, a tile shorter than the 128-row q tile (S = 1, 100)
    and a ragged last tile (1000); the bar still fails a dropped kv tile."""
    q, k, v, got, want = _flash_against_plain(card, 12, 2, S, H, True, 0, torch.bfloat16)
    bar = bf16_output_bar(want, q, k, v)
    assert bool(((got.double() - want.double()).abs() <= bar).all())
    if S > 128:
        dropped = tflash_ref(q, k, v, causal=True, window=S - 64)
        assert bool(((dropped.double() - want.double()).abs() > bar).any())


@pytest.mark.cuda
@pytest.mark.parametrize("BH,BN,S,H,causal,window", [
    (12, 2, 1000, 128, True, 100), (12, 4, 777, 64, False, 0), (4, 2, 130, 32, False, 40),
    (6, 1, 2048, 128, True, 2000), (8, 8, 300, 16, False, 0),
])
def test_flash_bf16_window_and_non_causal_on_card(card, BH, BN, S, H, causal, window):
    q, k, v, got, want = _flash_against_plain(card, BH, BN, S, H, causal, window,
                                              torch.bfloat16)
    bar = bf16_output_bar(want, q, k, v, causal=causal, window=window)
    assert bool(((got.double() - want.double()).abs() <= bar).all())


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,causal,window", [(1000, 128, True, 0), (1000, 64, False, 0),
                                               (300, 16, True, 40)])
def test_flash_f32_stays_on_the_f32_kernel(card, S, H, causal, window):
    """f32 inputs keep full f32 products: within 2e-5 of the largest
    magnitude, which a bf16 or TF32 tensor-core product would miss."""
    _flash_against_plain(card, 12, 2, S, H, causal, window, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((25, 150, 150), 65536), ((25, 150, 150), 4097),
                                         ((13, 37, 19), 65536), ((70001,), 65536),
                                         ((185, 185, 185), 65536)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
def test_diff_norm_split_partials_on_card(card, shape, block, dtype):
    """The shard block, a block the per-partial split does not divide, n <
    block, a ragged last partial and 185³: against the plain version, and
    bitwise equal across two calls."""
    gen = torch.Generator(device=card).manual_seed(3)
    a, b = (torch.rand(shape, generator=gen, device=card, dtype=torch.float64).to(dtype)
            for _ in range(2))
    for ord, rtol in ((INF, 1e-6), (2.0, 2e-5), (1.0, 2e-5)):
        got = trk.diff_norm_partials(a, b, block=block, ord=ord)
        assert torch.equal(got, trk.diff_norm_partials(a, b, block=block, ord=ord))
        want = trn_ref.diff_norm_partials_ref(a, b, block=block, ord=ord)
        torch.testing.assert_close(got, want, rtol=rtol, atol=0)


@pytest.mark.cuda
def test_diff_norm_nan_propagates_on_card(card):
    a = torch.rand((25, 150, 150), device=card, dtype=torch.float64)
    b = a.clone()
    b.view(-1)[70000] = float("nan")            # in partial 1 of 9
    for ord in ORDS:
        got = trk.diff_norm_partials(a, b, ord=ord)
        assert got.isnan().tolist() == [i == 1 for i in range(9)]


# ---------------------------------------------------------------------------
# detection lanes: the lane runner on the card (one CUDA graph per runner)
# ---------------------------------------------------------------------------

LANE_FAMILIES = [("convdiff", {"n": 12, "p": 4, "rho": 0.9, "sweep": "jacobi"}),
                 ("convdiff", {"n": 12, "p": 4, "rho": 0.9, "sweep": "hybrid"}),
                 ("pagerank", {"n": 256, "p": 4}),
                 ("mlfixed", {"n": 64, "p": 4, "m_rows": 192, "task": "lstsq", "cond": 10.0}),
                 ("mlfixed", {"n": 64, "p": 4, "m_rows": 192, "task": "logistic",
                              "cond": 10.0})]


def _lanes(family, kw, seeds, device):
    """The problems of ``seeds`` and a two-lane bucket's buffers for the
    first two: X, operands, lane state and the per-lane ε / ε̃ / K / m (lane
    0 detects, lane 1 never: ε = −1)."""
    probs = [tserve.make_serve_problem(family, seed=s, **kw) for s in seeds]
    X = torch.as_tensor(np.stack([p.lane_x0() for p in probs[:2]]), device=device)
    ops = {k: torch.as_tensor(np.stack([np.asarray(p.lane_operands()[k], np.float32)
                                        for p in probs[:2]]), device=device)
           for k in probs[0].lane_operands()}
    f32 = dict(dtype=torch.float32, device=device)
    params = (torch.tensor([1e-4, -1.0], **f32), torch.tensor([1e-3, -1.0], **f32),
              torch.tensor([2, 0], dtype=torch.int32, device=device),
              torch.tensor([2, 1], dtype=torch.int32, device=device))
    return probs, X, ops, detection.init_lanes(2, 4, device), params


def _runner(probs):
    p0 = probs[0]
    return detection.make_lane_runner(
        "nfais5", lambda X, o: p0.update_with_residual_batched(X, **o), 16, ord=float(p0.ord))


# Card series against CPU series, after σ: rtol 1e-5 for a max (convdiff's
# l∞), 2e-5 for a sum, plus twice the family's f32 residual floor at these
# sizes (the largest σ over the last 512 of 2048 lane steps of seeds 0 and
# 1 on the CPU plain path: convdiff 7.2e-7, PageRank 2.8e-9, mlfixed
# 2.0e-7) and four f32 units of the first residual: near the floor the
# kernels and the plain versions round differently, and the first residual
# sets the scale of the terms a step sums.
LANE_RTOL = {"convdiff": 1e-5, "pagerank": 2e-5, "mlfixed": 2e-5}
LANE_FLOOR = {"convdiff": 7.2e-7, "pagerank": 2.8e-9, "mlfixed": 2.0e-7}


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", LANE_FAMILIES)
def test_lane_runner_on_card_matches_cpu(card, family, kw):
    """Three chunks replayed from the card's graph against the same chunks
    eagerly on the CPU (the plain versions): states within rtol 1e-5, the
    σ-applied series within the family's ``LANE_RTOL`` plus twice its
    ``LANE_FLOOR`` and 4·2^-24 of its first residual, the same checks
    counted."""
    _, Xc, opsc, stc, pc = _lanes(family, kw, (0, 1), "cpu")
    probs, X, ops, st, p = _lanes(family, kw, (0, 1), card)
    run_card, run_cpu = _runner(probs), _runner(probs)
    ord_, atol = float(probs[0].ord), None
    for _ in range(3):
        got = tserve._sigma_np(run_card(X, ops, st, *p)[2].cpu().numpy(), ord_)
        want = tserve._sigma_np(run_cpu(Xc, opsc, stc, *pc)[2].numpy(), ord_)
        if atol is None:
            atol = 2 * LANE_FLOOR[family] + 4 * 2.0 ** -24 * float(want[:, 0].max())
        np.testing.assert_allclose(got, want, rtol=LANE_RTOL[family], atol=atol)
    assert run_card.captured is not None and run_cpu.captured is None
    torch.testing.assert_close(X.cpu(), Xc, rtol=1e-5, atol=1e-6)
    assert torch.equal(st.step.cpu(), stc.step)


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", LANE_FAMILIES)
def test_lane_graph_replay_is_bitwise_eager_with_refill(card, family, kw):
    """A chunk replayed from the graph is bitwise the chunk run eagerly on
    the card; lane 1 refilled in place between two replays (another seed)
    leaves lane 0 bitwise; each replay counts its kernel launches."""
    probs, X, ops, st, p = _lanes(family, kw, (0, 1, 2), card)
    X2, ops2 = X.clone(), {k: v.clone() for k, v in ops.items()}
    st2 = detection.LaneState(*(t.clone() for t in st))
    graph = _runner(probs)
    counters = {**tk.LAUNCHES, **trk.LAUNCHES}
    for r in range(2):
        cg, ce = graph(X, ops, st, *p)[2], graph.run_eager(X2, ops2, st2, *p)[2]
        assert torch.equal(cg, ce) and torch.equal(X, X2)
        assert all(torch.equal(a, b) for a, b in zip(st, st2))
        if r == 0:
            lane0 = [X[0].clone()] + [t[0].clone() for t in st]
            for XX, OO, SS in ((X, ops, st), (X2, ops2, st2)):
                XX[1].copy_(torch.as_tensor(probs[2].lane_x0()))
                for k, v in probs[2].lane_operands().items():
                    OO[k][1].copy_(torch.as_tensor(np.asarray(v, np.float32)))
                for dst, src in zip(SS, detection.reset_lanes(SS, [False, True])):
                    dst.copy_(src)
            assert torch.equal(X[0], lane0[0])
            assert all(torch.equal(t[0], v) for t, v in zip(st, lane0[1:]))
    # a step launches a stencil kernel per lane (convdiff) or #5 once
    # (PageRank); the capture's warm-up step launches once, each replay and
    # each eager chunk 16 steps' worth
    kernel, per_step = {"jacobi": ("fused_sweep_residual", 2),
                        "hybrid": ("fused_rbgs_sweep_residual", 2)}.get(
        kw.get("sweep"), ("diff_norm_partials", 1 if family == "pagerank" else 0))
    made = {k: v - counters[k] for k, v in {**tk.LAUNCHES, **trk.LAUNCHES}.items()}
    assert made == {k: (per_step * (1 + 4 * 16) if k == kernel else 0) for k in made}
    with pytest.raises(ValueError, match="captured"):
        graph(X2, ops2, st2, *p)


# ---------------------------------------------------------------------------
# The training and elastic paths' #5 shapes, and the two drivers on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((4, 1024), 1024), ((1, 1024), 1024), ((1024,), 65536),
                                         ((8192,), 65536), ((30, 150, 150), 65536)])
@pytest.mark.parametrize("ord", ORDS)
def test_diff_norm_train_and_elastic_shapes_on_card(card, shape, block, ord):
    gen = torch.Generator(device=card).manual_seed(3)
    a = torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
    b = a + 1e-9 * torch.rand(shape, generator=gen, device=card, dtype=torch.float64)
    got = trk.diff_norm_partials(a, b, block=block, ord=ord)
    want = trn_ref.diff_norm_partials_ref(a, b, block=block, ord=ord)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-6 if np.isinf(ord) else 2e-5, atol=0)
    assert torch.equal(got, trk.diff_norm_partials(a, b, block=block, ord=ord))


@pytest.mark.cuda
@pytest.mark.parametrize("reduction", ["blocking", "nonblocking"])
def test_train_runtime_on_card_matches_cpu(card, reduction):
    from repro_torch.runtime import train_async as tta
    from repro_torch.solvers.mlfixed import MLFixedPointProblem

    prob = MLFixedPointProblem(n=64, p=4, m_rows=1024, task="lstsq", cond=10.0, seed=0)
    gamma = tta.safe_gamma(prob, 4, 2, device=card)
    assert gamma == pytest.approx(tta.safe_gamma(prob, 4, 2, device="cpu"), rel=1e-10)
    mon = detection.for_mode("pfait", eps_tilde=1e-8, margin=10.0, staleness=2)
    knobs = {} if reduction == "blocking" else dict(
        inner_steps=(2, 4, 2, 4), view_delay=(0, 1, 0, 2), contrib_lag=(0, 1, 0, 1))
    cfg = tta.TrainAsyncConfig(monitor=mon, reduction=reduction, num_batches=2,
                               gamma=gamma, max_rounds=5000, trace_len=64,
                               **({"inner_steps": 2} | knobs))
    before = trk.LAUNCHES["diff_norm_partials"]
    got = tta.make_train_runtime(prob, cfg, 4, device=card)(
        tta.init_replicas(prob, 4), prob.A, prob.y)
    assert trk.LAUNCHES["diff_norm_partials"] - before == got.rounds
    want = tta.make_train_runtime(prob, cfg, 4, device="cpu")(
        tta.init_replicas(prob, 4), prob.A, prob.y)
    assert got.converged and want.converged and got.rounds == want.rounds
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_elastic_on_card_matches_cpu(card, tmp_path):
    from repro_torch.runtime import elastic as tel

    n = 24
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    b = make_rhs(n, seed=0)
    mon = detection.for_mode("pfait", eps_tilde=1e-6, margin=10.0, staleness=2,
                             persistence=4, ord=INF)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, inner_sweeps=2, halo_delay=1, contrib_lag=1)
    plan = tel.FaultPlan(crash_at={1: 3}, join_at={1: 8})
    kw = dict(stencil=st, slots=4, segment_len=10, ckpt_every=2, max_segments=60)
    got = tel.run_elastic("convdiff", cfg, n, np.zeros_like(b), b, plan, str(tmp_path / "a"),
                          device=card, **kw)
    want = tel.run_elastic("convdiff", cfg, n, np.zeros_like(b), b, plan, str(tmp_path / "b"),
                           device="cpu", **kw)
    assert got.converged and got.events == want.events
    assert got.mesh_history == want.mesh_history == [(0, 4), (6, 3), (9, 4)]
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_lm_train_step_on_card_matches_cpu(card):
    """A reduced f32 state's 3 train steps on the card and on the CPU: loss
    and grad_norm within rtol 1e-4 (summation order through two Adam
    updates); no kernel of #1–#6 launches on the training path."""
    from repro_torch import interop
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.optim import AdamW, cosine_schedule

    cfg = reduced(treg.get_arch("qwen2-1.5b"), dtype="float32")
    before = {**tk.LAUNCHES, **trk.LAUNCHES, **tfk.LAUNCHES}
    series = {}
    tree = None
    for where in ("cpu", card):
        m = Model(cfg, device=where)
        opt = AdamW(cosine_schedule(3e-3, 1, 3))
        if tree is None:
            st = m.init_train_state(torch.Generator().manual_seed(0), opt)
            tree = interop.train_state_tree(st)
        else:
            st = interop.train_state_from(tree, m)
        step, _ = m.make_train_step(opt)
        out = []
        for i in range(3):
            b = {k: torch.from_numpy(v).to(where)
                 for k, v in synth_batch(DataConfig(vocab_size=cfg.vocab_size), i, 4, 64).items()}
            st, met = step(st, b)
            out.append((float(met["loss"]), float(met["grad_norm"])))
        series[str(where)] = out
    np.testing.assert_allclose(series[str(card)], series["cpu"], rtol=1e-4)
    assert {**tk.LAUNCHES, **trk.LAUNCHES, **tfk.LAUNCHES} == before


@pytest.mark.cuda
def test_lm_train_on_card_fires_at_the_replayed_step(card):
    from repro_torch.launch.train import train

    out = train("qwen2-1.5b", steps=120, batch=4, seq=64, target_loss=3.8,
                monitor_mode="pfait", staleness=3, margin=1.0, log_every=1000, device=card)
    losses, fire = out["losses"], None
    for k in range(len(losses)):
        if k >= 3 and losses[k - 3] < 3.8:
            fire = k
            break
    assert out["stop_step"] is not None and out["stop_step"] == fire


def _event_problem(family, device, **kw):
    from repro_torch.solvers.convdiff import ConvDiffProblem
    from repro_torch.solvers.mlfixed import MLFixedPointProblem
    from repro_torch.solvers.pagerank import PageRankProblem

    if family == "convdiff":
        return ConvDiffProblem(n=24, p=8, rho=0.9, seed=1, device=device, **kw)
    if family == "pagerank":
        return PageRankProblem(n=256, p=4, seed=1, device=device, **kw)
    return MLFixedPointProblem(n=16, p=4, m_rows=64, seed=1, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("family,kw", [("convdiff", dict(sweep="hybrid", ord=INF)),
                                       ("convdiff", dict(sweep="jacobi", ord=2.0)),
                                       ("convdiff", dict(sweep="hybrid", ord=1.0)),
                                       ("pagerank", dict(ord=1.0)), ("pagerank", dict(ord=INF)),
                                       ("mlfixed", dict(ord=2.0)),
                                       ("mlfixed", dict(task="logistic", ord=1.0))])
def test_event_methods_on_card_match_cpu(card, family, kw):
    """The problems' event methods launch their kernels on the card (#2 or
    #1 for convdiff, #5 for PageRank and the ML problem) and give the plain
    path's blocks within 1e-12 and contributions within the f32 bars
    (1e-6 l∞, 1e-5 l2 / l1); a stale face is kept on both."""
    cpu, gpu = _event_problem(family, "cpu", **kw), _event_problem(family, card, **kw)
    rng = np.random.default_rng(3)
    xs = []
    for i in range(cpu.p):
        x0 = cpu.init_local(i)
        noise = torch.as_tensor(rng.standard_normal((2, *x0.shape)))
        xs.append(x0 * (1 + noise[0]) + noise[1])
    rtol = 1e-6 if np.isinf(kw["ord"]) else 1e-5
    before = {**tk.LAUNCHES, **trk.LAUNCHES}
    for i in range(cpu.p):
        for drop in ((), cpu.neighbors(i)[:1]):
            dc = {k: cpu.interface(k, xs[k], i) for k in cpu.neighbors(i) if k not in drop}
            dg = {k: gpu.interface(k, xs[k].to(card), i) for k in gpu.neighbors(i)
                  if k not in drop}
            xc, xg = xs[i], xs[i].to(card)
            (nc, rc), (ng, rg) = cpu.update_with_residual(i, xc, dc), \
                gpu.update_with_residual(i, xg, dg)
            assert ng.device.type == "cuda"
            np.testing.assert_allclose(ng.cpu().numpy(), nc.numpy(), rtol=0,
                                       atol=1e-12 * float(nc.abs().max()))
            assert rg == pytest.approx(rc, rel=rtol)
            assert gpu.local_residual(i, xg, dg) == pytest.approx(
                cpu.local_residual(i, xc, dc), rel=rtol)
            np.testing.assert_allclose(gpu.update(i, xg, dg).cpu().numpy(),
                                       cpu.update(i, xc, dc).numpy(), rtol=0,
                                       atol=1e-12 * float(nc.abs().max()))
    assert gpu.exact_residual([x.to(card) for x in xs]) == pytest.approx(
        cpu.exact_residual(xs), rel=rtol)
    after = {**tk.LAUNCHES, **trk.LAUNCHES}
    want = {"convdiff": "fused_rbgs_sweep_residual" if kw.get("sweep") == "hybrid"
            else "fused_sweep_residual"}.get(family, "diff_norm_partials")
    assert after[want] > before[want]


@pytest.mark.cuda
@pytest.mark.parametrize("family,proto", [("convdiff", "pfait"), ("convdiff", "nfais2"),
                                          ("convdiff", "exact_snapshot"),
                                          ("pagerank", "nfais5"), ("mlfixed", "rdub")])
def test_event_engine_on_card_matches_cpu(card, family, proto):
    """An engine run with the blocks on the card is the CPU's run: equal
    events, counters and times; #2 launches once a hybrid sweep."""
    import dataclasses

    from repro_torch.core.async_engine import AsyncEngine, stable_platform
    from repro_torch.core.protocols import PROTOCOLS
    from repro_torch.core.reliability import TraceRecorder

    eps = {"convdiff": 1e-6, "pagerank": 1e-9, "mlfixed": 1e-6}[family]
    runs = {}
    for where in ("cpu", card):
        prob = _event_problem(family, where)
        cfg = dataclasses.replace(stable_platform(), seed=0, max_iters=2000,
                                  fifo=proto == "exact_snapshot")
        rec = TraceRecorder(residual_stride=25)
        before = dict(tk.LAUNCHES)
        eng = AsyncEngine(prob, cfg, PROTOCOLS[proto](eps, ord=prob.ord), recorder=rec)
        res = eng.run()
        runs[str(where)] = (res, rec, [x.cpu().numpy() for x in eng.x],
                            tk.LAUNCHES["fused_rbgs_sweep_residual"]
                            - before["fused_rbgs_sweep_residual"])
    (a, ra, xa, _), (b, rb, xb, hyb) = runs["cpu"], runs[str(card)]
    assert rb.sweep_events() == ra.sweep_events()
    assert [e for e in rb.events if e[0] != "detect"] == [e for e in ra.events if e[0] != "detect"]
    for f in ("terminated", "detect_time", "wtime", "k_max", "k_min", "msg_counts",
              "msg_bytes", "reductions"):
        assert getattr(b, f) == getattr(a, f), f
    for u, v in zip(xb, xa):
        np.testing.assert_allclose(u, v, rtol=0, atol=1e-12 * float(np.abs(v).max()))
    if family == "convdiff":
        assert hyb == len(rb.sweep_events())


def _tp_card_rank(rank, k, store):
    """A rank of a tp-k gloo world on the card: reduced f32 qwen2's prefill
    logits and the launches of #6 (rank-local counts)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", store=store, rank=rank, world_size=k)
    mesh = make_host_mesh(model_axis=k)
    m = Model(reduced(treg.get_arch("qwen2-1.5b"), dtype="float32"), mesh=mesh)
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 32)), device="cuda")
    before = tfk.LAUNCHES["flash_attention_flat"]
    logits, _ = m.make_prefill()(params, toks)
    return logits.cpu().numpy(), tfk.LAUNCHES["flash_attention_flat"] - before, mesh.staged_bytes


@pytest.mark.cuda
def test_tp_prefill_world_on_card_matches_one_device(card, tmp_path):
    """Tensor parallelism over a gloo world of 2 ranks sharing the card (the
    model's collectives staged through host memory): the gathered prefill
    logits of a reduced f32 qwen2 equal the one-device prefill of the same
    draw within 1e-5 of the largest (f32 sums over the ranks in another
    order), and each rank launches #6 once a layer on its own heads."""
    from repro_torch.launch.mesh import spawn_world

    ranks = spawn_world(_tp_card_rank, 2, str(tmp_path), timeout=300)
    cfg = reduced(treg.get_arch("qwen2-1.5b"), dtype="float32")
    m = Model(cfg, device=card)
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 32)), device=card)
    want = m.make_prefill()(params, toks)[0].cpu().numpy()
    for logits, flash, staged in ranks:
        assert logits.shape == want.shape
        assert float(np.abs(logits - want).max()) <= 1e-5 * float(np.abs(want).max())
        assert flash == cfg.num_layers and staged > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode,reduction", [("pfait", "nonblocking"), ("sync", "blocking"),
                                            ("nfais2", "nonblocking")])
def test_span_counters_on_card_match_sync_debug_mode_and_kernel_work(card, mode, reduction):
    """A stacked solve on the card under a recorder (``core/spans.py``): its
    ``host_syncs`` equal the synchronising calls torch's sync debug mode
    sees in the same solve, its ``ghost_bytes`` are 0 (the Jacobi sweeps
    and residual passes read their face planes where they lie), and the
    kernels' reported bytes are #3's ``work_halo`` and #5's ``work`` at each
    launch; the result is bitwise the solve with tracing off."""
    import warnings

    from repro_torch.core import spans
    from repro_torch.kernels import _build

    n, p, inner = 16, 4, 3
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), 0.9)
    mon = detection.for_mode(mode, eps_tilde=1e-6, margin=10.0, ord=2.0,
                             staleness=0 if reduction == "blocking" else 2)
    cfg = tsr.ShardRuntimeConfig(monitor=mon, reduction=reduction, inner_sweeps=inner,
                                 max_outer=500, trace_len=500)
    b = torch.as_tensor(make_rhs(n, seed=0), device=card)
    x0 = torch.zeros_like(b)
    run = tsr.make_convdiff_runtime(cfg, p, st, n, device=card)
    off = run(x0, b)
    sink = [0.0, 0.0]
    _build.WORK_SINKS.append(sink)
    tk.reset_launches()
    torch.cuda.synchronize()
    # set before the record: torch's one-time notice that the mode is a
    # prototype names "synchronizing operations" without being one
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with spans.recording() as rec:
                on = run(x0, b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        _build.WORK_SINKS.remove(sink)
    k, v = on.outer_iters, on.verifications
    assert on.converged and k == off.outer_iters and torch.equal(on.x, off.x)
    syncs = sum("synchronizing" in str(w.message) for w in caught)
    assert rec.counts["host_syncs"] == syncs == (2 if mode == "nfais2" else 1) * k + 2
    bx, exact = n // p, reduction == "blocking"
    # no sweep, residual pass or NFAIS2 verification assembles a block
    assert rec.counts["ghost_bytes"] == 0
    assert tk.LAUNCHES["fused_sweep_residual"] == 0
    assert tk.LAUNCHES["fused_sweep_residual_halo"] == p * (k * (inner + exact) + v)
    sweep, residual = (tk.work_halo((bx, n, n), 8, op)[1] for op in ("sweep", "residual"))
    tail = residual if exact else trk.work(bx * n * n, 8)[1]
    assert sink[1] == p * (k * (inner * sweep + tail) + v * residual)
