#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases, each of which must pass or the script exits non-zero:

1. build the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel) and print the build time;
2. hold every kernel against its plain PyTorch version on the card, at the
   main path's shapes and a ragged block, over every variant and, for the
   stencil and diff-norm kernels, every partial mode (l∞ max|r|, l2 Σr²,
   l1 Σ|r|), with the tolerance stated beside each check (bf16 attention
   element by element as well, under the bar its tensor-core arithmetic
   allows); the stencil kernels' outputs and partials must be bitwise equal
   across two calls and carry a NaN (#5 too, in l1, at the PageRank path's
   vectors), and a face slab swept by the halo
   kernel must be bitwise the block's face; count the tensor-core
   instructions in the flash library's SASS;
3. time each kernel, its plain version, the nearest single PyTorch call and
   the least time the card could take (CUDA events over 20 CUDA-graph replays,
   so host launch overhead is left out; the eager per-call time is kept
   beside it), and the two shard-block sweeps also over six shards' worth
   of rotating inputs, more than the 50 MB L2, as the runtime finds them,
   and #5 at the PageRank shard block (4096 f64, l1, one partial);
4. ``solve_single`` at n = 185, f64 (the paper's larger grid), for the four
   detection modes with the hybrid sweep, Jacobi, and the unfused baseline,
   in l∞, and PFAIT with the hybrid sweep in l1: each run must converge
   with the exact residual of its result, in its norm, under ε̃;
5. the stacked 1-D shard runtime at n = 150, f64, p = 6: blocking must
   follow the synchronous reference trajectory, and non-blocking
   (heterogeneous Jacobi shards, in l∞ and in l1, and hybrid) and
   recursive doubling (p = 2) must detect with no false detection; each
   blocking run's detection must be consistent with its exact trace;
6. the mesh shard runtime at n = 150, f64, on the paper's (3, 2) process
   grid and a (2, 2, 2) mesh: blocking must follow the synchronous
   reference trajectory (in l∞ and in l1), comm overlap must be bitwise
   equal to no overlap under heterogeneous knobs, and non-blocking hybrid,
   recursive doubling and NFAIS2 must detect with no false detection;
7. serve qwen2-1.5b at full width (bf16, seed-initialised weights): batch 4,
   2048-token prompts, 64 new tokens through ``launch.serve.serve``; every
   layer's prefill attention must launch the flash kernel, every logit must
   be finite; then, at the same width, the prefill's logits with the kernel
   must match the same model's prefill with the plain attention, and a
   prefill over S − 1 tokens plus one decode step must match the prefill
   over S tokens, in f32 and in bf16 (where the bar is read against two
   plain evaluations and a faulty one in the same run);
8. PageRank at n = 16384 (a 2 GiB f64 operator placed on the card once),
   p = 4 row blocks, ε̃ = 1e-9 in l1, through ``runtime.api.run_shard``:
   blocking, non-blocking PFAIT with heterogeneous knobs, recursive doubling
   and NFAIS2 must converge with the exact residual (f64 on the card, and
   the host's ``PageRankProblem.exact_residual``) under ε̃, blocking must
   follow the synchronous reference trajectory and its detection must be
   consistent with that exact trace (``core.termination``); the 1-D p = 6
   hetero Jacobi case of phase 5, run again through ``run_shard`` with a
   recorded trace, must be bitwise phase 5's run; every recorded trace
   must validate;
9. one shard per process over ``torch.distributed``, in spawned local
   worlds on the one card: a gloo world of 6 ranks sharing ``cuda:0``
   (phase 5's 1-D p = 6 runs but the p = 2 one, phase 6's (3, 2) blocking,
   hetero, hetero overlap and NFAIS2 runs, a (3, 2) hetero hybrid run and
   ``make_sharded_solver`` on a (3, 2) group at n = 150), a gloo world of 4
   (phase 8's four PageRank runs, each rank holding only its row block of
   P, and 1-D rdoubling at p = 4, n = 152) and an NCCL world of 1 (the 1-D
   p = 1 runtime, and ``make_sharded_solver`` on (1, 1) at n = 185 as phase
   4's PFAIT hybrid run): every run must equal its stacked twin (same
   iterations, detection and verifications, x bitwise, the trace bitwise
   at l∞ and within p·2^-24 relative at l1), every rank must report the
   same outcome, and #1-#5 must launch inside the worlds (the ranks' own
   counters; a world that reports none fails the phase); ms per step and
   the host-staged bytes per step are printed beside the stacked twin's;
10. require that every (stencil kernel, block shape) pair the main paths
   launched, in this process and inside the worlds, was held against its
   plain version in phase 2; rank the stencil kernels by launches x (device
   ms - bound ms) over those pairs, each timed at its shape; print one JSON
   line of per-kernel numbers, the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.

Phases 4 to 9 are the main paths.  The kernels' launch counters are
set to 0 just before each of them and read just after; every kernel of a
path must show launches there (phase 9's in the counters its ranks report).  Needs CUDA: without a card, or without the
repository's ``src/`` beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
import statistics
from typing import NamedTuple
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
EPS_TILDE = 1e-6
INF = float("inf")
SOLVER_N = 185                        # the paper's larger grid (EXPERIMENTS.md)
SHARD_N = 150                         # the paper's smaller grid
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_F64_FLOPS = 34e12               # H100 SXM data sheet, f64 outside the tensor cores
PEAK_BF16_FLOPS = 989e12             # H100 SXM data sheet, dense bf16 on the tensor cores
# the serving path: qwen2-1.5b at full width (28 layers, 12 q / 2 kv heads of
# 128), batch 4, 2048-token prompts, 64 new tokens
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "qwen2-1.5b", 4, 2048, 64
# flash attention cases (BH, BN, S, H, causal, window, dtype): the serving
# path's prefill shape (B·N·P = 4·2·6 rows, B·N = 8 kv rows), a ragged S, a
# window, the non-causal case and H = 64, in bf16 and f32
FLASH_CASES = [(48, 8, 2048, 128, True, 0, "bf16"), (48, 8, 2048, 128, True, 0, "f32"),
               (48, 8, 1000, 128, True, 0, "bf16"), (48, 8, 1000, 128, True, 0, "f32"),
               (48, 8, 2048, 128, True, 256, "bf16"), (48, 8, 1000, 128, False, 0, "bf16"),
               (48, 8, 1000, 128, False, 0, "f32"), (48, 8, 2048, 64, True, 0, "bf16"),
               (48, 8, 1000, 64, True, 256, "f32")]

# the PageRank path: n = 16384 nodes (a 2 GiB f64 operator), p = 4 row
# blocks of 4096, ε̃ = 1e-9 in l1, and the heterogeneous knobs of run (b)
PAGERANK_N, PAGERANK_P, PAGERANK_EPS = 16384, 4, 1e-9
PAGERANK_KNOBS = dict(inner_sweeps=(1, 2, 1, 3), halo_delay=(0, 1, 0, 2),
                      contrib_lag=(0, 1, 0, 1))
# #5's 1-D shapes on that path: a shard's block (one partial, split over a
# cluster), a ragged block and the whole state
PAGERANK_VECTORS = (4096, 4095, 16384)
# f64 unit roundoff: two f64 evaluations of Σ|d·P x + v − x| in different
# summation orders may part by a few units of it times Σ(d·P|x| + v + |x|)
F64_UNIT = 2.0 ** -53

# shapes the main path gives the kernels: the 185³ single-device grid, the
# 25×150×150 block of one of 6 shards, the 75×150×150 block of one of 2 and
# the whole 150³ grid of one at n = 150, the 38×152×152 block of one of 4 at
# n = 152, make_sharded_solver's 50×75×150 block of the (3, 2) mesh, and a
# ragged block.  main() fails if a main path launches #1-#4 at a block
# shape not listed here (or in HALO_SHAPES for #3/#4)
SHAPES = {"main": (185, 185, 185), "shard": (25, 150, 150), "p2": (75, 150, 150),
          "p1": (150, 150, 150), "p4": (38, 152, 152), "mesh32": (50, 75, 150),
          "ragged": (13, 37, 19)}
# and the halo kernels': the blocks of the (3, 2) and (2, 2, 2) meshes at
# n = 150, the 1-D shard block, the 185³ grid, the ragged block and the
# (3, 2) mesh's two overlap face slabs.  The halo Jacobi sweep splits a
# tile over a cluster at the mesh blocks, the shard block and the x slab,
# and keeps one CTA per tile at 185³, the ragged block and the y slab
HALO_SHAPES = {"mesh32": (50, 75, 150), "mesh222": (75, 75, 75), "shard": (25, 150, 150),
               "main": (185, 185, 185), "ragged": (13, 37, 19), "slab": (1, 75, 150),
               "slab_y": (50, 1, 150)}
# stated tolerances, relative to the largest magnitude of the plain result:
# f64 blocks differ by FMA contraction only; f32 sums differ by summation
# order (at most ~150 sequential adds per thread, then a tree)
TOL = {("block", "f64"): 1e-12, ("block", "f32"): 1e-5, ("block", "bf16"): 1e-5,
       ("max", "f64"): 1e-6, ("max", "f32"): 1e-5, ("max", "bf16"): 1e-6,
       ("sum", "f64"): 2e-5, ("sum", "f32"): 2e-5, ("sum", "bf16"): 2e-5,
       # attention outputs, as tests/test_kernels.py:83: f32 summation order,
       # one bf16 rounding of the output
       ("attn", "f32"): 2e-5, ("attn", "bf16"): 3e-2}
# bf16 attention outputs are also held element by element, under
# ``flash_attention.ref.bf16_output_bar``: the kernel rounds each softmax
# weight p to bf16 (unit roundoff 2^-8) for its P·V product, with l summed
# from the f32 p, which moves its f32 output by at most 2^-8·Σp|v|/l, the
# plain version applied to |v|; then both sides round once to bf16, one
# step, below 2^-7·|want|, with 2^-7·rms(want) for f32 summation order near
# zero.  So |Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|), the last
# term in f64 from the same inputs.
# a bf16 evaluation of the serving model against another: the largest
# share of the JAX bar (tests/test_models.py:88-91) that the flash kernel
# vs the plain attention, and prefill(S − 1) + decode vs prefill(S), may
# reach.  It lies between the drift of two plain evaluations (block_kv 512
# and 256 against 1024: 1.195 and 1.113 on the H100) and a plain
# evaluation that drops kv tile 0 for the last 64 rows (16.44); both are
# read again in every run, and the run fails if the bar leaves that gap
BF16_MODEL_BAR = 3.0


class SmokeFailure(RuntimeError):
    pass


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def _time_ms(fn, calls: int = 10, reps: int = 20):
    """``(device_ms, call_ms)`` per call of ``fn``, or of a list of calls
    taken in turn (rotating inputs: each call finds its inputs as the
    others left the L2).

    ``device_ms`` is the device's time alone: ``calls`` calls are captured
    in a CUDA graph, and the median of ``reps`` timed replays (CUDA events)
    is divided by ``calls``.  ``call_ms`` is the time per call when the host
    issues them back to back, launch overhead included — what a Python
    loop pays."""
    import torch

    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
    for _ in range(3):
        for f in fns:
            f()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for c in range(calls):
        fns[c % len(fns)]()
    ev[1].record()
    torch.cuda.synchronize()
    call_ms = ev[0].elapsed_time(ev[1]) / calls
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in range(calls):
            fns[c % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    device_ms = statistics.median(s.elapsed_time(e) for s, e in evs) / calls
    del graph
    torch.cuda.empty_cache()
    return device_ms, call_ms


class Checker:
    """Holds each kernel against its plain version, raising on the first
    output beyond its tolerance; keeps the largest absolute error per
    (kernel, output) and the largest relative one per kernel."""

    def __init__(self):
        self.abs_err = {}
        self.rel_err = {}
        self.of_tol = {}   # largest error as a share of its tolerance
        self.of_bar = {}   # bf16 attention: worst element's share of its own bar

    def __call__(self, kernel: str, what: str, kind: str, dt: str, got, want, bar=None):
        g, w = got.double(), want.double()
        _require(bool(g.isfinite().all()), f"{kernel} {what}: non-finite output")
        err = float((g - w).abs().max())
        scale = max(float(w.abs().max()), 1e-30)
        tol = TOL[(kind, dt)]
        out = "partials" if kind in ("max", "sum") else "block"
        self.abs_err[kernel, out] = max(self.abs_err.get((kernel, out), 0.0), err)
        self.rel_err[kernel] = max(self.rel_err.get(kernel, 0.0), err / scale)
        self.of_tol[kernel] = max(self.of_tol.get(kernel, 0.0), err / (tol * scale))
        _require(err <= tol * scale,
                 f"{kernel} {what}: max|Δ| {err:.3e} > {tol:g} × {scale:.3e}")
        if bar is not None:
            share = _bar_share(g, w, bar)
            self.of_bar[kernel] = max(self.of_bar.get(kernel, 0.0), share)
            _require(share <= 1.0, f"{kernel} {what}: worst element at {share:.3f} of "
                     f"|Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|)")


def _bar_share(got, want, bar) -> float:
    """The worst element's share of an element-wise bar on |got − want|."""
    return float(((got.double() - want.double()).abs() / bar).max())


# the partial modes: max|r| (l∞), Σr² (l2), Σ|r| (l1), and the reduction
# each is held as
ORDS = {INF: "max", 2.0: "sum", 1.0: "sum"}


def _ord_tag(ord_) -> str:
    return {INF: "linf", 2.0: "l2", 1.0: "l1"}[ord_]


def check_kernels(st, dev, check: Checker) -> None:
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ref as jref
    from repro_torch.kernels.residual_norm import ref as rref
    from repro_torch.kernels.residual_norm import residual_norm as rk

    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape, dtype):
        return torch.rand(shape, generator=gen, device=dev, dtype=dtype) * 2 - 1

    def same_twice(kernel, tag, call):
        """The kernel's output and partials bitwise equal across two calls."""
        got = call()
        again = call()
        _require(all(torch.equal(u, v) for u, v in zip(got, again)),
                 f"{kernel} {tag}: two calls on the same inputs differ")
        return got

    dtypes = {"f64": torch.float64, "f32": torch.float32}
    n_cases = 0
    for sname, (bx, by, bz) in SHAPES.items():
        a, c = rand((bx, by, bz), torch.float64), rand((bx, by, bz), torch.float64)
        for ord_ in ORDS:
            same_twice("diff_norm_partials", sname,
                       lambda: (rk.diff_norm_partials(a, c, ord=ord_),))
        for dt, dtype in dtypes.items():
            g = rand((bx + 2, by + 2, bz + 2), dtype)
            g2 = rand((bx + 4, by + 4, bz + 2), dtype)
            b = rand((bx, by, bz), dtype)
            for ord_, red in ORDS.items():
                for op in ("sweep", "residual"):
                    tag = f"{sname} {dt} op={op} {_ord_tag(ord_)}"
                    got = same_twice("fused_sweep_residual", tag, lambda: jk.fused_sweep_residual(
                        g, b, st.coefs, op=op, ord=ord_))
                    want = jref.fused_sweep_residual_ref(g, b, st.coefs, op=op, ord=ord_)
                    check("fused_sweep_residual", tag + " block", "block", dt, got[0], want[0])
                    check("fused_sweep_residual", tag + " partials", red, dt, got[1], want[1])
                    n_cases += 1
                for ox, oy in ((0, 0), (3, 5), (0, 1)):
                    tag = f"{sname} {dt} phase=({ox},{oy}) {_ord_tag(ord_)}"
                    got = same_twice("fused_rbgs_sweep_residual", tag,
                                     lambda: jk.fused_rbgs_sweep_residual(g2, b, st.coefs,
                                                                          ox + oy, ord=ord_))
                    want = jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, ox + oy,
                                                              ord=ord_)
                    check("fused_rbgs_sweep_residual", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_rbgs_sweep_residual", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
        for dt, dtype in (*dtypes.items(), ("bf16", torch.bfloat16)):
            a, c = rand((bx, by, bz), dtype), rand((bx, by, bz), dtype)
            for ord_, red in ORDS.items():
                check("diff_norm_partials", f"{sname} {dt} {_ord_tag(ord_)}", red, dt,
                      rk.diff_norm_partials(a, c, ord=ord_),
                      rref.diff_norm_partials_ref(a, c, ord=ord_))
                n_cases += 1
    for sname, (bx, by, bz) in HALO_SHAPES.items():
        for dt, dtype in dtypes.items():
            x, b = rand((bx, by, bz), dtype), rand((bx, by, bz), dtype)
            h = [rand(s, dtype) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz),
                                           (bx, by), (bx, by))]
            for ord_, red in ORDS.items():
                for op in ("sweep", "residual"):
                    tag = f"{sname} {dt} op={op} {_ord_tag(ord_)}"
                    got = same_twice("fused_sweep_residual_halo", tag,
                                     lambda: jk.fused_sweep_residual_halo(
                                         x, h, b, st.coefs, op=op, ord=ord_))
                    want = jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs, op=op,
                                                              ord=ord_)
                    check("fused_sweep_residual_halo", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_sweep_residual_halo", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
                for oxyz in (0, 1, 5):
                    tag = f"{sname} {dt} oxyz={oxyz} {_ord_tag(ord_)}"
                    got = same_twice("fused_rbgs_sweep_residual_halo", tag,
                                     lambda: jk.fused_rbgs_sweep_residual_halo(
                                         x, h, b, st.coefs, oxyz, ord=ord_))
                    want = jref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, oxyz,
                                                                   ord=ord_)
                    check("fused_rbgs_sweep_residual_halo", tag + " block", "block", dt,
                          got[0], want[0])
                    check("fused_rbgs_sweep_residual_halo", tag + " partials", red, dt,
                          got[1], want[1])
                    n_cases += 1
            del x, b, h
    check_nan_and_slabs(st, dev, rand)
    # f64 update differences near 1e-13 must survive the cast to f32
    a = 1.0 + rand(SHAPES["shard"], torch.float64)
    c = a + 1e-13 * rand(SHAPES["shard"], torch.float64)
    for ord_, red in ORDS.items():
        got = rk.diff_norm_partials(a, c, ord=ord_)
        _require(bool((got > 0).all()), "diff_norm_partials: tiny f64 differences lost")
        check("diff_norm_partials", f"tiny-f64 {_ord_tag(ord_)}", red, "f64", got,
              rref.diff_norm_partials_ref(a, c, ord=ord_))
        n_cases += 1
    # the PageRank path's vectors: state-sized differences of ≈ 1e-13
    for n in PAGERANK_VECTORS:
        for dt, dtype in (*dtypes.items(), ("bf16", torch.bfloat16)):
            a = (rand((n,), torch.float64) / n).to(dtype)
            c = a + (rand((n,), torch.float64) * 1e-13 if dt == "f64" else rand((n,), dtype))
            for ord_, red in ORDS.items():
                tag = f"{n} {dt} {_ord_tag(ord_)}"
                got = same_twice("diff_norm_partials", tag,
                                 lambda: (rk.diff_norm_partials(a, c, ord=ord_),))[0]
                check("diff_norm_partials", tag, red, dt, got,
                      rref.diff_norm_partials_ref(a, c, ord=ord_))
                n_cases += 1
        a = rand((n,), torch.float64)
        c = a.clone()
        c[n // 3] = float("nan")
        _require(bool(rk.diff_norm_partials(a, c, ord=1.0).isnan().all()),
                 f"diff_norm_partials {n} f64: a NaN does not reach the l1 partial")
    torch.cuda.synchronize()
    print(f"kernels vs plain: {n_cases} cases within tolerance, each in the three partial "
          f"modes (l∞ max|r|, l2 Σr², l1 Σ|r|); every stencil kernel's output and partials "
          f"and diff_norm_partials' partials bitwise equal across two calls at every shape, "
          f"variant, phase and mode; a NaN in the block reaches the l∞ partial of #1-#4 at "
          f"{', '.join(NAN_SHAPES)} and #5's l1 partial at the PageRank vectors "
          f"{', '.join(map(str, PAGERANK_VECTORS))}; the halo sweep's six face slabs bitwise the block's "
          f"faces at {'x'.join(map(str, HALO_SHAPES['mesh32']))}")
    for k, v in check.rel_err.items():
        print(f"  {k}: max relative error {v:.2e}; worst case at {check.of_tol[k]:.3f} "
              f"of its tolerance (tolerances: blocks f64 1e-12, f32 1e-5; max "
              f"partials 1e-6/1e-5; sum partials 2e-5); max abs error of the block "
              f"{check.abs_err.get((k, 'block'), 0.0):.3e}")


NAN_SHAPES = ("main", "shard", "ragged", "mesh222")


def check_nan_and_slabs(st, dev, rand) -> None:
    """A NaN in the block reaches the l∞ partials of the tiles whose input
    residual it touches, as in the plain version, in #1-#4 (split and
    unsplit grids); a thickness-1 face slab swept by #3 is bitwise that
    face of the block's sweep at the (3, 2) mesh block, where the grid
    splits (the comm overlap's premise)."""
    import torch

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ref as jref

    f64 = torch.float64

    def nan_reaches(kernel, got, want, name):
        got, want = got[1].isnan(), want[1].isnan()
        _require(bool(want.any()) and torch.equal(got, want),
                 f"{kernel} {name}: a NaN does not reach the partials as in the plain version")

    for name in NAN_SHAPES:
        bx, by, bz = shape = {**SHAPES, **HALO_SHAPES}[name]
        i, j, z = bx // 2, by // 2, bz // 2
        b = rand(shape, f64)
        g, g2 = rand((bx + 2, by + 2, bz + 2), f64), rand((bx + 4, by + 4, bz + 2), f64)
        g[i + 1, j + 1, z + 1] = float("nan")
        g2[i + 2, j + 2, z + 1] = float("nan")
        nan_reaches("fused_sweep_residual", jk.fused_sweep_residual(g, b, st.coefs),
                    jref.fused_sweep_residual_ref(g, b, st.coefs), name)
        nan_reaches("fused_rbgs_sweep_residual", jk.fused_rbgs_sweep_residual(g2, b, st.coefs, 0),
                    jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, 0), name)
        x = rand(shape, f64)
        h = [rand(s, f64) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by))]
        x[i, j, z] = float("nan")
        nan_reaches("fused_sweep_residual_halo", jk.fused_sweep_residual_halo(x, h, b, st.coefs),
                    jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs), name)
        nan_reaches("fused_rbgs_sweep_residual_halo",
                    jk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, 1),
                    jref.fused_rbgs_sweep_residual_halo_ref(x, h, b, st.coefs, 1), name)
        del g, g2, x, h, b
    shape = HALO_SHAPES["mesh32"]
    x, b = rand(shape, f64), rand(shape, f64)
    h = [rand(s, f64) for s in ((shape[1], shape[2]),) * 2 + ((shape[0], shape[2]),) * 2
         + ((shape[0], shape[1]),) * 2]
    full, _ = jk.fused_sweep_residual_halo(x, h, b, st.coefs)
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
            slab, _ = jk.fused_sweep_residual_halo(
                x.narrow(d, idx, 1).contiguous(), sg, b.narrow(d, idx, 1).contiguous(),
                st.coefs)
            _require(torch.equal(slab, full.narrow(d, idx, 1)),
                     f"halo sweep: face slab (axis {d}, index {idx}) is not bitwise the "
                     f"block's face")


def check_flash(dev, check: Checker) -> None:
    """#6 against its plain version (``flash_attention_ref``) on the card."""
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import bf16_output_bar, flash_attention_ref

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for case in FLASH_CASES:
        BH, BN, S, H, causal, window, dt = case
        q, k, v = (torch.randn((n, S, H), generator=gen, device=dev).to(dtypes[dt])
                   for n in (BH, BN, BN))
        tag = f"{BH}x{S}x{H} kv {BN} {dt} causal={causal} window={window}"
        want = flash_attention_ref(q, k, v, causal=causal, window=window)
        bar = (bf16_output_bar(want, q, k, v, causal=causal, window=window)
               if dt == "bf16" else None)
        check("flash_attention_flat", tag, "attn", dt,
              fk.flash_attention_flat(q, k, v, causal=causal, window=window), want, bar)
        if case == FLASH_CASES[0]:
            # the bars' power: the plain version with kv tile 0 dropped for
            # the last row (and part of it for the 63 rows before)
            bad = flash_attention_ref(q, k, v, causal=causal, window=S - 64).double()
            w = want.double()
            faulty = (_bar_share(bad, w, bar),
                      float((bad - w).abs().max()) / (TOL["attn", dt] * float(w.abs().max())))
        del q, k, v, want, bar
    torch.cuda.synchronize()
    k = "flash_attention_flat"
    print(f"flash attention vs plain: {len(FLASH_CASES)} cases within tolerance (f32 2e-5, "
          f"bf16 3e-2 of the largest magnitude); max relative error {check.rel_err[k]:.2e}, "
          f"worst case at {check.of_tol[k]:.3f} of its tolerance; max abs error "
          f"{check.abs_err[k, 'block']:.3e}; bf16 cases element by element: worst element at "
          f"{check.of_bar[k]:.3f} of |Δ| ≤ 2^-7·(|want| + rms(want)) + 2^-8·ref(q, k, |v|)")
    print(f"a plain output with one kv tile dropped for the last rows, at the path's shape: "
          f"{faulty[0]:.3f} of the element-wise bar, {faulty[1]:.3f} of the 3e-2 bar")
    _require(faulty[0] > 1.0, "the element-wise bf16 bar does not catch a dropped kv tile")


def tensor_core_sass():
    """Counts of ``HGMMA`` (wgmma) and ``HMMA`` (mma.sync) instructions in
    the built flash library's SASS, from ``cuobjdump -sass``; None where the
    toolkit has no ``cuobjdump``."""
    import shutil

    from repro_torch.kernels import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    out = subprocess.run([tool, "-sass", str(_build._lib_path("flash_attention"))],
                         capture_output=True, text=True, timeout=300, check=True).stdout
    lines = out.splitlines()
    return {op: sum(op in ln for ln in lines) for op in ("HGMMA", "HMMA")}


def time_flash(dev) -> dict:
    """#6 at the serving path's prefill shape (bf16, causal), beside its
    plain version and ``F.scaled_dot_product_attention`` on the
    ``[B, N·P, S, H]`` layout."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    BH, BN, S, H = FLASH_CASES[0][:4]
    B, NP = SERVE_BATCH, BH // SERVE_BATCH
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((n, S, H), generator=gen, device=dev).to(torch.bfloat16)
               for n in (BH, BN, BN))
    qs, ks, vs = q.view(B, NP, S, H), k.view(B, BN // B, S, H), v.view(B, BN // B, S, H)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())     # q, k, v in, o out
    flops = 4 * H * BH * S * (S + 1) / 2                     # the causal band
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    ms, call_ms = _time_ms(lambda: fk.flash_attention_flat(q, k, v))
    plain_ms, _ = _time_ms(lambda: flash_attention_ref(q, k, v))
    library_ms, _ = _time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True, enable_gqa=True))
    row = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    print(f"time flash_attention_flat at {BH}x{S}x{H} kv {BN} bf16 causal: kernel {ms:.4f} ms "
          f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library (SDPA) "
          f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    del q, k, v
    torch.cuda.empty_cache()
    return row


HALO_KERNELS = ("fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo")


def _stencil_case(k, shape, st, rand):
    """A stencil kernel at a block shape, f64, l∞, on random inputs:
    ``(kernel call, plain call, ghosted block for the library call, bytes,
    flops)``.  Bytes count each input read once and each output written
    once: the block (or the ghosted block) and the rhs in, the new block
    and the partials out, the six face planes for the halo kernels."""
    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.kernels.jacobi3d import ref as jref
    from repro_torch.solvers.fixed_point import ghosted6

    bx, by, bz = shape
    cells = bx * by * bz
    x, b = rand(shape), rand(shape)
    _, _, nx, ny = jref.tile_grid(bx, by, jref.DEFAULT_TILE)
    flops = 18 * cells if k in ("fused_sweep_residual", "fused_sweep_residual_halo") \
        else 25 * cells
    if k in HALO_KERNELS:
        h = [rand(s) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz), (bx, by), (bx, by))]
        nbytes = 8 * (3 * cells + sum(p.numel() for p in h)) + 4 * nx * ny
        if k == "fused_sweep_residual_halo":
            kern = lambda: jk.fused_sweep_residual_halo(x, h, b, st.coefs)  # noqa: E731
            plain = lambda: jref.fused_sweep_residual_halo_ref(x, h, b, st.coefs)  # noqa: E731
        else:
            kern = lambda: jk.fused_rbgs_sweep_residual_halo(x, h, b, st.coefs, 1)  # noqa: E731
            plain = lambda: jref.fused_rbgs_sweep_residual_halo_ref(  # noqa: E731
                x, h, b, st.coefs, 1)
        return kern, plain, ghosted6(x, h), nbytes, flops
    ghosts = (rand((by, bz)), rand((by, bz)), rand((bx, bz)), rand((bx, bz)))
    g = jops.ghost_pad1(x, ghosts)
    if k == "fused_sweep_residual":
        kern = lambda: jk.fused_sweep_residual(g, b, st.coefs)  # noqa: E731
        plain = lambda: jref.fused_sweep_residual_ref(g, b, st.coefs)  # noqa: E731
        nbytes = 8 * (g.numel() + 2 * cells) + 4 * nx * ny
    else:
        g2 = jops.ghost_pad2(x, ghosts)
        kern = lambda: jk.fused_rbgs_sweep_residual(g2, b, st.coefs, 0)  # noqa: E731
        plain = lambda: jref.fused_rbgs_sweep_residual_ref(g2, b, st.coefs, 0)  # noqa: E731
        nbytes = 8 * (g2.numel() + 2 * cells) + 4 * nx * ny
    return kern, plain, g, nbytes, flops


def _bound(nbytes, flops):
    """The least time (ms) the card could take, and which of bytes and
    operations sets it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_F64_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _shape_str(shape) -> str:
    return "x".join(map(str, shape))


def time_kernels(st, dev) -> dict:
    """Per-kernel times (f64, l∞) keyed by (kernel, block shape): the
    stencils at every main-path shape, #5 at its two; and keyed by
    (kernel, shape, "cold") the two shard-block sweeps over six shards'
    worth of rotating inputs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.kernels.residual_norm import ref as rref
    from repro_torch.kernels.residual_norm import residual_norm as rk

    gen = torch.Generator(device=dev).manual_seed(1)
    f64 = torch.float64

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=f64) * 2 - 1

    # the nearest single PyTorch call for the stencils: the off-diagonal
    # apply alone as a 3-D convolution (it computes less than the kernels)
    w = torch.zeros((1, 1, 3, 3, 3), dtype=f64, device=dev)
    w[0, 0, 0, 1, 1], w[0, 0, 2, 1, 1] = st.xm, st.xp
    w[0, 0, 1, 0, 1], w[0, 0, 1, 2, 1] = st.ym, st.yp
    w[0, 0, 1, 1, 0], w[0, 0, 1, 1, 2] = st.zm, st.zp
    out = {}

    def record(k, shape, fns, bound, mode=""):
        kern, plain, lib = fns
        (ms, call_ms), (plain_ms, _), (library_ms, _) = map(_time_ms, (kern, plain, lib))
        print(f"time {k} at {_shape_str(shape)} f64{mode}: kernel {ms:.4f} ms (eager "
              f"call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {bound[0]:.{'4f' if bound[0] >= 1e-4 else '3e'}} ms "
              f"({bound[1]})")
        out[k, shape] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1])

    def stencil(k, shape):
        kern, plain, gin, nbytes, flops = _stencil_case(k, shape, st, rand)
        # the library call: the off-diagonal apply as a convolution of the
        # ghosted block, its assembly left out
        gin = gin[None, None]
        record(k, shape, (kern, plain, lambda: F.conv3d(gin, w)), _bound(nbytes, flops))

    for name in ("main", "mesh32", "mesh222"):
        shape = HALO_SHAPES[name]
        for k in HALO_KERNELS:
            stencil(k, shape)
        # what the halo kernel saves: assembling the ghosted block first
        # (ghost_pad1, the 1-D path's assembly) and sweeping it with #1
        bx, by, bz = shape
        x, b = rand(shape), rand(shape)
        h = [rand(s) for s in ((by, bz), (by, bz), (bx, bz), (bx, bz))]
        pad_ms, pad_call_ms = _time_ms(
            lambda: jk.fused_sweep_residual(jops.ghost_pad1(x, h), b, st.coefs))
        print(f"time ghost_pad1 + fused_sweep_residual at {_shape_str(shape)} f64: "
              f"{pad_ms:.4f} ms (eager call {pad_call_ms:.4f} ms)")
        del x, b, h
    for name in ("slab", "slab_y"):   # the (3, 2) mesh's overlap face slabs
        stencil("fused_sweep_residual_halo", HALO_SHAPES[name])
    for name in ("main", "shard", "p2"):
        for k in ("fused_sweep_residual", "fused_rbgs_sweep_residual"):
            if (k, name) != ("fused_rbgs_sweep_residual", "p2"):   # hybrid runs at p = 6
                stencil(k, SHAPES[name])
    for name in ("main", "shard", "p2"):
        shape = SHAPES[name]
        cells = shape[0] * shape[1] * shape[2]
        x, b = rand(shape), rand(shape)
        record("diff_norm_partials", shape, (
            lambda: rk.diff_norm_partials(x, b), lambda: rref.diff_norm_partials_ref(x, b),
            lambda: torch.dist(x, b, INF)),
            _bound(8 * 2 * cells + 4 * -(-cells // 65536), 3 * cells))
        del x, b
    # the PageRank path's block: one shard's 4096 f64 in l1, one partial
    n = PAGERANK_N // PAGERANK_P
    x, b = rand((n,)), rand((n,))
    record("diff_norm_partials", (n,), (
        lambda: rk.diff_norm_partials(x, b, ord=1.0),
        lambda: rref.diff_norm_partials_ref(x, b, ord=1.0), lambda: torch.dist(x, b, 1)),
        _bound(8 * 2 * n + 4, 3 * n), mode=" l1 (one partial)")
    del x, b
    # the runtime sweeps its six shards in turn, so each finds its block
    # gone from the L2: six shards' worth of inputs (> 50 MB), taken in turn
    for k, shape in (("fused_sweep_residual_halo", HALO_SHAPES["mesh32"]),
                     ("fused_rbgs_sweep_residual", SHAPES["shard"])):
        cases = [_stencil_case(k, shape, st, rand) for _ in range(6)]
        nbytes = cases[0][3]
        ms, call_ms = _time_ms([c[0] for c in cases], calls=12)
        warm = out[k, shape]["ms"]
        print(f"time {k} at {_shape_str(shape)} f64, six shards' inputs in turn "
              f"({6 * nbytes / 1e6:.1f} MB): kernel {ms:.4f} ms (eager call {call_ms:.4f} "
              f"ms); one warm input {warm:.4f} ms")
        out[k, shape, "cold"] = dict(ms=ms, call_ms=call_ms)
        del cases
        torch.cuda.empty_cache()
    return out


def rank_launches(st, dev, shape_launches, times) -> list:
    """The stencil kernels' main-path launches by (kernel, block shape),
    each priced at its shape's device time less its bound, largest first.
    A shape no timing above covered is timed here (device time only).
    Residual-only passes of the Jacobi kernels are priced at the sweep's
    numbers (they write no block, so this over-prices them a little)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(4)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1

    rows = []
    for (k, shape), n in shape_launches.items():
        t = times.get((k, shape))
        if t is None:
            kern, _, _, nbytes, flops = _stencil_case(k, shape, st, rand)
            ms, _ = _time_ms(kern)
            bound_ms, _ = _bound(nbytes, flops)
            t = dict(ms=ms, bound_ms=bound_ms)
        rows.append(dict(kernel=k, shape=_shape_str(shape), launches=n, ms=t["ms"],
                         bound_ms=t["bound_ms"], loss_ms=n * (t["ms"] - t["bound_ms"])))
    rows.sort(key=lambda r: -r["loss_ms"])
    print("rank by launches x (device ms - bound ms) over the main paths (f64 device ms at "
          "each block shape):")
    for r in rows:
        print(f"  {r['kernel']:32s} {r['shape']:>12s}  launches {r['launches']:6d}  device "
              f"{r['ms']:.4f} ms  bound {r['bound_ms']:.4f} ms  loss {r['loss_ms']:.1f} ms")
    return rows


def _counters():
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.jacobi3d import jacobi3d as jk
    from repro_torch.kernels.residual_norm import residual_norm as rk

    return jk, rk, fk


def _launches():
    return {k: v for mod in _counters() for k, v in mod.LAUNCHES.items()}


def _reset_launches():
    for mod in _counters():
        mod.reset_launches()


class Run(NamedTuple):
    """One main-path run: its result, wall time and the kernel launches it
    made, and the norm order it detected in."""

    name: str
    st: object
    b: object
    r: object
    wall: float
    used: dict
    ord: float = INF


def _run(label, fn, st, b, ord=INF) -> Run:
    import torch

    before = _launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    used = {k: v - before[k] for k, v in _launches().items()}
    return Run(label, st, b, r, wall, used, ord)


def eps_tilde(ord, n) -> float:
    """The target ε̃ of a run: 1e-6 in l∞, and in l1 ε̃·n³, the l1 norm of a
    residual of ε̃ in every cell (at n = 185: 6.33; at n = 150: 3.375)."""
    return EPS_TILDE if ord == INF else EPS_TILDE * n ** 3


def solver_cells(st) -> list:
    """Phase 4's runs: ``(label, SolverConfig, ord)``."""
    from repro_torch.core import detection
    from repro_torch.solvers.fixed_point import SolverConfig

    n = SOLVER_N
    runs = [(m, "hybrid", True, INF) for m in ("sync", "pfait", "nfais2", "nfais5")]
    runs += [("pfait", "jacobi", True, INF), ("pfait", "hybrid", False, INF),
             ("pfait", "hybrid", True, 1.0)]
    cells = []
    for mode, sweep, fuse, ord in runs:
        mon = detection.for_mode(mode, eps_tilde=eps_tilde(ord, n), margin=10.0,
                                 staleness=0 if mode == "sync" else 4,
                                 persistence=4, ord=ord)
        cfg = SolverConfig(stencil=st, monitor=mon, inner_sweeps=2, max_outer=50_000,
                           sweep=sweep, use_kernel=True, fuse_residual=fuse)
        label = f"{mode}/{sweep}/{'fused' if fuse else 'unfused'}" + (" l1" if ord == 1 else "")
        cells.append((label, cfg, ord))
    return cells


def _stencil(n):
    from repro_torch.solvers.convdiff import Stencil

    return Stencil.for_contraction(n, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)


def _rhs(n, dev):
    import torch

    from repro_torch.solvers.convdiff import make_rhs

    return torch.as_tensor(make_rhs(n, seed=0), device=dev)


def run_solver(dev) -> list:
    """Phase 4: ``solve_single`` at n = 185, f64, quickstart settings."""
    from repro_torch.solvers.fixed_point import solve_single

    st, b = _stencil(SOLVER_N), _rhs(SOLVER_N, dev)
    return [_run(label, lambda: solve_single(cfg, b, device=dev), st, b, ord)
            for label, cfg, ord in solver_cells(st)]


# the trace length of the 1-D p = 6 hetero Jacobi run, which the PageRank
# path runs again through ``runtime.api.run_shard`` with ``record_trace``
# (whose default length this is)
API_TRACE_LEN = 512
# heterogeneous per-shard knobs of the 6-shard runs, 1-D and mesh
MESH_KNOBS = dict(inner_sweeps=(1, 2, 1, 3, 1, 2), halo_delay=(0, 1, 0, 2, 0, 1),
                  contrib_lag=(0, 1, 0, 1, 0, 0))


def shard_cells() -> list:
    """Phase 5's runs: ``(name, p, ShardRuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import shard_runtime as sr

    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    mon1 = detection.for_mode("pfait", eps_tilde=eps_tilde(1.0, SHARD_N), margin=10.0,
                              ord=1.0)
    return [
        ("blocking/jacobi p=6", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="blocking", max_outer=5000, trace_len=5000)),
        ("nonblocking/jacobi p=6 hetero", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="nonblocking", max_outer=5000, trace_len=API_TRACE_LEN,
            **MESH_KNOBS)),
        ("nonblocking/hybrid p=6", 6, sr.ShardRuntimeConfig(
            monitor=mon, reduction="nonblocking", sweep="hybrid", max_outer=5000)),
        ("rdoubling/jacobi p=2", 2, sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000)),
        ("nonblocking/jacobi p=6 hetero l1", 6, sr.ShardRuntimeConfig(
            monitor=mon1, reduction="nonblocking", max_outer=5000, **MESH_KNOBS)),
    ]


def _run_cells(cells, dev) -> list:
    """Stacked runs of ``(name, p, ShardRuntimeConfig)`` cells at n = 150."""
    import torch

    from repro_torch.runtime import shard_runtime as sr

    n = SHARD_N
    st, b = _stencil(n), _rhs(n, dev)
    x0 = torch.zeros_like(b)
    return [_run(name, lambda: sr.make_convdiff_runtime(cfg, p, st, n, device=dev)(x0, b),
                 st, b, cfg.monitor.ord) for name, p, cfg in cells]


def run_shards(dev) -> list:
    """Phase 5: the stacked shard runtime at n = 150, f64, p = 6 (and p = 2)."""
    return _run_cells(shard_cells(), dev)


def mesh_cells() -> list:
    """Phase 6's runs: ``(name, mesh, ShardRuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import shard_runtime as sr

    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    mon1 = detection.for_mode("pfait", eps_tilde=eps_tilde(1.0, SHARD_N), margin=10.0,
                              ord=1.0)
    nfais2 = detection.for_mode("nfais2", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    return [
        ("(a) mesh (3,2) blocking/jacobi", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, reduction="blocking", max_outer=5000, trace_len=5000)),
        ("(b) mesh (3,2) nonblocking/jacobi hetero", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000, **MESH_KNOBS)),
        ("(b) mesh (3,2) nonblocking/jacobi hetero overlap", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000, overlap=True, **MESH_KNOBS)),
        ("(c) mesh (2,2,2) nonblocking/hybrid delay", (2, 2, 2), sr.ShardRuntimeConfig(
            monitor=mon, sweep="hybrid", max_outer=5000,
            halo_delay=(0, 1, 0, 2, 0, 1, 0, 1))),
        ("(d) mesh (2,2,2) rdoubling/jacobi", (2, 2, 2), sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000)),
        ("(e) mesh (3,2) nfais2/jacobi", (3, 2), sr.ShardRuntimeConfig(
            monitor=nfais2, max_outer=5000)),
        ("(f) mesh (3,2) blocking/jacobi l1", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon1, reduction="blocking", max_outer=5000, trace_len=5000)),
    ]


def run_mesh(dev) -> list:
    """Phase 6: the mesh shard runtime at n = 150, f64."""
    return _run_cells(mesh_cells(), dev)


def run_serve(dev) -> dict:
    """Phase 7: ``serve`` at full width on the card."""
    from repro_torch.launch.serve import serve

    return serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                 max_new=SERVE_NEW, use_reduced=False, seed=0, device=dev)


def pagerank_cells() -> list:
    """Phase 8's runs: ``(name, RuntimeConfig)``."""
    from repro_torch.core import detection
    from repro_torch.runtime import api

    eps = PAGERANK_EPS
    sync = detection.MonitorConfig(mode="sync", eps=eps, staleness=0, ord=1.0)

    def mon(mode):
        return detection.for_mode(mode, eps_tilde=eps, margin=10.0, staleness=4,
                                  persistence=4, ord=1.0)

    return [
        ("(a) blocking/sync", api.RuntimeConfig(
            monitor=sync, reduction="blocking", max_outer=1000, record_trace=True)),
        ("(b) nonblocking/pfait K=4 hetero", api.RuntimeConfig(
            monitor=mon("pfait"), reduction="nonblocking", max_outer=1000,
            record_trace=True, **PAGERANK_KNOBS)),
        ("(c) rdoubling/pfait", api.RuntimeConfig(
            monitor=mon("pfait"), reduction="rdoubling", max_outer=1000, record_trace=True)),
        ("(d) nonblocking/nfais2", api.RuntimeConfig(
            monitor=mon("nfais2"), reduction="nonblocking", max_outer=1000,
            record_trace=True)),
    ]


class PageRankRun(NamedTuple):
    """One PageRank run through ``runtime.api.run_shard``: its report and
    the kernel launches of its two runs (build and timed)."""

    name: str
    rep: object
    cfg: object
    used: dict


def run_pagerank(dev) -> dict:
    """Phase 8: PageRank at n = 16384, p = 4, f64, l1, through
    ``runtime.api.run_shard`` (the operator placed on the card once), and
    the 1-D p = 6 hetero Jacobi case of phase 5 through the same API."""
    import torch

    from repro_torch.core import detection
    from repro_torch.runtime import api
    from repro_torch.solvers.convdiff import Stencil, make_rhs
    from repro_torch.solvers.pagerank import PageRankProblem

    n, p, eps = PAGERANK_N, PAGERANK_P, PAGERANK_EPS
    t0 = time.perf_counter()
    prob = PageRankProblem(n=n, p=p, seed=0)
    t1 = time.perf_counter()
    P_host = prob.to_dense()
    t2 = time.perf_counter()
    P = torch.as_tensor(P_host, device=dev)
    torch.cuda.synchronize()
    print(f"pagerank n = {n}, p = {p}, seed 0: graph draw {t1 - t0:.2f} s, to_dense "
          f"{t2 - t1:.2f} s, placed on the card in {time.perf_counter() - t2:.2f} s "
          f"({P_host.nbytes / 2**30:.1f} GiB f64)")
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    cells = pagerank_cells()
    runs = []
    for name, cfg in cells:
        before = _launches()
        rep = api.run_shard("pagerank", cfg, p, n, x0, P, damping=prob.d, device=dev)
        runs.append(PageRankRun(name, rep, cfg,
                                {k: v - before[k] for k, v in _launches().items()}))
    # phase 5's 1-D p = 6 hetero Jacobi case, through the API
    cn = SHARD_N
    st = Stencil.for_contraction(cn, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)
    b = torch.as_tensor(make_rhs(cn, seed=0), device=dev)
    cmon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    ccfg = api.RuntimeConfig(monitor=cmon, reduction="nonblocking", max_outer=5000,
                             record_trace=True, **MESH_KNOBS)
    convdiff = api.run_shard("convdiff", ccfg, 6, cn, torch.zeros_like(b), b, stencil=st,
                             device=dev)
    return dict(prob=prob, P_host=P_host, P=P, runs=runs, convdiff=convdiff)


def verify_pagerank(out, shard_runs) -> None:
    """Every PageRank run converged with r* < ε̃ (l1, f64 on the card, equal
    to the host's ``PageRankProblem.exact_residual`` up to the f64 rounding
    of the residual), run (a) follows the synchronous reference trajectory
    and its detection is consistent with its exact trace; the convdiff API
    run is bitwise phase 5's run; every recorded trace validates.  Prints
    ms per step beside the step's matvec bound."""
    import numpy as np
    import torch

    from repro_torch.core import termination
    from repro_torch.core.trace import validate_trace
    from repro_torch.runtime import shard_runtime as sr

    prob, P, eps = out["prob"], out["P"], PAGERANK_EPS
    n, p, d, v = prob.n, prob.p, prob.d, prob.v
    nb = n // p
    for run in out["runs"]:
        rep = run.rep
        x = rep.x
        r_card = float((d * (P @ x) + v - x).abs().sum())
        scale = float((d * (P @ x.abs()) + v + x.abs()).sum())
        r_host = prob.exact_residual([x.cpu().numpy()])
        bar = 4 * F64_UNIT * scale
        scfg = run.cfg.to_shard_config()
        inner = float(np.broadcast_to(scfg.inner_sweeps, (p,)).sum())
        # rows of P swept a step: every shard's inner sweeps, the blocking
        # exact pass, and NFAIS2's exact verifications spread over the run
        passes = inner / p + (scfg.reduction == "blocking") + \
            rep.raw.verifications / max(rep.outer_iters, 1)
        bound_ms = 1e3 * passes * 8 * n * n / HBM_BYTES_PER_S
        step_ms = 1e3 * dict(rep.wall_segments)["run"] / rep.outer_iters
        print(f"pagerank {run.name}: converged={rep.converged} outer={rep.outer_iters} "
              f"verifications={rep.raw.verifications} detected={rep.detected_residual:.3e} "
              f"exact r* card {r_card:.6e} host {r_host:.6e} (|Δ| {abs(r_card - r_host):.2e}, "
              f"rel {abs(r_card - r_host) / r_host:.2e}; bar 4u·Σ(d·P|x| + v + |x|) = "
              f"{bar:.2e}; l1, ε̃ {eps:g}); {step_ms:.4f} ms/step against a matvec bound "
              f"of {bound_ms:.4f} ms ({passes:g} passes over {8 * n * n / 2**30:.0f} GiB a "
              f"step; {bound_ms / step_ms:.1%}); wall build {dict(rep.wall_segments)['build']:.3f}"
              f" s, run {dict(rep.wall_segments)['run']:.3f} s; launches {json.dumps(run.used)}")
        _require(rep.converged, f"pagerank {run.name}: did not converge")
        _require(r_host < eps and r_card < eps,
                 f"pagerank {run.name}: false detection, r* {r_host:.3e} >= ε̃")
        _require(abs(r_card - r_host) <= bar, f"pagerank {run.name}: r* on the card "
                 f"{r_card:.6e} departs from the host's {r_host:.6e}")
        _require(validate_trace(rep.trace), f"pagerank {run.name}: trace fails validate()")
    # where a step's time goes: one shard's sweep matvec alone, and the
    # device's busy share over a blocking and a heterogeneous run
    x = torch.full((n,), 1.0 / n, dtype=P.dtype, device=P.device)
    mv_ms, mv_call_ms = _time_ms(lambda: P[:nb] @ x)
    print(f"time torch.mv (cuBLAS) at {nb}x{n} f64, one shard's sweep matvec: {mv_ms:.4f} ms "
          f"(eager call {mv_call_ms:.4f} ms), bound {1e3 * 8 * nb * n / HBM_BYTES_PER_S:.4f} ms "
          f"(bytes)")
    for run in out["runs"][:2]:
        rerun = sr.make_runtime("pagerank", run.cfg.to_shard_config(), p, n, damping=d,
                                device=P.device)
        profile_window(f"pagerank {run.name}, one run of {run.rep.outer_iters} steps",
                       lambda: rerun(x, P))
    a = out["runs"][0].rep
    T = a.outer_iters
    ref = sr.pagerank_reference_trace(P, n, T, damping=d, ord=1.0).double()
    got = a.raw.trace[:T].double()
    err = float(((got - ref).abs() / ref.abs()).max())
    trace = a.raw.trace[:T].tolist()
    consistent = termination.detection_consistent(a.detect_step, trace, eps)
    print(f"pagerank (a): trace vs synchronous reference over {T} steps, max rel {err:.3e} "
          f"(tolerance 5e-5); oracle step {termination.oracle_detect_step(trace, eps)}, "
          f"detected at {a.detect_step}, consistent: {consistent}")
    _require(err <= 5e-5, f"pagerank (a): trace departs from the reference ({err:.3e})")
    _require(consistent, "pagerank (a): detection inconsistent with its exact trace")
    del ref, got
    c, c0 = out["convdiff"], shard_runs[1].r
    same = (c.outer_iters == c0.outer_iters and torch.equal(c.x, c0.x)
            and torch.equal(c.raw.trace, c0.trace))
    print(f"convdiff through run_shard, 1-D p = 6 hetero Jacobi: outer {c.outer_iters} / "
          f"{c0.outer_iters}, x and trace bitwise phase 5's: {same}; wall build "
          f"{dict(c.wall_segments)['build']:.3f} s, run {dict(c.wall_segments)['run']:.3f} s "
          f"({1e3 * dict(c.wall_segments)['run'] / c.outer_iters:.3f} ms/step)")
    _require(same, "convdiff run_shard is not bitwise phase 5's make_convdiff_runtime run")
    _require(validate_trace(c.trace), "convdiff run_shard: trace fails validate()")
    del out["P"], P
    torch.cuda.empty_cache()


# the distributed path: the stacked runs that each world repeats one shard
# per rank, by name (phases 5, 6 and 8), and the runs this phase adds
DIST_SHARD_RUNS = ("blocking/jacobi p=6", "nonblocking/jacobi p=6 hetero",
                   "nonblocking/hybrid p=6", "nonblocking/jacobi p=6 hetero l1")
DIST_MESH_RUNS = ("(a) mesh (3,2) blocking/jacobi", "(b) mesh (3,2) nonblocking/jacobi hetero",
                  "(b) mesh (3,2) nonblocking/jacobi hetero overlap",
                  "(e) mesh (3,2) nfais2/jacobi")
DIST_SOLVER_RUN = "pfait/hybrid/fused"     # phase 4's, again on a (1, 1) NCCL group
DIST_N4 = 152                              # 1-D p = 4 needs 4 | n
DIST_KERNELS = ("fused_sweep_residual", "fused_rbgs_sweep_residual",
                "fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo",
                "diff_norm_partials")


class DistRun(NamedTuple):
    """The distributed path: per world its ranks' reports and wall, the
    stacked twins this phase ran itself, and the launches made inside the
    worlds (every rank, every case), also by (stencil kernel, block shape)."""

    worlds: dict
    twins: list
    world_launches: dict
    world_shapes: Counter


def dist_cells():
    """``(stacked twins to run here, worlds)``: a twin is ``(name, p,
    ShardRuntimeConfig or SolverConfig, n)``; a world is ``(label, k,
    backend, [Case])``, each case named after its stacked twin."""
    import dataclasses as dc

    from repro_torch.core import detection
    from repro_torch.launch.worlds import Case, Inputs
    from repro_torch.runtime import shard_runtime as sr

    cd, cd4 = Inputs("convdiff", SHARD_N, rho=0.95), Inputs("convdiff", DIST_N4, rho=0.95)
    mon = detection.for_mode("pfait", eps_tilde=EPS_TILDE, margin=10.0, ord=INF)
    st = _stencil(SHARD_N)
    solver = dict((label, cfg) for label, cfg, _ in solver_cells(_stencil(SOLVER_N)))
    hybrid = dc.replace(solver[DIST_SOLVER_RUN], stencil=st)
    twins = [
        ("(g) mesh (3,2) nonblocking/hybrid hetero", (3, 2), sr.ShardRuntimeConfig(
            monitor=mon, sweep="hybrid", max_outer=5000, trace_len=5000, **MESH_KNOBS),
         SHARD_N),
        ("make_sharded_solver (3,2) hybrid fused", (3, 2), hybrid, SHARD_N),
        ("rdoubling/jacobi p=4 n=152", 4, sr.ShardRuntimeConfig(
            monitor=mon, reduction="rdoubling", max_outer=5000, trace_len=5000), DIST_N4),
        ("nonblocking/jacobi p=1", 1, sr.ShardRuntimeConfig(
            monitor=mon, max_outer=5000, trace_len=5000), SHARD_N),
    ]
    own = {name: (p, cfg) for name, p, cfg, _ in twins}
    shard = {name: (p, cfg) for name, p, cfg in shard_cells() + mesh_cells()}
    six = [Case(name, "runtime", shard[name][1], _shape(shard[name][0]), cd)
           for name in DIST_SHARD_RUNS + DIST_MESH_RUNS]
    six += [Case(twins[0][0], "runtime", twins[0][2], (3, 2), cd),
            Case(twins[1][0], "solver", hybrid, (3, 2), cd)]
    four = [Case(name, "api", cfg, (PAGERANK_P,),
                 Inputs("pagerank", PAGERANK_N, p=PAGERANK_P))
            for name, cfg in pagerank_cells()]
    four.append(Case(twins[2][0], "runtime", own[twins[2][0]][1], (4,), cd4))
    one = [Case(twins[3][0], "runtime", own[twins[3][0]][1], (1,), cd),
           Case(DIST_SOLVER_RUN, "solver", solver[DIST_SOLVER_RUN], (1, 1),
                Inputs("convdiff", SOLVER_N, rho=0.95))]
    worlds = [("gloo x6", 6, "gloo", six), ("gloo x4", 4, "gloo", four),
              ("nccl x1", 1, "nccl", one)]
    return twins, worlds


def _shape(p):
    return tuple(p) if isinstance(p, tuple) else (p,)


def run_distributed(dev) -> DistRun:
    """Phase 9: one shard per process over ``torch.distributed``, in spawned
    worlds on the one card (gloo ranks share ``cuda:0`` and stage through
    host memory; NCCL at world size 1), each run held later to its stacked
    twin.  The twins this phase adds run here first, stacked."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import run_cases
    from repro_torch.runtime import shard_runtime as sr
    from repro_torch.solvers.fixed_point import SolverConfig, make_sharded_solver

    twin_cells, worlds = dist_cells()
    twins = []
    for name, p, cfg, n in twin_cells:
        st, b = _stencil(n), _rhs(n, dev)
        x0 = torch.zeros_like(b)
        if isinstance(cfg, SolverConfig):
            fn = lambda: make_sharded_solver(cfg, p, device=dev)(x0, b)  # noqa: E731
        else:
            fn = lambda: sr.make_convdiff_runtime(cfg, p, st, n, device=dev)(x0, b)  # noqa: E731
        twins.append(_run(name, fn, st, b, cfg.monitor.ord))
    out, inside, shapes = {}, Counter(), Counter()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as store:
        for label, k, backend, cases in worlds:
            t0 = time.perf_counter()
            ranks = spawn_world(run_cases, k, store, args=(backend, cases, None),
                                timeout=600)
            out[label] = dict(ranks=ranks, cases=cases, wall=time.perf_counter() - t0,
                              k=k, backend=backend)
            for r in ranks:
                for c in r["cases"]:
                    inside.update(c["launches"])
                    shapes.update(c["launch_shapes"])
    return DistRun(out, twins, dict(inside), shapes)


def verify_distributed(dist_run: DistRun, runs: dict, card: str) -> None:
    """Every distributed run equals its stacked twin (same iterations,
    detection and verifications, ``x`` bitwise, the trace bitwise at l∞
    and within p·2^-24 relative at l1/l2, since the group sums the lanes in
    another order), every rank reports the same outcome, and the ms per
    step and host-staged bytes per step are printed beside the twin's."""
    import numpy as np

    twin = {run.name: (run.r, run.wall, run.ord) for run in
            runs["solve_single"] + runs["1-D shard runtime"] + runs["mesh shard runtime"]
            + dist_run.twins}
    for run in runs["pagerank shard runtime"]["runs"]:
        twin[run.name] = (run.rep.raw, dict(run.rep.wall_segments)["run"], 1.0)
    print(f"distributed path on {card}: ranks that share one card time the transport's "
          "host cost (gloo stages every face and lane through host memory), not a "
          "multi-GPU run")
    for label, w in dist_run.worlds.items():
        print(f"world {label} ({w['backend']}, {w['k']} ranks): {w['wall']:.1f} s, spawn "
              "and every rank's inputs included")
        for i, case in enumerate(w["cases"]):
            got = [r["cases"][i] for r in w["ranks"]]
            g = got[0]
            want, wall, ord_ = twin[case.name]
            tag = f"{label} {case.name}"
            _require(g["name"] == case.name and g["converged"], f"{tag}: did not converge")
            for c in got[1:]:
                _require(all(c[key] == g[key] for key in (
                    "outer_iters", "converged", "residual", "verifications", "x_digest"))
                    and (g["trace"] is None or np.array_equal(c["trace"], g["trace"])),
                    f"{tag}: rank {c['rank']} disagrees with rank 0")
            same = (g["outer_iters"] == want.outer_iters
                    and g["converged"] == bool(want.converged)
                    and g["verifications"] == int(getattr(want, "verifications", 0))
                    and np.array_equal(g["x"], want.x.cpu().numpy()))
            gap, bar = 0.0, w["k"] * 2.0 ** -24
            if g["trace"] is not None:
                t, ref = g["trace"], want.trace.cpu().numpy()
                fin = np.isfinite(ref)
                same = same and np.array_equal(np.isfinite(t), fin)
                gap = float(np.max(np.abs(t[fin] - ref[fin]) / np.abs(ref[fin]), initial=0.0))
            rgap = abs(g["residual"] - float(want.residual)) / abs(float(want.residual))
            gap = max(gap, rgap)
            ok = same and (gap == 0.0 if ord_ == INF else gap <= bar)
            steps = max(g["outer_iters"], 1)
            per_step = steps * g["runs"] * len(got)   # per rank and step
            staged = sum(c["staged_bytes"] for c in got) / (steps * g["runs"])
            staged_ms = 1e3 * sum(c["staged_s"] for c in got) / per_step
            wait_ms = 1e3 * sum(c["wait_s"] for c in got) / per_step
            print(f"  {case.name}: outer {g['outer_iters']} / stacked {want.outer_iters}, "
                  f"verifications {g['verifications']}, x bitwise and iterations equal: "
                  f"{same}; trace and residual {_ord_tag(ord_)}: largest relative gap "
                  f"{gap:.3e} (bar {'0' if ord_ == INF else f'{bar:.3e}'}); "
                  f"{1e3 * g['wall_s'] / steps:.4f} ms/step against stacked "
                  f"{1e3 * wall / max(want.outer_iters, 1):.4f}; host-staged "
                  f"{staged:.0f} B/step (all ranks); a rank's step: staging "
                  f"{staged_ms:.4f} ms (its stream synchronisations included), blocked "
                  f"in transfers {wait_ms:.4f} ms (mean over ranks); ranks agree")
            _require(ok, f"{tag}: departs from its stacked twin")
    print(f"main-path launches inside the worlds: {json.dumps(dist_run.world_launches)}")


def warm_serve(dev) -> None:
    """A short serve at the same width and prompt length before the main
    paths (its launches are not counted), so the counted serve run is warm;
    prints the cold first prefill."""
    from repro_torch.launch.serve import serve

    out = serve(SERVE_ARCH, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT, max_new=2,
                use_reduced=False, seed=0, device=dev)
    print(f"serve warm-up (cold start): prefill {1e3 * out['prefill_s']:.3f} ms, "
          f"decode {1e3 * out['decode_s']:.3f} ms for 1 step")


def _jax_bar(got, want) -> float:
    """The JAX contract's bar for two computations of the same logits
    (``tests/test_models.py:88-91``): the worst element's share of
    5e-2 + 1e-2·|want| (≤ 1 passes)."""
    return float(((got - want).abs() / (5e-2 + 1e-2 * want.abs())).max())


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def verify_serve(out, used, dev) -> None:
    """The serve run's shape, health and launches; then the kernel inside
    the model at full width.

    f32 (the bf16 weights cast to f32, every op in f32): prefill logits
    with #6 against the plain attention, max|Δ| ≤ 1e-4 × max|logit|
    (summation order through 28 layers), and prefill(S−1) + one decode vs
    prefill(S) at the JAX bar.  bf16: two plain evaluations of this model
    (block_kv 512 and 256 against 1024) drift apart by more than the JAX
    bar, so the kernel vs the plain attention, and the decode path vs the
    kernel's prefill, are held at ``BF16_MODEL_BAR`` times it, which must
    lie above both plain drifts and below a plain evaluation that drops kv
    tile 0 for the last 64 rows of every layer; and both bf16 paths must
    be as accurate as the plain attention against the f32 plain prefill,
    max|Δ| ≤ 1.5 × max|plain − f32|."""
    import copy

    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import forward

    cfg = get_arch(SERVE_ARCH)
    steps = out["steps"]
    print(f"serve {SERVE_ARCH} full width (bf16, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}), batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, max_new {SERVE_NEW}: "
          f"tokens {out['tokens'].shape}, steps {steps}, stopped_by {out['stopped_by']}, "
          f"prefill {1e3 * out['prefill_s']:.3f} ms, decode {1e3 * out['decode_s'] / steps:.3f} "
          f"ms/step, {out['tok_per_s']:.1f} tok/s over the whole run "
          f"({SERVE_BATCH * steps / out['decode_s']:.1f} tok/s in the decode loop), "
          f"flash launches {used['flash_attention_flat']}")
    _require(used["flash_attention_flat"] == cfg.num_layers,
             f"serve: {used['flash_attention_flat']} flash launches, want one per layer "
             f"({cfg.num_layers}) in the one prefill")
    _require(out["logits_finite"], "serve: NaN or inf in the logits")
    _require(out["tokens"].shape == (SERVE_BATCH, SERVE_NEW),
             f"serve: tokens {out['tokens'].shape}")
    _require(out["stopped_by"] in ("budget", "detector"), f"serve: {out['stopped_by']}")

    S = SERVE_PROMPT
    prompts = torch.as_tensor(make_prompts(cfg.vocab_size, SERVE_BATCH, S, 0),
                              device=dev).long()
    m16 = Model(cfg, device=dev)
    p16 = m16.init(torch.Generator(device=dev).manual_seed(0))
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), device=dev)
    p32 = copy.deepcopy(p16).float()
    # plain-attention evaluations: the reference, two of its block sizes,
    # and a faulty one that drops kv tile 0 for the last 64 rows
    plains = {"plain": {}, "plain512": {"block_kv": 512}, "plain256": {"block_kv": 256},
              "faulty": {"window": S - 64}}
    logits = {}
    with torch.inference_mode():
        for tag, m, p in (("bf16", m16, p16), ("f32", m32, p32)):
            prefill, decode = m.make_prefill(), m.make_decode_step()
            logits[tag, "kernel"], _ = prefill(p, prompts)
            for name, knobs in plains.items():
                if tag == "f32" and name != "plain":
                    continue
                x, head, _, _ = forward(p, prompts, m.plan, m._ctx("prefill")._replace(
                    use_kernel=False, **knobs))
                logits[tag, name] = L.lm_head(x[:, -1:], head)
                del x
            _, cache = prefill(p, prompts[:, :S - 1], max_len=S)
            logits[tag, "decode"], _ = decode(p, cache, prompts[:, S - 1:], S - 1)
            del cache
    for v in logits.values():
        _require(bool(v.isfinite().all()), "in-model check: non-finite logits")
    ref = logits["f32", "plain"]
    scale = float(ref.abs().max())
    f32_kernel = _maxdiff(logits["f32", "kernel"], ref)
    f32_decode = _jax_bar(logits["f32", "decode"], logits["f32", "kernel"])
    err = {k: _maxdiff(logits["bf16", k], ref) for k in ("kernel", "plain", "decode")}
    # bf16 pairs: JAX-bar share and rms(Δ)/rms(want)
    pairs = {"kernel vs plain": ("kernel", "plain"), "decode vs prefill": ("decode", "kernel"),
             "plain block 512 vs 1024": ("plain512", "plain"),
             "plain block 256 vs 1024": ("plain256", "plain"),
             "faulty vs plain": ("faulty", "plain")}
    bar, rel = {}, {}
    for name, (a, b) in pairs.items():
        got, want = logits["bf16", a], logits["bf16", b]
        bar[name] = _jax_bar(got, want)
        rel[name] = float((got - want).square().mean().sqrt() / want.square().mean().sqrt())
    drift = max(bar["plain block 512 vs 1024"], bar["plain block 256 vs 1024"])
    print(f"in-model, f32: prefill logits flash kernel vs plain attention max|Δ| "
          f"{f32_kernel:.3e} over logits up to {scale:.3e} ({f32_kernel / scale:.2e} of the "
          f"largest; tolerance 1e-4); prefill over {S - 1} + one decode vs prefill over {S}: "
          f"worst element at {f32_decode:.4f} of the JAX bar (atol 5e-2 + rtol 1e-2)")
    print(f"in-model, bf16 against the f32 plain prefill: max|Δ| kernel {err['kernel']:.3e}, "
          f"plain {err['plain']:.3e}, prefill over {S - 1} + decode {err['decode']:.3e}; "
          f"ratios to plain {err['kernel'] / err['plain']:.3f} / "
          f"{err['decode'] / err['plain']:.3f} (tolerance 1.5)")
    print(f"in-model, bf16 pairs, worst element's share of the JAX bar (gated at "
          f"{BF16_MODEL_BAR:g}: kernel and decode at most, plain drifts at most, faulty above) "
          f"and rms(Δ)/rms(want): " + "; ".join(
              f"{name} {bar[name]:.3f}, {rel[name]:.3e}" for name in pairs))
    profile_serve(m16, p16, prompts)
    del p16, p32, logits, ref
    torch.cuda.empty_cache()
    _require(f32_kernel <= 1e-4 * scale, "f32 in-model: flash kernel departs from the plain "
             "attention")
    _require(f32_decode <= 1.0, "f32 in-model: decode departs from prefill (JAX bar)")
    _require(err["kernel"] <= 1.5 * err["plain"], "bf16 in-model: the flash kernel is less "
             "accurate than the plain attention")
    _require(err["decode"] <= 1.5 * err["plain"], "bf16 in-model: decode is less accurate "
             "than the plain prefill")
    _require(drift <= BF16_MODEL_BAR < bar["faulty vs plain"], "bf16 in-model: the bar "
             "does not lie between the plain drift and the faulty evaluation")
    _require(bar["kernel vs plain"] <= BF16_MODEL_BAR, "bf16 in-model: the flash kernel "
             "departs from the plain attention past the bar")
    _require(bar["decode vs prefill"] <= BF16_MODEL_BAR, "bf16 in-model: decode departs "
             "from prefill past the bar")


def profile_window(name, fn) -> None:
    """Device time by kernel and the device's busy share over one call of
    ``fn``, from ``torch.profiler`` (diagnostic only: a profiler that
    cannot trace the card prints so and the run goes on)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    # kernels only: an aten op's device time repeats its kernels'
    rows = sorted(((getattr(e, "device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()
                   if getattr(e, "device_type", None) == DeviceType.CUDA), reverse=True)
    if not rows:
        print(f"profile {name}: wall {wall_us / 1e3:.3f} ms; the profiler saw no kernels")
        return
    busy = sum(r[0] for r in rows)   # one stream: the kernels do not overlap
    print(f"profile {name}: wall {wall_us / 1e3:.3f} ms, kernels {busy / 1e3:.3f} ms "
          f"(device busy {100 * busy / wall_us:.1f}%); top kernels by device time:")
    for dev_us, count, key in rows[:10]:
        print(f"  {dev_us / 1e3:9.3f} ms  {count:6d}×  {key[:90]}")


def profile_serve(m, params, prompts) -> None:
    """``profile_window`` over one warm prefill and 4 decode steps."""
    import torch

    S = prompts.shape[1]
    prefill, decode = m.make_prefill(), m.make_decode_step()

    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, prompts, max_len=S + 4)

    def run_decode():
        tok = state["logits"][:, -1].argmax(dim=-1)
        for i in range(4):
            logits, state["cache"] = decode(params, state["cache"], tok[:, None], S + i)
            tok = logits[:, -1].argmax(dim=-1)

    with torch.inference_mode():
        profile_window("prefill (warm)", run_prefill)
        profile_window("4 decode steps", run_decode)
    state.clear()


def exact_residual(st, x, b, ord=INF):
    """The exact residual of a global state in the run's norm, through the
    residual kernel: max|b − A x| (l∞) or Σ|b − A x| (l1)."""
    from repro_torch.kernels.jacobi3d import ops as jops
    from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

    return float(jops.residual_contribution(st, ghosted(x, _zero_ghosts(x)), b, ord=ord))


def _check_trace(run: Run) -> None:
    """A blocking run follows the synchronous reference trajectory in its
    norm, and its detection is consistent with that exact trace
    (``core.termination``)."""
    from repro_torch.core import termination
    from repro_torch.runtime import shard_runtime as sr

    T = run.r.outer_iters
    ref = sr.convdiff_reference_trace(run.st, run.b, T, ord=run.ord)
    err = float(((run.r.trace[:T].double() - ref.double()).abs() / ref.double().abs()).max())
    trace, target = run.r.trace[:T].tolist(), eps_tilde(run.ord, run.b.shape[0])
    consistent = termination.detection_consistent(T - 1, trace, target)
    print(f"{run.name}: trace vs synchronous reference ({_ord_tag(run.ord)}) over {T} steps, "
          f"max rel {err:.3e} (tolerance 5e-5); oracle step "
          f"{termination.oracle_detect_step(trace, target)}, detected at {T - 1}, "
          f"consistent: {consistent}")
    _require(err <= 5e-5, f"{run.name}: trace departs from the reference ({err:.3e})")
    _require(consistent, f"{run.name}: detection inconsistent with its exact trace")


def verify_runs(solver_runs, shard_runs, mesh_runs, dist_twins=()) -> None:
    """r* < ε̃ for every run, in its norm (no false detection), the
    distributed path's stacked twins included; blocking follows the
    synchronous reference trajectory; comm overlap is bitwise no overlap."""
    import torch

    from repro_torch.solvers import jacobi
    from repro_torch.solvers.fixed_point import _zero_ghosts, ghosted

    # the exact residual through the kernel against the plain version: l∞
    # exact up to the f32 cast, l1 up to f32 summation order
    for run, tol in ((solver_runs[0], 1e-6), (solver_runs[-1], 1e-5)):
        r = jacobi.residual_block(run.st, ghosted(run.r.x, _zero_ghosts(run.r.x)), run.b).abs()
        plain = float(r.max() if run.ord == INF else r.sum())
        kern = exact_residual(run.st, run.r.x, run.b, run.ord)
        _require(abs(kern - plain) <= tol * plain,
                 f"exact {_ord_tag(run.ord)} residual: kernel {kern:.6e} vs plain {plain:.6e}")
    for run in solver_runs + shard_runs + mesh_runs + list(dist_twins):
        r = run.r
        r_star = exact_residual(run.st, r.x, run.b, run.ord)
        target = eps_tilde(run.ord, run.b.shape[0])
        print(f"run {run.name}: converged={r.converged} outer={r.outer_iters} "
              f"detected={float(r.residual):.3e} exact r*={r_star:.3e} ({_ord_tag(run.ord)}, "
              f"ε̃ {target:g}) wall={run.wall:.3f} s launches={json.dumps(run.used)}")
        _require(r.converged, f"{run.name}: did not converge")
        _require(r_star < target, f"{run.name}: false detection, r* {r_star:.3e} >= ε̃")
    for run in (shard_runs[0], mesh_runs[0], mesh_runs[-1]):
        _check_trace(run)
    r0, r1 = (run.r for run in mesh_runs[1:3])
    wall0, wall1 = (run.wall for run in mesh_runs[1:3])
    same = (r0.outer_iters == r1.outer_iters and torch.equal(r0.x, r1.x)
            and torch.equal(r0.trace, r1.trace))
    print(f"overlap vs no overlap, (3,2) hetero: outer {r1.outer_iters} / {r0.outer_iters}, "
          f"x and trace bitwise equal: {same}; wall {wall1:.3f} / {wall0:.3f} s")
    _require(same, "comm overlap is not bitwise equal to no overlap")
    r1d, wall1d = shard_runs[1].r, shard_runs[1].wall
    print(f"wall, same knobs at n = {SHARD_N}: mesh (3,2) {wall0:.3f} s for "
          f"{r0.outer_iters} steps ({1e3 * wall0 / r0.outer_iters:.3f} ms/step) vs 1-D p = 6 "
          f"{wall1d:.3f} s for {r1d.outer_iters} steps "
          f"({1e3 * wall1d / r1d.outer_iters:.3f} ms/step)")


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


KERNELS = {
    "fused_sweep_residual": ("src/repro_torch/csrc/jacobi3d.cu",
                             "src/repro/kernels/jacobi3d/jacobi3d.py:453"),
    "fused_rbgs_sweep_residual": ("src/repro_torch/csrc/jacobi3d.cu",
                                  "src/repro/kernels/jacobi3d/jacobi3d.py:131"),
    "diff_norm_partials": ("src/repro_torch/csrc/residual_norm.cu",
                           "src/repro/kernels/residual_norm/residual_norm.py:34"),
    "fused_sweep_residual_halo": ("src/repro_torch/csrc/jacobi3d_halo.cu",
                                  "src/repro/kernels/jacobi3d/jacobi3d.py:368"),
    "fused_rbgs_sweep_residual_halo": ("src/repro_torch/csrc/jacobi3d_halo.cu",
                                       "src/repro/kernels/jacobi3d/jacobi3d.py:412"),
    "flash_attention_flat": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/flash_attention.py:90"),
}
# the main paths (phases 4–8) and the kernels each must launch
PATHS = (
    ("solve_single", run_solver, ("fused_sweep_residual", "fused_rbgs_sweep_residual")),
    ("1-D shard runtime", run_shards,
     ("fused_sweep_residual", "fused_rbgs_sweep_residual", "diff_norm_partials")),
    ("mesh shard runtime", run_mesh,
     ("fused_sweep_residual_halo", "fused_rbgs_sweep_residual_halo")),
    ("serve", run_serve, ("flash_attention_flat",)),
    ("pagerank shard runtime", run_pagerank, ("diff_norm_partials", "fused_sweep_residual")),
    # the stacked twins run in this process; the kernels are required of
    # the launches inside the worlds
    ("distributed shard runtime", run_distributed, DIST_KERNELS),
)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.solvers.convdiff import Stencil

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({len(logs)} sources compiled)")
    for line in "\n".join(logs).splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas:", line.strip())

    st = Stencil.for_contraction(SOLVER_N, nu=1.0, a=(1.0, 1.0, 1.0), rho=0.95)
    check = Checker()
    check_kernels(st, dev, check)
    check_flash(dev, check)
    sass = tensor_core_sass()
    if sass is None:
        print("flash library SASS: no cuobjdump in the toolkit, tensor-core instructions "
              "could not be counted")
    else:
        print(f"flash library SASS: {sass['HGMMA']} HGMMA (wgmma) and {sass['HMMA']} HMMA "
              f"(mma.sync) instructions")
        _require(sass["HGMMA"] > 0, "the flash library has no wgmma instruction")
    times = time_kernels(st, dev)
    flash_time = time_flash(dev)
    print(nvidia_smi())  # the card and power limit the times were taken at

    # the main paths: launch counters from 0 just before each, read just after
    from repro_torch.kernels.jacobi3d import jacobi3d as jk

    runs, used_by, launches = {}, {}, dict.fromkeys(KERNELS, 0)
    shape_launches = Counter()   # (stencil kernel, block shape) -> main-path launches
    warm_serve(dev)
    for path, fn, kernels in PATHS:
        _reset_launches()
        runs[path] = fn(dev)
        torch.cuda.synchronize()
        used_by[path] = used = _launches()
        print(f"main-path launches, {path}:", json.dumps(used))
        shape_launches.update(jk.LAUNCH_SHAPES)
        need = used
        if isinstance(runs[path], DistRun):
            # required of the ranks' own launches, not of the stacked twins
            need = runs[path].world_launches
            _require(bool(need), "the worlds reported no launch counters")
            for k in launches:
                launches[k] += need.get(k, 0)
            shape_launches.update(runs[path].world_shapes)
        for k in kernels:
            _require(need.get(k, 0) > 0, f"{k}: not launched on the {path} path")
        for k in launches:
            launches[k] += used[k]
    checked = {k: set((HALO_SHAPES if "halo" in k else SHAPES).values())
               for k, _ in shape_launches}
    unchecked = sorted(f"{k} {_shape_str(s)}" for k, s in shape_launches
                       if s not in checked[k])
    _require(not unchecked, f"main-path launches at shapes never held against the "
                            f"plain version: {unchecked}")
    print(f"every (stencil kernel, block shape) the main paths launched, in this process "
          f"and inside the worlds ({len(shape_launches)} pairs), was held against its "
          f"plain version above")
    verify_runs(*(runs[path] for path, _, _ in PATHS[:3]), runs["distributed shard runtime"].twins)
    verify_serve(runs["serve"], used_by["serve"], dev)
    verify_distributed(runs["distributed shard runtime"], runs, nvidia_smi())
    verify_pagerank(runs["pagerank shard runtime"], runs["1-D shard runtime"])
    rank_launches(st, dev, shape_launches, times)

    rows = []
    for k, (source, replaces) in KERNELS.items():
        if k == "flash_attention_flat":
            t, shape, out = flash_time, "48x2048x128 kv 8 bf16 causal", "block"
        elif k == "diff_norm_partials":
            # its main-path shape, the 1-D shard block; 185³ is on a "time" line
            t, shape, out = times[k, SHAPES["shard"]], "25x150x150 f64", "partials"
        else:
            # the swept block's error; the other shapes' times are on the
            # "time ..." and "rank" lines above
            t, shape, out = times[k, SHAPES["main"]], "185x185x185 f64", "block"
        rows.append(dict(
            name=k, route="cuda", source=source, replaces=replaces,
            launches=launches[k], max_abs_err=check.abs_err[k, out],
            max_abs_err_of=out, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=t["library_ms"], shape=shape))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
