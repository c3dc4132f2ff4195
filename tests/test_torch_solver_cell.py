"""The paper's solver cell in the port's dry run (``launch/dryrun.py:
lower_solver_cell``) against the JAX package's, and the pieces it runs on.

* The ``meta`` paths of kernel #1 (``fused_sweep_residual``, both ops)
  and #5 (``diff_norm_partials``): at the cell's blocks (4 × 1024 × 1024
  and 2 × 1024 × 1024 f32, #1 on the ghosted block) and a small ragged
  one, the outputs have the plain version's shapes and dtypes, the work
  reported is ``work(...)``, and inputs that mix ``meta`` with the CPU
  raise.
* The dry transport (``launch.mesh.dry_shard_group``): at p = 4, n = 16,
  the solve with ``max_outer`` K counts 2K + 2 collective-permutes of one
  face and K all-reduces of 4 bytes, on rank 0 and on an interior rank,
  whether or not the rank has a peer each way, and no all-gather.
* The record against JAX's own ``lower_solver_cell`` on both meshes (one
  subprocess with 512 forced host devices, x64 off as JAX's dry run runs):
  JAX's keys but ``xla_*``; argument bytes, collective counts, ``bytes_alg``
  and ``bytes_wire`` equal kind for kind; output bytes within 1 KiB (the
  rank's block and the monitor's scalars); FLOPs within ``FLOP_RATIO`` of
  JAX's ``xla_flops_per_device`` × 20000 (XLA counts 70 operations a cell an
  outer iteration, the kernels report 4 sweeps × 18 + #5's 3 = 75: 75/70 =
  1.0714); HBM bytes within ``HBM_RATIO`` of JAX's (the port's ghost
  assembly copies and XLA's fusions differ: 0.988 and 1.001 when this test
  was written).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.jacobi3d import jacobi3d as jk
from repro_torch.kernels.jacobi3d import ref as jref
from repro_torch.kernels.residual_norm import ref as rref
from repro_torch.kernels.residual_norm import residual_norm as rk
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import dry_shard_group
from repro_torch.solvers.convdiff import Stencil

ROOT = Path(__file__).resolve().parents[1]
CELL_BLOCKS = ((4, 1024, 1024), (2, 1024, 1024))
SMALL_BLOCK = (3, 9, 5)
FLOP_RATIO = (1.05, 1.10)
HBM_RATIO = (0.95, 1.05)
OUTPUT_SLACK = 1024
COEFS = Stencil.for_contraction(16, 1.0, (1.0, 1.0, 1.0), rho=0.95).coefs


def _counted(fn, *args):
    """What ``fn`` reports to a counting mode, and its result."""
    sink = [0.0, 0.0]
    _build.WORK_SINKS.append(sink)
    try:
        out = fn(*args)
    finally:
        _build.WORK_SINKS.remove(sink)
    return tuple(sink), out


def _like(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _like(x, y)
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)


@pytest.mark.parametrize("op", ["sweep", "residual"])
@pytest.mark.parametrize("shape", [*CELL_BLOCKS, SMALL_BLOCK])
def test_sweep_meta_path(shape, op):
    bx, by, bz = shape
    gshape = (bx + 2, by + 2, bz + 2)
    g = torch.zeros(gshape, dtype=torch.float32, device="meta")
    b = torch.zeros(shape, dtype=torch.float32, device="meta")
    work, got = _counted(lambda: jk.fused_sweep_residual(g, b, COEFS, op=op, ord=2.0))
    assert all(t.device.type == "meta" for t in got)
    want = jref.fused_sweep_residual_ref(torch.zeros(gshape), torch.zeros(shape), COEFS,
                                         op=op, ord=2.0)
    _like(got, want)
    assert work == jk.work(shape, 4, op)
    cells, nx, ny = bx * by * bz, *jref.tile_grid(bx, by, jref.DEFAULT_TILE)[2:]
    assert work == ((18 if op == "sweep" else 16) * cells,
                    4 * (gshape[0] * gshape[1] * gshape[2] + (2 if op == "sweep" else 1) * cells)
                    + 4 * nx * ny)
    # a dry rank's counting mode sees the same work, in FLOPs and bytes
    st = hlo_analysis.count_program(
        lambda g, b: jk.fused_sweep_residual(g, b, COEFS, op=op), g, b)
    assert st.flops == work[0] and st.hbm_bytes >= work[1]


@pytest.mark.parametrize("shape", [*CELL_BLOCKS, SMALL_BLOCK])
def test_diff_norm_meta_path(shape):
    a = torch.zeros(shape, dtype=torch.float32, device="meta")
    b = torch.zeros(shape, dtype=torch.float32, device="meta")
    work, got = _counted(lambda: rk.diff_norm_partials(a, b, ord=2.0))
    _like((got,), (rref.diff_norm_partials_ref(torch.zeros(shape), torch.zeros(shape),
                                               ord=2.0),))
    n = a.numel()
    assert work == rk.work(n, 4) == (3 * n, 8 * n + 4 * -(-n // 65536))
    assert rk.work(n, 8, block=n) == (3 * n, 16 * n + 4)


def test_meta_paths_refuse_mixed_devices():
    g = torch.zeros((6, 11, 7), device="meta")
    b = torch.zeros((4, 9, 5))
    with pytest.raises(ValueError, match="one CUDA device"):
        jk.fused_sweep_residual(g, b, COEFS)
    with pytest.raises(ValueError, match="one CUDA device"):
        rk.diff_norm_partials(torch.zeros(5, device="meta"), torch.zeros(5))
    with pytest.raises(ValueError, match="ghosted block"):
        jk.fused_sweep_residual(torch.zeros((6, 11, 8), device="meta"),
                                torch.zeros((4, 9, 5), device="meta"), COEFS)


@pytest.mark.parametrize("rank", [0, 2])
@pytest.mark.parametrize("outer", [1, 3])
def test_dry_transport_counts(rank, outer):
    p, n = 4, 16
    group = dry_shard_group(p, rank)
    run = dryrun.solver_cell(group, n, max_outer=outer)
    x0 = torch.zeros((n // p, n, n), device="meta")
    traced = hlo_analysis.trace_program(run, x0, torch.zeros_like(x0), mesh=group)
    st = traced.stats
    face = 4 * n * n
    assert dict(st.coll_counts) == {"collective-permute": 2 * outer + 2, "all-reduce": outer}
    assert dict(st.coll_bytes_alg) == {"collective-permute": (2 * outer + 2) * face,
                                       "all-reduce": 4 * outer}
    assert group.calls == {("collective_permute", p): (2 * outer + 2, (2 * outer + 2) * face),
                           ("all_reduce", p): (outer, 4 * outer)}
    # the rank's block and the monitor's scalars come back, gathered nowhere
    res = traced.out
    assert res.x.shape == (n // p, n, n) and res.x.device.type == "meta"
    assert res.outer_iters == outer and list(res.local_sweeps) == [4 * outer] * p
    # 4 sweeps (#1) and one contribution (#5) an outer iteration
    cells = (n // p) * n * n
    assert st.flops == outer * (4 * 18 * cells + 3 * cells)


@pytest.fixture(scope="module")
def jax_records():
    """JAX's ``lower_solver_cell`` on both meshes, in a subprocess: its
    module forces 512 host devices at import."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    code = ("import json\nfrom repro.launch import dryrun\n"
            "print(json.dumps([dryrun.lower_solver_cell(m) for m in (False, True)]))")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("multi", [False, True])
def test_solver_cell_matches_jax(jax_records, multi):
    want = jax_records[multi]
    got = dryrun.lower_solver_cell(multi)
    assert got.keys() == want.keys()
    for k in ("arch", "solver_max_outer", "shape", "mesh", "shards", "kind"):
        assert got[k] == want[k], k
    assert got["memory"].keys() == want["memory"].keys()
    assert got["cost"].keys() == {k for k in want["cost"] if not k.startswith("xla_")}
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    assert got["memory"]["alias_bytes"] == want["memory"]["alias_bytes"] == 0
    block = want["memory"]["argument_bytes"] // 2
    assert block <= got["memory"]["output_bytes"] < block + OUTPUT_SLACK
    assert abs(got["memory"]["output_bytes"] - want["memory"]["output_bytes"]) <= OUTPUT_SLACK
    for k in ("counts", "bytes_alg", "bytes_wire"):
        assert got["collectives"][k] == want["collectives"][k], k
    assert got["collectives"]["total_wire_bytes"] == want["collectives"]["total_wire_bytes"]
    flops = got["cost"]["flops_per_device"] / (
        want["cost"]["xla_flops_per_device"] * want["solver_max_outer"])
    assert FLOP_RATIO[0] <= flops <= FLOP_RATIO[1], flops
    hbm = got["cost"]["hbm_bytes_per_device"] / want["cost"]["hbm_bytes_per_device"]
    assert HBM_RATIO[0] <= hbm <= HBM_RATIO[1], hbm
    mem = got["memory"]
    assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
        + mem["temp_bytes"] - mem["alias_bytes"]
