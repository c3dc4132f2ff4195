"""Per-rank jobs of local worlds: shard runs, one shard per rank.

``run_cases`` is the job ``launch.mesh.spawn_world`` runs on every rank:
it joins the world as a ``ShardGroup`` and runs a list of ``Case``s — shard
runtimes (``make_runtime``), ``runtime.api.run_shard``,
``solvers.fixed_point.make_sharded_solver`` and ``runtime.api.run_train``
— over the process-group transport.  Solver inputs are made on each rank
from seed 0 (``Inputs``), so no array crosses a process boundary on the way
in; a training set is drawn once by the parent and saved
(``save_train_inputs``), and each rank maps the files and reads its own
rows.  Each rank places only its own block.  It returns host values only:
per case the iterations, the
detection, the trace, a digest of ``x`` (and ``x`` itself from rank 0),
the wall time of the timed run, and over the case's ``runs`` runs (``api``
runs twice: build and timed) the kernel launches made, the stencil
launches by block shape and dtype (``jacobi3d.LAUNCH_SHAPES``) and the bytes the
gloo transport staged through host memory.

    from repro_torch.launch.mesh import spawn_world
    from repro_torch.launch.worlds import Case, Inputs, run_cases
    out = spawn_world(run_cases, 4, "/tmp/world",
                      args=("gloo", [Case("m", "runtime", cfg, (2, 2),
                                          Inputs("convdiff", 8))], "cpu"))
"""
from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.jacobi3d import jacobi3d as jk
from repro_torch.kernels.residual_norm import residual_norm as rk
from repro_torch.launch.mesh import make_shard_group


class Inputs(NamedTuple):
    """A problem made from seed 0: ``convdiff`` (``Stencil.for_contraction``
    at ``rho`` and ``make_rhs``, x0 = 0) or ``pagerank``
    (``PageRankProblem(n, p)``'s dense operator, x0 = 1/n)."""

    family: str
    n: int
    rho: float = 0.9
    p: int = 4


def make_inputs(spec: Inputs) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
    """``(x0, arg, extra)``: host arrays and the runtime's keyword arguments
    (``stencil`` or ``damping``)."""
    if spec.family == "convdiff":
        from repro_torch.solvers.convdiff import Stencil, make_rhs

        st = Stencil.for_contraction(spec.n, 1.0, (1.0, 1.0, 1.0), rho=spec.rho)
        b = make_rhs(spec.n, seed=0)
        return np.zeros_like(b), b, dict(stencil=st)
    if spec.family == "pagerank":
        from repro_torch.solvers.pagerank import PageRankProblem

        prob = PageRankProblem(n=spec.n, p=spec.p, seed=0)
        return np.full(spec.n, 1.0 / spec.n), prob.to_dense(), dict(damping=prob.d)
    raise KeyError(f"family {spec.family!r} not in ('convdiff', 'pagerank')")


class TrainInputs(NamedTuple):
    """An ``MLFixedPointProblem``'s training set, saved as ``<path>.A.npy``
    and ``<path>.y.npy`` (``save_train_inputs``), with the fields the
    training runtime reads; it stands in for the problem on a rank."""

    path: str
    m: int
    n: int
    task: str
    l2: float


def save_train_inputs(problem, path: str) -> TrainInputs:
    """Save ``problem``'s design and targets for the ranks of a world."""
    np.save(path + ".A.npy", problem.A)
    np.save(path + ".y.npy", problem.y)
    return TrainInputs(path, problem.m, problem.n, problem.task, problem.l2)


@dataclass(frozen=True)
class Case:
    """One run: ``kind`` is ``runtime`` (``make_runtime`` with a
    ``ShardRuntimeConfig``), ``api`` (``run_shard`` with a
    ``RuntimeConfig``), ``solver`` (``make_sharded_solver`` with a
    ``SolverConfig``; the inputs' stencil is the config's) or ``train``
    (``run_train`` with a ``RuntimeConfig`` on ``TrainInputs``, from zero
    replicas)."""

    name: str
    kind: str
    cfg: Any
    shape: Tuple[int, ...]
    inputs: Any


def _launches() -> Dict[str, int]:
    return {**jk.LAUNCHES, **rk.LAUNCHES}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _digest(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def _warm(dev: torch.device) -> None:
    """Load every kernel library the cases may launch (a stacked run of
    each runtime at n = 8), so no case's wall holds a library load."""
    from repro_torch.core import detection
    from repro_torch.runtime import shard_runtime as sr

    x0, b, kw = make_inputs(Inputs("convdiff", 8))
    mon = detection.MonitorConfig(mode="pfait", eps=0.0, staleness=0)
    for p, sweep in ((1, "jacobi"), (1, "hybrid"), ((1, 1), "jacobi"), ((1, 1), "hybrid")):
        cfg = sr.ShardRuntimeConfig(monitor=mon, sweep=sweep, max_outer=2)
        sr.make_convdiff_runtime(cfg, p, kw["stencil"], 8, device=dev)(x0, b)
    _sync(dev)


def _run(case: Case, group, made) -> Tuple[Any, float]:
    """The case's result (a ``ShardRunResult`` or ``SolveResult``) and the
    wall seconds of its timed run."""
    from repro_torch.runtime import api
    from repro_torch.runtime.shard_runtime import make_runtime
    from repro_torch.solvers.fixed_point import make_sharded_solver

    if case.kind == "train":
        data = case.inputs
        rows = data.m // group.p
        sl = slice(group.rank * rows, (group.rank + 1) * rows)
        A = np.array(np.load(data.path + ".A.npy", mmap_mode="r")[sl])
        y = np.array(np.load(data.path + ".y.npy", mmap_mode="r")[sl])
        rep = api.run_train(data, case.cfg, group, np.zeros((1, data.n)), A, y)
        return rep.raw, dict(rep.wall_segments)["run"]
    x0, arg, kw = made
    n = case.inputs.n
    if case.kind == "api":
        rep = api.run_shard(case.inputs.family, case.cfg, group, n, x0, arg, **kw)
        return rep.raw, dict(rep.wall_segments)["run"]
    if case.kind == "runtime":
        run = make_runtime(case.inputs.family, case.cfg, group, n, **kw)
    elif case.kind == "solver":
        run = make_sharded_solver(case.cfg, group)
    else:
        raise ValueError(f"case kind {case.kind!r} not in ('runtime', 'api', 'solver', "
                         "'train')")
    dist.barrier()
    _sync(group.device)
    t0 = time.perf_counter()
    out = run(x0, arg)
    _sync(group.device)
    return out, time.perf_counter() - t0


def run_cases(rank: int, k: int, store, backend: str, cases: Sequence[Case],
              device: Optional[str] = None) -> Dict[str, Any]:
    """The job of one rank: run ``cases`` in order over a ``backend`` world
    of ``k`` ranks (``device`` as ``make_shard_group`` takes it), and report
    each case's outcome and the rank's launch and staging counts."""
    made: Dict[Inputs, tuple] = {}
    results: List[Dict[str, Any]] = []
    warmed = False
    for case in cases:
        group = make_shard_group(case.shape, backend, store=store, rank=rank,
                                 device=device)
        if not warmed and group.device.type == "cuda":
            _warm(group.device)
        warmed = True
        if case.kind != "train" and case.inputs not in made:
            made[case.inputs] = make_inputs(case.inputs)
        before, shapes = _launches(), jk.LAUNCH_SHAPES.copy()
        r, wall = _run(case, group, made.get(case.inputs))
        trace = getattr(r, "trace", None)
        results.append(dict(
            name=case.name, rank=rank,
            outer_iters=int(getattr(r, "outer_iters", getattr(r, "rounds", 0))),
            converged=bool(r.converged), residual=float(r.residual),
            verifications=int(getattr(r, "verifications", 0)),
            trace=None if trace is None else trace.cpu().numpy(),
            x_digest=_digest(r.x), x=r.x.cpu().numpy() if rank == 0 else None,
            wall_s=wall, runs=2 if case.kind in ("api", "train") else 1,
            # a fresh group per case: its counters are this case's
            staged_bytes=group.staged_bytes, staged_s=group.staged_s,
            wait_s=group.wait_s,
            launches={key: v - before[key] for key, v in _launches().items()},
            launch_shapes=dict(jk.LAUNCH_SHAPES - shapes)))
    return dict(rank=rank, backend=backend, cases=results)
