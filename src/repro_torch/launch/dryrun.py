"""Multi-pod dry run: every (arch × shape × mesh) cell, counted on one rank
of the production mesh (port of ``launch/dryrun.py``).

For each cell, rank 0 of ``make_production_mesh()`` (16×16, or 2×16×16
with ``--mesh multi``) builds its model on ``meta`` (``launch.mesh.
dry_rank``: no storage, no draw, no process group) with the default
``ParallelConfig()`` (FSDP over ``data``, TP / EP over ``model``) and runs
the step the shape implies once through ``hlo_analysis.trace_program``:
``make_train_step`` with AdamW and JAX's microbatch and accumulation
policy for ``train_*``, ``make_prefill`` for ``prefill_*``, and
``make_decode_step`` over this rank's decode cache for ``decode_32k`` /
``long_500k``.  The record has JAX's keys, so
``benchmarks/roofline.py:analyze_record`` reads it unchanged:

* ``lower_s`` is the build of the rank's model, state and inputs on
  ``meta``, and ``compile_s`` the dry pass's wall: no XLA runs here, so
  the ``xla_*`` cost keys are left out;
* ``memory`` comes from the same per-rank blocks: ``argument_bytes`` the
  rank's state (or parameters and cache) plus its inputs,
  ``output_bytes`` what the step returns, ``alias_bytes`` the donated
  state (JAX's ``donate_argnums``: the training state, a decode step's
  cache), ``temp_bytes`` the dry pass's peak of live storage beyond the
  arguments, and ``peak_estimate_bytes`` JAX's formula, argument + output +
  temp − alias.  The peak holds the step's outputs where it falls at the
  end of the pass (a prefill's cache and logits), which the formula adds
  again; an allocator's caching and fragmentation are not in it;
* ``cost`` and ``collectives`` are ``trace_program``'s counts of the rank's
  program (FLOPs, HBM bytes, collective result and wire bytes); a dry
  prefill counts the flash kernel's band FLOPs (causal and window
  skipping), where JAX's prefill counts its plain blocked attention.

Skips are ``cell_is_runnable``'s.

``--solver`` (and ``--solver-only``) add the paper's own cell,
``lower_solver_cell``: the 1-D shard runtime's convdiff solve at n = 1024
under PFAIT with the non-blocking reduction, on rank 0 of 256 or 512
shards (``launch.mesh.dry_shard_group``).  Its sweeps report kernel #1's
work and its contribution #5's from their ``meta`` paths, and its
transport counts each halo shift as a ``collective-permute`` and each
reduction as an ``all-reduce``.  The loop cannot read ``converged`` on
``meta``, so the solve is counted at ``max_outer`` 1 and 2: the
difference is one outer iteration, scaled by ``max_outer`` as JAX's loop
multiplier scales the while body.  The result is the rank's block and
the monitor's scalars, as JAX's program returns the sharded state, so no
all-gather is counted.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single        # 16×16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both          # and 2×16×16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --solver-only --mesh both
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ALL_SHAPES, ParallelConfig
from repro_torch.configs.registry import ARCHS, cell_is_runnable, get_arch, get_shape
from repro_torch.core import detection
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import dry_rank, dry_shard_group, make_production_mesh, spec_slices
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.api import RuntimeConfig
from repro_torch.runtime.shard_runtime import make_runtime
from repro_torch.solvers.convdiff import Stencil

SOLVER_MAX_OUTER = 20_000


def _moment_dtype(cfg) -> Optional[str]:
    # bf16 moments for models above 100e9 parameters, f32 below
    return "bfloat16" if cfg.num_params() > 100e9 else "float32"


def _microbatch_policy(cfg, shape, mesh) -> int:
    """Grad-accumulation depth: keep the remat activation carry
    (scan_steps × B_loc/m × S × D × 2 bytes) under ~2 GiB/device."""
    ndev_dp = math.prod(v for k, v in mesh.shape.items() if k != "model")
    b_loc = max(shape.global_batch // ndev_dp, 1)
    steps = cfg.num_layers // (cfg.moe_layer_period if cfg.is_moe else 1)
    target = 2 * 2**30
    m = 1
    while m < b_loc and steps * (b_loc // m) * shape.seq_len * cfg.d_model * 2 > target:
        m *= 2
    return m


def _nbytes(tree) -> int:
    """The bytes of every tensor in ``tree``, each storage once."""
    return sum(hlo_analysis.storages(tree).values())


def _local(struct, spec, mesh) -> torch.Tensor:
    """This rank's block of a ``((shape, dtype), spec)`` input, on ``meta``."""
    shape, dtype = struct
    block = spec_slices(spec, shape, mesh)
    return torch.zeros(tuple(len(range(*s.indices(n))) for s, n in zip(block, shape)),
                       dtype=dtype, device="meta")


def build_cell(model: Model, shape, microbatch_override: Optional[int] = None):
    """``(fn, args, donated)``: the step ``shape`` implies on the model's
    rank, its arguments (this rank's blocks, on the model's device) and
    the donated argument (the training state, a decode cache, or None)."""
    cfg, mesh = model.cfg, model.mesh
    ispecs = model.input_specs(shape)
    if shape.kind == "train":
        opt = AdamW(cosine_schedule(3e-4, 100, 10_000), moment_dtype=_moment_dtype(cfg))
        micro = microbatch_override or _microbatch_policy(cfg, shape, mesh)
        accum = "bfloat16" if cfg.num_params() > 100e9 else None
        step_fn, _ = model.make_train_step(opt, microbatches=micro, accum_dtype=accum)
        state = model.train_state_of(model.empty_params(), opt)
        batch = {k: _local(*ispecs[k], mesh) for k in ("inputs", "labels")}
        return step_fn, (state, batch), state
    params = model.empty_params()
    inputs = _local(*ispecs["inputs"], mesh)
    if shape.kind == "prefill":
        return model.make_prefill(), (params, inputs), None
    ring = shape.name == "long_500k" and cfg.attn_window > 0
    cache = model.cache_struct(inputs.shape[0], shape.seq_len, ring=ring)
    return (model.make_decode_step(ring=ring), (params, cache, inputs, shape.seq_len - 1),
            cache)


def lower_cell(arch_name: str, shape_name: str, multi_pod: bool,
               parallel: Optional[ParallelConfig] = None,
               capacity_factor: float = 1.0,
               microbatch_override: Optional[int] = None,
               variant: str = "baseline", mesh=None) -> Dict[str, Any]:
    """One cell's record.  ``mesh`` (default rank 0 of the production mesh)
    is a dry rank of any layout (``launch.mesh.dry_rank``)."""
    mesh = mesh if mesh is not None else dry_rank(make_production_mesh(multi_pod=multi_pod))
    cfg = get_arch(arch_name)
    shape = get_shape(shape_name)
    parallel = parallel or ParallelConfig()
    t0 = time.time()
    model = Model(cfg, mesh=mesh, parallel=parallel, capacity_factor=capacity_factor)
    fn, args, donated = build_cell(model, shape, microbatch_override)
    t_lower = time.time() - t0
    t0 = time.time()
    traced = hlo_analysis.trace_program(fn, *args, mesh=mesh)
    t_compile = time.time() - t0

    st = traced.stats
    arg = _nbytes(args) + (4 if shape.kind == "decode" else 0)   # cache_len, an i32
    out = _nbytes(traced.out)
    alias = _nbytes(donated)
    coll = hlo_analysis.CollectiveStats(counts=dict(st.coll_counts),
                                        bytes_alg=dict(st.coll_bytes_alg),
                                        bytes_wire=dict(st.coll_bytes_wire))
    return {
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.devices_shape),
        "variant": variant,
        "kind": shape.kind,
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(out),
            "temp_bytes": int(traced.temp_bytes),
            "alias_bytes": int(alias),
            "peak_estimate_bytes": int(arg + out + traced.temp_bytes - alias),
        },
        "cost": {
            "flops_per_device": float(st.flops),
            "hbm_bytes_per_device": float(st.hbm_bytes),
        },
        "collectives": coll.as_dict(),
        "model_params": int(cfg.num_params()),
        "model_active_params": int(cfg.num_active_params()),
    }


def solver_cell(p, n: int = 1024, mode: str = "pfait",
                max_outer: int = SOLVER_MAX_OUTER, device=None):
    """The paper's solve, JAX's ``lower_solver_cell`` configuration, built
    through ``make_runtime``: ``run(x0, b)`` over ``p`` (a shard count,
    stacked on ``device``, or a ``ShardGroup``, such as a dry one)."""
    st = Stencil.for_contraction(n, 1.0, (1.0, 1.0, 1.0), rho=0.95)
    mon = detection.for_mode(mode, eps_tilde=1e-4, margin=10.0, staleness=4)
    rcfg = RuntimeConfig(monitor=mon, reduction="nonblocking", inner_sweeps=4,
                         max_outer=max_outer)
    return make_runtime("convdiff", rcfg.to_shard_config(), p, n, stencil=st, device=device)


def _scaled(one: float, two: float, outer: int) -> float:
    """A count at ``outer`` outer iterations from the counts at 1 and 2:
    the work before the loop (and after it) once, and the difference, one
    iteration, ``outer`` times."""
    return one + (outer - 1) * (two - one)


def lower_solver_cell(multi_pod: bool, n: int = 1024, mode: str = "pfait") -> Dict[str, Any]:
    """The paper's own workload: the 1-D shard runtime's convdiff solve on
    shard 0 of 256 (16×16) or 512 (2×16×16) shards, on ``meta``;
    the record has JAX's keys (no ``xla_*`` ones) and is counted at
    ``max_outer`` 1 and 2 and scaled to ``SOLVER_MAX_OUTER``."""
    p = 512 if multi_pod else 256
    t0 = time.time()
    cells = []
    for outer in (1, 2):
        group = dry_shard_group(p)
        run = solver_cell(group, n, mode, outer)
        x0 = torch.zeros((n // p, n, n), dtype=torch.float32, device="meta")
        cells.append((group, run, (x0, torch.zeros_like(x0))))
    t_lower = time.time() - t0
    t0 = time.time()
    traced = [hlo_analysis.trace_program(run, *args, mesh=group)
              for group, run, args in cells]
    t_compile = time.time() - t0

    one, two = (t.stats for t in traced)
    coll = hlo_analysis.CollectiveStats(
        **{name: {k: _scaled(getattr(one, attr).get(k, 0.0), v, SOLVER_MAX_OUTER)
                  for k, v in getattr(two, attr).items()}
           for name, attr in (("counts", "coll_counts"), ("bytes_alg", "coll_bytes_alg"),
                              ("bytes_wire", "coll_bytes_wire"))})
    arg = _nbytes(cells[1][2])
    out = _nbytes(traced[1].out)
    temp = max(t.temp_bytes for t in traced)
    return {
        "arch": f"convdiff-n{n}-{mode}",
        "solver_max_outer": SOLVER_MAX_OUTER,
        "shape": "solver",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "shards": p,
        "kind": "solver",
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(out),
            "temp_bytes": int(temp),
            "alias_bytes": 0,
            "peak_estimate_bytes": int(arg + out + temp),
        },
        "cost": {
            "flops_per_device": _scaled(one.flops, two.flops, SOLVER_MAX_OUTER),
            "hbm_bytes_per_device": _scaled(one.hbm_bytes, two.hbm_bytes, SOLVER_MAX_OUTER),
        },
        "collectives": coll.as_dict(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--solver", action="store_true", help="also run the PDE solver cell")
    ap.add_argument("--solver-only", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--append", action="store_true")
    args = ap.parse_args()

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = [s.name for s in ALL_SHAPES] if args.shape == "all" else args.shape.split(",")

    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in records}

    t_start = time.time()
    for multi in meshes:
        mesh_name = "2x16x16" if multi else "16x16"
        for a in archs if not args.solver_only else ():
            for s in shapes:
                ok, why = cell_is_runnable(get_arch(a), get_shape(s))
                key = (a, s, mesh_name)
                if key in done:
                    continue
                if not ok:
                    records.append({"arch": a, "shape": s, "mesh": mesh_name,
                                    "skipped": True, "reason": why})
                    print(f"[skip] {a} × {s} × {mesh_name}: {why}", flush=True)
                    continue
                try:
                    rec = lower_cell(a, s, multi)
                    records.append(rec)
                    print(
                        f"[ok]   {a} × {s} × {mesh_name}: "
                        f"dry pass {rec['compile_s']}s, "
                        f"{rec['cost']['flops_per_device']/1e9:.1f} GFLOP/dev, "
                        f"peak {rec['memory']['peak_estimate_bytes']/2**30:.2f} GiB/dev, "
                        f"wire {rec['collectives']['total_wire_bytes']/2**20:.1f} MiB/dev",
                        flush=True,
                    )
                except Exception as e:  # noqa: BLE001 — recorded, the run fails at its end
                    records.append({"arch": a, "shape": s, "mesh": mesh_name,
                                    "error": f"{type(e).__name__}: {e}"})
                    print(f"[FAIL] {a} × {s} × {mesh_name}: {e}", flush=True)
                    traceback.print_exc()
                _save(records, args.out)
        if args.solver or args.solver_only:
            try:
                rec = lower_solver_cell(multi)
                records.append(rec)
                print(f"[ok]   solver × {mesh_name}: dry pass {rec['compile_s']}s", flush=True)
            except Exception as e:  # noqa: BLE001 — recorded, the run fails at its end
                records.append({"arch": "convdiff", "shape": "solver", "mesh": mesh_name,
                                "error": f"{type(e).__name__}: {e}"})
                print(f"[FAIL] solver × {mesh_name}: {e}", flush=True)
                traceback.print_exc()
            _save(records, args.out)

    n_ok = sum(1 for r in records if "error" not in r and not r.get("skipped"))
    n_fail = sum(1 for r in records if "error" in r)
    n_skip = sum(1 for r in records if r.get("skipped"))
    print(f"\ndry-run complete in {time.time()-t_start:.0f}s: "
          f"{n_ok} ok, {n_fail} failed, {n_skip} skipped (documented N/A)")
    _save(records, args.out)
    if n_fail:
        raise SystemExit(1)


def _save(records, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(records, f, indent=1)


if __name__ == "__main__":
    main()
