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

Skips are ``cell_is_runnable``'s.  The paper's solver cell (JAX's
``--solver``, ``lower_solver_cell``) needs a dry path through the stencil
kernels' dispatchers and a dry outer iteration of the shard runtime: it is
ROADMAP Queue 1 item 16c, and ``--solver`` / ``--solver-only`` raise.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single        # 16×16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both          # and 2×16×16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
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
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import dry_rank, make_production_mesh, spec_slices
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, cosine_schedule

SOLVER_DEFERRED = ("the solver cell (lower_solver_cell) is not ported: it needs a dry path "
                   "through the stencil kernels' dispatchers and a dry outer iteration of the "
                   "shard runtime (ROADMAP Queue 1 item 16c)")


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
    if args.solver or args.solver_only:
        raise ValueError(SOLVER_DEFERRED)

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
        for a in archs:
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
