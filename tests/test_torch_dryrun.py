"""The port's program accounting (``launch/hlo_analysis.py``) and dry run
(``launch/dryrun.py``) against the JAX package's.

* ``_wire_factor`` equals JAX's for every collective kind at group sizes
  1, 2, 4, 16 and 256, and ``ProgramStats.as_dict`` / ``CollectiveStats.
  as_dict`` have JAX's keys.
* ``count_program`` gives 2·m·n·k exactly on a matmul chain, and the
  collectives of a dry mesh in JAX's convention (result bytes: an
  all-gather's g times its input, a reduce-scatter's 1/g).
* A reduced train step counted on ``meta`` equals the same step counted on
  the CPU exactly (FLOPs, HBM bytes, peak live bytes), and so does the
  prefill of attention-free mamba2; qwen2's prefill FLOPs do once each
  layer's plain attention (which the CPU runs) is swapped for the flash
  kernel's reported work (which ``meta`` reports).  Its HBM bytes are not
  held: the plain attention's output is a strided view, the kernel's a
  dense tensor, and the ops after it copy one and not the other.
* The FLOPs of reduced qwen2-1.5b and mamba2-130m training steps (2 × 128)
  on a (1, 1) mesh are within 10% of JAX's ``program_stats`` of the
  compiled step (the port recomputes each loss chunk's LM-head matmul in
  the backward, which the compiled step computes once).
* For every arch at every runnable shape, on 16×16 and 2×16×16, a rank's
  ``argument_bytes`` equal the shard bytes of JAX's ``train_state_specs``
  / ``param_specs`` / ``input_specs`` leaves on an ``AbstractMesh``
  (spec arithmetic: no compile and no dry pass).
* ``lower_cell`` completes on every reduced arch × the four shape kinds
  on a small dry layout, and on one full-width cell at 16×16; the record
  has every key ``benchmarks/roofline.py:analyze_record`` reads, and the
  skips are ``cell_is_runnable``'s; ``--solver`` raises naming item 16c.
"""
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ALL_SHAPES as J_ALL_SHAPES
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.configs.registry import cell_is_runnable as j_runnable
from repro.launch import hlo_analysis as jhlo
from repro.models import Model as JModel
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as jcosine
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import ARCHS, get_arch, get_shape
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import dry_rank, make_model_mesh, make_production_mesh
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, cosine_schedule

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def test_wire_factor_matches_jax():
    assert hlo_analysis.COLLECTIVES == jhlo.COLLECTIVES
    for op in KINDS:
        for g in (1, 2, 4, 16, 256):
            assert hlo_analysis._wire_factor(op, g) == jhlo._wire_factor(op, g)


def test_stats_dict_keys_match_jax():
    assert hlo_analysis.ProgramStats().as_dict().keys() == jhlo.ProgramStats().as_dict().keys()
    args = ({"all-reduce": 1.0}, {"all-reduce": 2.0}, {"all-reduce": 3.0})
    assert hlo_analysis.CollectiveStats(*args).as_dict() == jhlo.CollectiveStats(*args).as_dict()


def test_count_program_matmul_chain_and_collectives():
    a, b, c = torch.randn(8, 16), torch.randn(16, 32), torch.randn(32, 4)
    st = hlo_analysis.count_program(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert st.flops == st.flops_unscaled == 2 * 8 * 16 * 32 + 2 * 8 * 32 * 4
    assert st.loop_trip_max == 1.0
    assert st.hbm_bytes == 4 * (8 * 16 + 16 * 32 + 8 * 32) + 4 * (8 * 32 + 32 * 4 + 8 * 4)

    from repro_torch.models import collectives as col

    mesh = dry_rank(make_model_mesh((2, 4), ("data", "model")), (1, 2))
    x = torch.empty((8, 6), device="meta")

    def step(x):
        y = col.all_gather(x, mesh, "model", dim=0)            # [32, 6]
        return col.reduce_scatter(y, mesh, "data", dim=0), col.all_reduce(x, mesh, "model")

    st = hlo_analysis.count_program(step, x, mesh=mesh)
    nb = 8 * 6 * 4
    assert st.coll_bytes_alg == {"all-gather": 4 * nb, "reduce-scatter": 2 * nb,
                                 "all-reduce": nb}
    assert st.coll_bytes_wire["all-gather"] == 4 * nb * 3 / 4
    assert st.coll_bytes_wire["reduce-scatter"] == 2 * nb * 1
    assert st.coll_counts == {"all-gather": 1, "reduce-scatter": 1, "all-reduce": 1}
    assert mesh.moved_bytes == {"all_gather": nb, "reduce_scatter": 4 * nb, "all_reduce": nb}


def _step(arch, dev, B=2, S=64):
    m = Model(reduced(get_arch(arch)), device=dev)
    opt = AdamW(cosine_schedule(3e-4, 100, 10_000))
    state = m.train_state_of(m.empty_params(), opt)
    batch = {k: torch.zeros((B, S), dtype=torch.int32, device=dev)
             for k in ("inputs", "labels")}
    return m, m.make_train_step(opt)[0], state, batch


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_meta_counts_equal_cpu(arch):
    got = {}
    for dev in ("cpu", "meta"):
        m, step, state, batch = _step(arch, dev)
        tr = hlo_analysis.trace_program(step, state, batch)
        pre = hlo_analysis.count_program(m.make_prefill(), state.params, batch["inputs"])
        got[dev] = (tr.stats.flops, tr.stats.hbm_bytes, tr.temp_bytes, pre.flops, pre.hbm_bytes)
    cpu, meta = got["cpu"], got["meta"]
    assert cpu[:3] == meta[:3]
    cfg = reduced(get_arch(arch))
    if not cfg.has_attention:
        assert cpu[3:] == meta[3:]
        return
    # the prefill's attention: the plain version on the CPU, the kernel's
    # reported work on meta, at the layer's shapes (q [B, S, N, P, H])
    from repro_torch.kernels.flash_attention import ops as flash_ops

    plan = Model(cfg, device="cpu").plan.attn
    shapes = ((2, 64, plan.slots, plan.q_per_slot, plan.head_dim),
              (2, 64, plan.slots, plan.head_dim), (2, 64, plan.slots, plan.head_dim))
    per = {dev: hlo_analysis.count_program(
        lambda q, k, v: flash_ops.flash_attention(q, k, v, window=cfg.attn_window),
        *(torch.zeros(s, dtype=torch.bfloat16, device=dev) for s in shapes))
        for dev in ("cpu", "meta")}
    L = cfg.num_layers
    assert meta[3] == cpu[3] - L * per["cpu"].flops + L * per["meta"].flops
    # the band: causal, 64 · 65 / 2 pairs a q row, 4·H operations a pair
    rows = 2 * plan.slots * plan.q_per_slot
    assert per["meta"].flops == 4 * plan.head_dim * rows * (64 * 65 // 2)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-130m"])
def test_train_flops_near_jax(arch):
    from repro.core.compat import make_mesh_compat

    cfg = JModelConfig(**{k: getattr(reduced(get_arch(arch)), k)
                          for k in reduced(get_arch(arch)).__dataclass_fields__})
    jm = JModel(cfg, mesh=make_mesh_compat((1, 1), ("data", "model")))
    opt = JAdamW(jcosine(3e-4, 100, 10_000))
    step, _ = jm.make_train_step(opt)
    state = jax.eval_shape(lambda k: jm.init_train_state(k, opt), jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct((2, 128), jnp.int32) for k in ("inputs", "labels")}
    text = jax.jit(step).lower(state, batch).compile().as_text()
    want = jhlo.program_stats(text, default_group=1).flops
    mesh = make_model_mesh((1, 1), ("data", "model"), device="cpu")
    m = Model(reduced(get_arch(arch)), mesh=mesh)
    topt = AdamW(cosine_schedule(3e-4, 100, 10_000))
    tstate = m.train_state_of(m.empty_params(), topt)
    tbatch = {k: torch.zeros((2, 128), dtype=torch.int32) for k in ("inputs", "labels")}
    got = hlo_analysis.count_program(m.make_train_step(topt)[0], tstate, tbatch, mesh=mesh).flops
    assert abs(got / want - 1) <= 0.10, (got, want)


# ---------------------------------------------------------------------------
# argument_bytes against JAX's spec arithmetic
# ---------------------------------------------------------------------------


def _shard_bytes(struct, spec, mesh) -> int:
    """The bytes of one rank's block of a leaf under ``spec``."""
    n = 1
    for d, size in enumerate(struct.shape):
        axes = spec[d] if d < len(spec) else None
        axes = () if axes is None else ((axes,) if isinstance(axes, str) else tuple(axes))
        k = math.prod(mesh.shape[a] for a in axes)
        assert size % k == 0
        n *= size // k
    return n * np.dtype(struct.dtype).itemsize


def _tree_bytes(structs, specs, mesh) -> int:
    leaves = jax.tree.leaves(jax.tree.map(
        lambda s, p: _shard_bytes(s, p, mesh), structs, specs,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct)))
    return int(sum(leaves))


def _jax_argument_bytes(arch, shape, mesh, cache):
    cfg = J_ARCHS[arch]
    jm = JModel(cfg, mesh=mesh)
    ispecs = jm.input_specs(shape)
    if shape.kind == "train":
        key = (arch, "state")
        if key not in cache:
            opt = JAdamW(jcosine(3e-4, 100, 10_000), moment_dtype=dryrun._moment_dtype(cfg))
            cache[key] = (jax.eval_shape(lambda k: jm.init_train_state(k, opt),
                                         jax.random.PRNGKey(0)), opt)
        state, opt = cache[key]
        total = _tree_bytes(state, jm.train_state_specs(opt), mesh)
        return total + sum(_shard_bytes(*ispecs[k], mesh) for k in ("inputs", "labels"))
    key = (arch, "params")
    if key not in cache:
        cache[key] = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    total = _tree_bytes(cache[key], jm.param_specs(), mesh) + _shard_bytes(*ispecs["inputs"],
                                                                          mesh)
    if shape.kind == "decode":
        total += _tree_bytes(*ispecs["cache"], mesh) + _shard_bytes(*ispecs["cache_len"], mesh)
    return total


def test_argument_bytes_match_jax_specs():
    """Every runnable (arch, shape) cell on both production meshes."""
    with jax.enable_x64(False):   # as JAX's dry run runs
        _argument_bytes_match()


def _argument_bytes_match():
    cache, cells = {}, 0
    for multi in (False, True):
        shape_, axes = ((2, 16, 16), ("pod", "data", "model")) if multi else \
            ((16, 16), ("data", "model"))
        jmesh = AbstractMesh(shape_, axes)
        for arch in ARCHS:
            for shape in J_ALL_SHAPES:
                if not j_runnable(J_ARCHS[arch], shape)[0]:
                    continue
                model = Model(get_arch(arch), mesh=dry_rank(make_production_mesh(
                    multi_pod=multi)))
                _, args, _ = dryrun.build_cell(model, get_shape(shape.name))
                got = dryrun._nbytes(args) + (4 if shape.kind == "decode" else 0)
                assert got == _jax_argument_bytes(arch, shape, jmesh, cache), \
                    (arch, shape.name, multi)
                cells += 1
    assert cells == 64


# ---------------------------------------------------------------------------
# lower_cell and the CLI
# ---------------------------------------------------------------------------

SMALL = {"train_4k": ShapeConfig("train_4k", 128, 8, "train"),
         "prefill_32k": ShapeConfig("prefill_32k", 256, 4, "prefill"),
         "decode_32k": ShapeConfig("decode_32k", 256, 4, "decode"),
         "long_500k": ShapeConfig("long_500k", 512, 1, "decode")}
ROOFLINE_KEYS = {("cost", "flops_per_device"), ("cost", "hbm_bytes_per_device"),
                 ("collectives", "total_wire_bytes"), ("memory", "peak_estimate_bytes"),
                 ("shape",), ("model_active_params",), ("compile_s",), ("arch",), ("mesh",),
                 ("kind",)}


def _has(rec, path):
    for k in path:
        if k not in rec:
            return False
        rec = rec[k]
    return True


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_lower_cell_reduced(arch, monkeypatch):
    """Every reduced arch × the four shape kinds on a dry (2, 2) layout."""
    from repro_torch.configs.registry import cell_is_runnable

    monkeypatch.setattr(dryrun, "get_arch", lambda a: reduced(get_arch(a)))
    monkeypatch.setattr(dryrun, "get_shape", lambda s: SMALL[s])
    done = 0
    for s in SMALL:
        if not cell_is_runnable(reduced(get_arch(arch)), SMALL[s])[0]:
            continue
        mesh = dry_rank(make_model_mesh((2, 2), ("data", "model")))
        rec = dryrun.lower_cell(arch, s, False, mesh=mesh)
        assert rec["mesh"] == "2x2" and rec["kind"] == SMALL[s].kind
        assert all(_has(rec, p) for p in ROOFLINE_KEYS)
        assert rec["cost"]["flops_per_device"] > 0 and rec["collectives"]["total_wire_bytes"] > 0
        mem = rec["memory"]
        assert mem["peak_estimate_bytes"] == mem["argument_bytes"] + mem["output_bytes"] \
            + mem["temp_bytes"] - mem["alias_bytes"]
        assert (mem["alias_bytes"] > 0) == (SMALL[s].kind != "prefill")
        done += 1
    assert done == (4 if reduced(get_arch(arch)).supports_long_context else 3)


def test_full_width_cell_and_roofline():
    from benchmarks.roofline import analyze_record

    rec = dryrun.lower_cell("qwen2-1.5b", "prefill_32k", False)
    assert rec["mesh"] == "16x16" and not any(k.startswith("xla") for k in rec["cost"])
    row = analyze_record(rec)
    assert row["arch"] == "qwen2-1.5b" and row["compute_s"] > 0 and row["collective_s"] > 0
    # every weight split over data is gathered (FSDP), the logits gathered over model
    assert rec["collectives"]["counts"]["all-gather"] > 0


def test_cli_skips_and_solver(monkeypatch, tmp_path):
    out = tmp_path / "dry.json"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--solver", "--out", str(out)])
    with pytest.raises(ValueError, match="item 16c"):
        dryrun.main()
    # a skipped cell is JAX's, word for word
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen2-1.5b", "--shape", "long_500k",
                                      "--mesh", "single", "--out", str(out)])
    dryrun.main()
    import json

    rec = json.loads(out.read_text())
    assert rec == [{"arch": "qwen2-1.5b", "shape": "long_500k", "mesh": "16x16",
                    "skipped": True,
                    "reason": j_runnable(J_ARCHS["qwen2-1.5b"], J_ALL_SHAPES[3])[1]}]
