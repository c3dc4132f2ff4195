"""The port's parallel layout against the JAX package's, with no process
group: the plans, the partition specs of every parameter, cache leaf,
training-state leaf and step input, the meshes, and the MoE router's
capacity packing.

* Specs: for every arch of ``ARCHS`` at tp ∈ {1, 2, 4, 16}, with FSDP on
  and off, on the single-pod (16, tp) and two-pod (2, 16, tp) meshes, the
  JAX ``Model`` on a ``jax.sharding.AbstractMesh`` and the port's on a
  ``make_model_mesh`` description: every parameter's spec equal to its
  JAX leaf's (``tree_path`` maps a name to the leaf; JAX's layer leaves
  carry the stacked axis first), the cache, training-state, batch and
  input specs (shapes and dtypes too) equal; the plans (attention slots
  and kv replicas, ``MoEPlan`` with its capacity, ``vocab_padded``) equal.
* Meshes: ``make_production_mesh`` and ``make_host_mesh`` give JAX's axis
  names and shapes (JAX's production meshes in a subprocess with 512
  forced host devices), and ``dp_axes_of`` JAX's axes.
* ``_route_and_pack`` / ``_unpack_combine`` against JAX's on the same
  f32 tokens and router, at a capacity that drops entries, direct and with
  virtual experts (E < tp): the send buffers bitwise, slots and positions
  equal, weights (probabilities, at most 1) within 2^-21 and the aux loss
  within 2^-21 relative (4 f32 units: two softmax evaluations in another
  order), the combined outputs within 1e-6.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import ALL_SHAPES as J_ALL_SHAPES
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.registry import ARCHS as J_ARCHS
from repro.launch import mesh as jmesh
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro_torch.configs.base import ALL_SHAPES, ModelConfig, ParallelConfig
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import mesh as tmesh
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model, tree_path
from repro_torch.optim import AdamW, constant_schedule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meshes(tp):
    """(JAX abstract mesh, port description) pairs: one pod, two pods."""
    for shape, axes in (((16, tp), ("data", "model")), ((2, 16, tp), ("pod", "data", "model"))):
        yield AbstractMesh(shape, axes), tmesh.make_model_mesh(shape, axes)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _spec(p):
    return tuple(p)


def _assert_param_specs(jspecs, specs, period):
    jleaves = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        jleaves[tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)] = leaf
    seen = set()
    for name, spec in specs.items():
        path, step = tree_path(name, period)
        want = jleaves[path]
        got = ((None,) + _spec(spec)) if step is not None else _spec(spec)
        assert got == _spec(want), (name, got, want)
        seen.add(path)
    assert seen == set(jleaves), sorted(set(jleaves) - seen)


def _assert_plans(jm, m):
    jp, p = jm.plan, m.plan
    assert (p.tp, p.vocab_padded, p.period, p.scan_steps) == \
        (jp.tp, jp.vocab_padded, jp.period, jp.scan_steps)
    for sub in ("attn", "moe", "ssm"):
        a, b = getattr(jp, sub), getattr(p, sub)
        assert (a is None) == (b is None), sub
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b), sub
    if jp.attn is not None:
        ap = jp.attn
        assert (p.attn.slots, p.attn.q_per_slot, p.attn.q_heads_padded) == \
            (ap.slots, ap.q_per_slot, ap.q_heads_padded)
    if jp.moe is not None:
        for f in ("virt_per_expert", "virtual_experts", "d_ff_virtual", "per_rank_slots", "kr"):
            assert getattr(p.moe, f) == getattr(jp.moe, f), f
        for t in (1, 7, 512, 4096):
            assert p.moe.capacity(t) == jp.moe.capacity(t)


def _assert_cache_specs(jcs, cs, period):
    assert len(cs) == len(jcs) * (len(cs) // len(jcs))
    for i, entry in enumerate(cs):
        junit = jcs[i % period]
        assert set(entry) == set(junit)
        if "kv" in entry:
            for k in ("k", "v"):
                assert (None,) + _spec(entry["kv"][k]) == _spec(junit["kv"][k])
        if "ssm" in entry:
            for f in entry["ssm"]._fields:
                assert (None,) + _spec(getattr(entry["ssm"], f)) == \
                    _spec(getattr(junit["ssm"], f)), f


def _assert_input_specs(jin, tin, period):
    assert set(jin) == set(tin)
    for k in jin:
        if k == "cache":
            (jst, jcs), (st, cs) = jin[k], tin[k]
            _assert_cache_specs(jcs, cs, period)
            for i, entry in enumerate(st):
                junit = jst[i % period]
                for name, sub in entry.items():
                    leaves = sub.values() if name == "kv" else sub
                    jl = junit[name].values() if name == "kv" else junit[name]
                    for (shape, dt), js in zip(leaves, jl):
                        assert tuple(js.shape[1:]) == shape
                        assert str(js.dtype) == str(dt).replace("torch.", "")
            continue
        (jsd, jsp), ((shape, dt), sp) = jin[k], tin[k]
        assert tuple(jsd.shape) == shape, k
        assert str(jsd.dtype) == str(dt).replace("torch.", ""), k
        assert _spec(jsp) == _spec(sp), k


@pytest.mark.parametrize("tp", [1, 2, 4, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_and_plans_match_jax(arch, tp):
    jcfg, cfg = J_ARCHS[arch], ARCHS[arch]
    opt = AdamW(constant_schedule(1e-3))
    for fsdp in (True, False):
        for amesh, mesh in _meshes(tp):
            try:
                jm = JModel(jcfg, mesh=amesh, parallel=JParallelConfig(fsdp=fsdp),
                            capacity_factor=1.25)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    Model(cfg, mesh=mesh, parallel=ParallelConfig(fsdp=fsdp),
                          capacity_factor=1.25, device="cpu")
                continue
            m = Model(cfg, mesh=mesh, parallel=ParallelConfig(fsdp=fsdp),
                      capacity_factor=1.25, device="cpu")
            period = m.plan.period
            assert m.dp_axes == jm.dp_axes and m._fsdp == jm._fsdp
            _assert_plans(jm, m)
            _assert_param_specs(jm.param_specs(), m.param_specs(), period)
            jts, ts = jm.train_state_specs(None), m.train_state_specs(opt)
            _assert_param_specs(jts.params, ts.params, period)
            _assert_param_specs(jts.opt.m, ts.opt.m, period)
            _assert_param_specs(jts.opt.v, ts.opt.v, period)
            assert _spec(ts.opt.step) == _spec(jts.opt.step) == ()
            assert _spec(ts.step) == _spec(jts.step)
            assert len(ts.monitor) == len(jts.monitor)
            assert all(_spec(a) == _spec(b) for a, b in zip(ts.monitor, jts.monitor))
            for bs in (True, False):
                _assert_cache_specs(jm.cache_specs(bs), m.cache_specs(bs), period)
            for jshape, shape in zip(J_ALL_SHAPES, ALL_SHAPES):
                assert _spec(m.batch_spec(shape)) == _spec(jm.batch_spec(jshape))
                _assert_input_specs(jm.input_specs(jshape), m.input_specs(shape), period)


def test_param_shardings_cut_every_block_once():
    """Over the ranks of a (2, 2) mesh, the blocks ``param_shardings``
    cuts from each global tensor tile it exactly (FSDP on, llama4's
    period-2 layout at reduced width)."""
    from repro_torch.configs.base import reduced

    cfg = reduced(ARCHS["llama4-maverick-400b-a17b"])
    cover = None
    for rank in range(4):
        mesh = tmesh.make_model_mesh((2, 2), ("data", "model"))
        mesh.coords, mesh.rank = tmesh.mesh_coords(rank, (2, 2)), rank
        m = Model(cfg, mesh=mesh, parallel=ParallelConfig(fsdp=True), device="cpu")
        if cover is None:
            cover = {n: torch.zeros(s) for n, s in m.param_shapes().items()}
            specs = m.param_specs()
        for n, fn in m.param_shardings().items():
            fn(cover[n]).add_(1.0)
    for n, c in cover.items():
        axes = {a for a in specs[n] if a is not None}
        # each element lies in one block of each rank that splits it
        assert torch.equal(c, torch.full_like(c, 4.0 / 2 ** len(axes))), (n, specs[n])


_MESH_PROGRAM = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.launch import mesh as m
    out = {}
    for multi in (False, True):
        mm = m.make_production_mesh(multi_pod=multi)
        out[str(multi)] = [list(mm.axis_names), [int(mm.shape[a]) for a in mm.axis_names],
                           list(m.dp_axes_of(mm))]
    for k in (1, 2, 4, 16):
        hm = m.make_host_mesh(model_axis=k)
        out["host%d" % k] = [list(hm.axis_names), [int(hm.shape[a]) for a in hm.axis_names],
                             list(m.dp_axes_of(hm))]
    print("MESHES", json.dumps(out))
""")


def test_meshes_match_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _MESH_PROGRAM], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.split("MESHES", 1)[1])
    for multi in (False, True):
        pm = tmesh.make_production_mesh(multi_pod=multi)
        assert [list(pm.axis_names), list(pm.shape.values()), list(tmesh.dp_axes_of(pm))] == \
            want[str(multi)]
        assert pm.coords is None and not pm.groups   # a description: no rank, no group
    # with no world running the host mesh is one rank, as JAX's on one device
    hm, jhm = tmesh.make_host_mesh(device="cpu"), jmesh.make_host_mesh()
    assert (hm.axis_names, tuple(hm.shape.values())) == \
        (tuple(jhm.axis_names), tuple(int(jhm.shape[a]) for a in jhm.axis_names))
    assert tmesh.dp_axes_of(hm) == jmesh.dp_axes_of(jhm)
    # a world of 512 ranks lays out as JAX's 512 devices (the layout only)
    for k in (1, 2, 4, 16):
        names, shape, dp = want["host%d" % k]
        got = tmesh.make_model_mesh((512 // k, k), ("data", "model"))
        assert [list(got.axis_names), list(got.shape.values()),
                list(tmesh.dp_axes_of(got))] == [names, shape, dp]
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_host_mesh(model_axis=2, device="cpu")
    # the compat names build and measure the same meshes
    from repro_torch.core import compat

    cm = compat.make_mesh_compat((2, 16, 16), ("pod", "data", "model"))
    assert cm.shape == tmesh.make_production_mesh(multi_pod=True).shape
    assert compat.axis_size_compat(cm, "model") == 16
    assert compat.axis_size_compat(cm, ("pod", "data")) == 32


# ---------------------------------------------------------------------------
# Routing / packing against JAX's
# ---------------------------------------------------------------------------


def _moe_cfgs(E, k, d=32, f=64):
    kw = dict(name="t", family="moe", num_layers=2, d_model=d, vocab_size=128, num_heads=4,
              num_kv_heads=2, d_ff=f, num_experts=E, experts_per_token=k, dtype="float32")
    return JModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("E,k,tp,t,cf", [(4, 2, 1, 32, 1.0), (4, 2, 2, 16, 0.5),
                                          (8, 2, 16, 24, 1.0), (4, 1, 8, 20, 1.0),
                                          (16, 2, 4, 64, 2.0)])
def test_route_and_pack_matches_jax(E, k, tp, t, cf):
    jcfg, cfg = _moe_cfgs(E, k)
    jplan, plan = jmoe.plan_moe(jcfg, tp, cf), tmoe.plan_moe(cfg, tp, cf)
    rng = np.random.default_rng(E * 100 + tp)
    tokens = rng.standard_normal((t, cfg.d_model)).astype(np.float32)
    router = (rng.standard_normal((cfg.d_model, E)) / np.sqrt(cfg.d_model)).astype(np.float32)
    valid = (np.arange(t) < t - 3).astype(np.float32)   # a padded tail
    C = plan.capacity(t)
    assert C == jplan.capacity(t)
    jsend, (js, jp, jw), jaux = jmoe._route_and_pack(jnp.asarray(tokens), jnp.asarray(router),
                                                      jplan, C, jnp.asarray(valid))
    send, (s, p, w), aux = tmoe._route_and_pack(torch.from_numpy(tokens),
                                                torch.from_numpy(router), plan, C,
                                                torch.from_numpy(valid))
    np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=2 ** -21)
    assert float(aux) == pytest.approx(float(jaux), rel=2 ** -21)
    kept = (w.numpy() > 0).sum()
    routed = int(valid.sum()) * plan.kr
    assert kept == (np.asarray(jw) > 0).sum()
    if cf <= 1.0 and E < 16:
        assert kept < routed                           # the capacity dropped entries
    out = rng.standard_normal((plan.virtual_experts, C, cfg.d_model)).astype(np.float32)
    y = tmoe._unpack_combine(torch.from_numpy(out), (s, p, w), C)
    jy = jmoe._unpack_combine(jnp.asarray(out), (js, jp, jw), C)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=1e-6)


def test_moe_plan_capacity_matches_jax():
    for E, k, tp, cf in ((8, 2, 16, 1.0), (128, 1, 2, 1.0), (128, 1, 2, 128.0), (4, 2, 4, 1.5)):
        jcfg, cfg = _moe_cfgs(E, k, f=64)
        jplan, plan = jmoe.plan_moe(jcfg, tp, cf), tmoe.plan_moe(cfg, tp, cf)
        assert (plan.per_rank_slots, plan.kr, plan.capacity_factor) == \
            (jplan.per_rank_slots, jplan.kr, jplan.capacity_factor)
        for t in (1, 3, 512, 1024):
            assert plan.capacity(t) == jplan.capacity(t)


def test_deferred_layouts_raise():
    """The layouts once deferred now build and run: the SSM mixer under TP
    (mamba2 at tp 2, hymba at tp 4) and dense FSDP over ``data`` (qwen2 on
    (2, 1)), each on one rank's coordinates of its mesh (a dry rank: the
    program runs on ``meta`` with no process group), a prefill giving the
    full vocabulary's logits and a training step its metrics; a mesh that
    only describes a layout still refuses ``init``."""
    from repro_torch.configs.base import reduced

    one = tmesh.make_model_mesh((1, 1), ("data", "model"), device="cpu")
    gen = torch.Generator().manual_seed(0)
    for arch, shape, par in (("mamba2-130m", (1, 2), ParallelConfig()),
                             ("hymba-1.5b", (1, 4), ParallelConfig(fsdp=False)),
                             ("qwen2-1.5b", (2, 1), ParallelConfig(fsdp=True))):
        for coords in np.ndindex(*shape):
            mesh = tmesh.dry_rank(tmesh.make_model_mesh(shape, ("data", "model")), coords)
            m = Model(reduced(ARCHS[arch]), mesh=mesh, parallel=par)
            params = m.init(gen)              # drawn on the CPU, kept on meta
            assert {p.device.type for p in params.parameters()} == {"meta"}
            logits, _ = m.make_prefill()(params, torch.zeros((2, 16), dtype=torch.long))
            assert logits.shape == (2, 1, m.plan.vocab_padded)
            opt = AdamW(constant_schedule(1e-3))
            state = m.train_state_of(params, opt)
            batch = {k: torch.zeros((2 // shape[0], 16), dtype=torch.int32, device="meta")
                     for k in ("inputs", "labels")}
            state, met = m.make_train_step(opt)[0](state, batch)
            assert met["loss"].shape == () and int(mesh.moved_bytes["all_reduce"]) > 0
            if shape[0] > 1:       # FSDP: the weights gathered and their gradients scattered
                assert mesh.moved_bytes["all_gather"] > 0 and mesh.moved_bytes["reduce_scatter"] > 0
    described = Model(reduced(ARCHS["qwen2-1.5b"]), mesh=tmesh.make_production_mesh(),
                      device="cpu")
    with pytest.raises(ValueError, match="describes a layout"):
        described.init(gen)
    # a one-rank mesh runs with no process group
    assert Model(reduced(ARCHS["qwen2-1.5b"]), mesh=one).init(gen) is not None
