"""The port's parallel layout run in gloo worlds, against the JAX package's
``Model`` and ``moe_apply`` on meshes of forced host devices.

Every input (parameters at each case's plan, tokens, activations) is
drawn with numpy from a seed and saved; one JAX program in a subprocess
with 4 forced host devices runs every JAX case on them while the port
runs the same cases in two local worlds of spawned gloo ranks
(``launch.mesh.spawn_world``, a ``FileStore`` under ``tmp_path``): a world
of 2 (TP at tp 2, EP on (1, 2), data-parallel training on (2, 1)) and a
world of 4 (TP at tp 4, EP on (1, 4) and (2, 2)).  Every rank returns its
results; the gathered ones must agree across ranks.

* TP, reduced qwen2-1.5b in f32 (2 layers, d_model 64, 4 q heads over 1
  kv head: kv replicas 2 at tp 2, 4 at tp 4), global parameters of each
  tp's plan carried into each rank's blocks by ``interop.shard_params``,
  batch 2 × 16 tokens: prefill logits (gathered over ``model``) and one
  decode step's logits within 1e-5 of the largest logit; the loss within
  rtol 2e-6; every gradient after ``apply_grad_fixups`` (gathered by
  ``interop.gather_params``) within 5e-5 of its tensor's largest JAX
  gradient, the global norm within rtol 1e-5 (the same f32 arithmetic in
  another order, the TP partial sums added over the ranks; the worst entry
  here is a norm scale's gradient at 2.3e-5 of its largest, a sum over
  every row whose terms cancel, the rest under 1e-5); the ``tp_reduce_bf16`` loss within
  rtol 2e-6 of JAX's bf16-reduce loss at tp 2 (one rounding of a + b
  either way) and, at tp 4, within half of the bf16 reduction's own effect
  on JAX's loss (|JAX bf16-reduce − JAX f32-reduce|; gloo sums the four
  bf16 partials in its own order: 22% of it on this config), and within
  5e-3 of the f32-reduce loss (JAX's bar,
  ``tests/test_perf_variants.py:63-73``).
* EP, ``moe_apply`` (E = 4 top-2 on (1, 2) and (2, 2), the last through
  the expert-TP branch over ``data``; E = 2 top-1 on (1, 4), split into 4
  virtual experts), f32, 4 × 8 tokens of width 32, capacity factor 1.0 so
  that entries drop: the output within 1e-5 of its largest, the aux loss
  within rtol 1e-6 of the mean of JAX's per-data-shard values (ROADMAP
  Queue 3), the gradients of sum(y²) + 0.01·aux for the router, every
  expert weight and the input within 1e-5 of their largest, and the
  dropped entries of every (data, model) slice equal to JAX's
  ``_route_and_pack`` on that slice.  One case at ample capacity (factor
  Ev, nothing drops) must equal ``moe_local_reference`` within 1e-5.
* ``launch/train.py:train`` over a (2, 1) data-parallel world, both
  packages' ``train`` starting from the same drawn state (each
  ``Model``'s initialiser patched to return it; qwen2 reduced, bf16, as
  ``train`` builds it, batch 4 ×
  32, 4 steps, so 3 losses are read): each loss within rtol 2e-3 of JAX's
  ``train(mesh=…)`` (two bf16 models in another order, both with JAX's
  default layout, dense FSDP over ``data``; the bf16 loss bar of
  ``tests/test_torch_train.py`` is 1e-3 on one step, and Adam's updates
  carry each step's rounding into the next).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 16
MOE_B, MOE_S, MOE_D, MOE_F = 4, 8, 32, 64
# (data, model, E, top-k): the expert-parallel cases
EP_CASES = {"ep12": (1, 2, 4, 2), "ep14": (1, 4, 2, 1), "ep22": (2, 2, 4, 2)}
TRAIN_KW = dict(steps=4, batch=4, seq=32, log_every=1000)


def tp_cfg_kw():
    """Reduced qwen2-1.5b in f32 (the same fields for either package)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch

    return dataclasses.asdict(reduced(get_arch("qwen2-1.5b"), dtype="float32"))


def moe_cfg_kw(E, k):
    return dict(name="t", family="moe", num_layers=2, d_model=MOE_D, vocab_size=128,
                num_heads=4, num_kv_heads=2, d_ff=MOE_F, num_experts=E, experts_per_token=k,
                dtype="float32")


def tokens(cfg_vocab):
    rng = np.random.default_rng(7)
    return (rng.integers(0, cfg_vocab, (B, S)).astype(np.int32),
            rng.integers(0, cfg_vocab, (B, 1)).astype(np.int32))


def batch(cfg_vocab):
    rng = np.random.default_rng(11)
    ids = rng.integers(0, cfg_vocab, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    labels[:, -1] = -1
    return {"inputs": ids, "labels": labels}


def moe_x():
    return np.random.default_rng(5).standard_normal((MOE_B, MOE_S, MOE_D)).astype(np.float32)


def draw_params(shapes, seed):
    """Numpy draws for a parameter tree of ``(shape, dtype name)`` leaves:
    ones for the norms, N(0, 0.02²) for the tables and biases, N(0, 1/fan-in)
    for the weights (fan-in every axis but the last for ``wo`` and
    ``out_proj``, the first axis else)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, dt = leaf
        name = path[-1]
        if name in ("ln1", "ln2", "final_norm"):
            a = np.ones(shape, np.float32)
        elif name in ("embed", "lm_head", "bq", "bk", "bv"):
            a = 0.02 * rng.standard_normal(shape)
        else:
            fan = int(np.prod(shape[:-1])) if name in ("wo", "out_proj") else shape[0]
            a = rng.standard_normal(shape) / np.sqrt(fan)
        a = a.astype(np.float32)
        if dt == "bfloat16":   # round to bf16, kept as its bits
            return ((a.view(np.uint32) + 0x7FFF + ((a.view(np.uint32) >> 16) & 1)) >> 16
                    ).astype(np.uint16)
        return a

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (tuple, list)) and not (len(t) == 2 and isinstance(t[1], str)):
            return tuple(walk(v, path + (i,)) for i, v in enumerate(t))
        return draw(path, t)

    return walk(shapes, ())


def flat(tree, prefix=""):
    """A tree of dicts and tuples as ``{"a/0/b": numpy}``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree.detach() if hasattr(tree, "detach") else tree)
    return out


def unflat(z, prefix):
    """``flat``'s inverse for the keys under ``prefix`` (a layer list is a
    tuple)."""
    root = {}
    for key, v in z.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def fix(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return tuple(fix(d[str(i)]) for i in range(len(d)))
        return {k: fix(v) for k, v in d.items()}

    return fix(root)


_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_parallel as t
    from repro.configs.base import ModelConfig, ParallelConfig, reduced
    from repro.configs.registry import get_arch
    from repro.core.compat import make_mesh_compat
    from repro.launch.mesh import make_host_mesh
    from repro.launch.train import train
    from repro.models import Model
    from repro.models import moe as jmoe
    from repro.models.layers import ceil_to
    from repro.models.transformer import moe_local_reference
    from repro.optim.adamw import global_norm

    import repro.models.model as jmodel
    z = dict(np.load(sys.argv[3]))

    def tree(prefix):   # bf16 leaves arrive as their bits
        return jax.tree.map(lambda a: jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                                                  else a), t.unflat(z, prefix))

    out = {}
    cfg = ModelConfig(**t.tp_cfg_kw())
    toks, nxt = t.tokens(cfg.vocab_size)
    bt = {k: jnp.asarray(v) for k, v in t.batch(cfg.vocab_size).items()}
    for tp in (2, 4):
        mesh = make_mesh_compat((1, tp), ("data", "model"))
        m = Model(cfg, mesh=mesh)
        params = tree("tp%d/param/" % tp)
        logits, cache = jax.jit(m.make_prefill())(params, jnp.asarray(toks))
        cache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))),
                             cache)
        dl, _ = jax.jit(m.make_decode_step())(params, cache, jnp.asarray(nxt), t.S)
        (loss, _), g = jax.jit(jax.value_and_grad(m.loss_fn, has_aux=True))(params, bt)
        g = m.apply_grad_fixups(g)
        m2 = Model(cfg, mesh=mesh, parallel=ParallelConfig(tp_reduce_bf16=True))
        loss2, _ = jax.jit(m2.loss_fn)(params, bt)
        hm = make_host_mesh(model_axis=tp)
        out.update({"tp%d/prefill" % tp: np.asarray(logits), "tp%d/decode" % tp: np.asarray(dl),
                    "tp%d/loss" % tp: np.asarray(loss), "tp%d/loss_bf16" % tp: np.asarray(loss2),
                    "tp%d/gnorm" % tp: np.asarray(global_norm(g)),
                    "tp%d/host" % tp: np.asarray([int(hm.shape[a]) for a in hm.axis_names])})
        out.update(t.flat(g, "tp%d/grad/" % tp))
    x = jnp.asarray(t.moe_x())
    route = jax.jit(jmoe._route_and_pack, static_argnums=(2, 3))
    for name, (dp, tp, E, k) in t.EP_CASES.items():
        mcfg = ModelConfig(**t.moe_cfg_kw(E, k))
        mesh = make_mesh_compat((dp, tp), ("data", "model"))
        for tag, cf in (("tight", 1.0), ("ample", None)):
            if tag == "ample" and name != "ep12":
                continue
            plan = jmoe.plan_moe(mcfg, tp, 1.0)
            plan = jmoe.plan_moe(mcfg, tp, float(plan.virtual_experts) if cf is None else cf)
            w = tree(name + "/" + tag + "/w/")

            def loss(w, x):
                y, aux = jmoe.moe_apply(x, w, plan, True, mesh, dp_axes=("data",))
                return jnp.sum(y ** 2) + 0.01 * aux, (y, aux)

            (l, (y, aux)), (gw, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(w, x)
            key = name + "/" + tag
            out.update(t.flat(gw, key + "/gw/"))
            out[key + "/gx"] = np.asarray(gx)
            out[key + "/y"] = np.asarray(y)
            out[key + "/aux"] = np.asarray([float(s.data) for s in aux.addressable_shards])
            if tag == "ample":
                yr, ar = moe_local_reference(x, w, plan, True)
                out[key + "/y_ref"] = np.asarray(yr)
            # dropped entries of each (data, model) slice, as moe_block_local cuts them
            drops = []
            for d in range(dp):
                rows = x[d * (t.MOE_B // dp):(d + 1) * (t.MOE_B // dp)].reshape(-1, t.MOE_D)
                T = rows.shape[0]
                t_pad = ceil_to(max(T, tp), tp)
                tpr = t_pad // tp
                rows = jnp.pad(rows, ((0, t_pad - T), (0, 0)))
                for r in range(tp):
                    valid = ((r * tpr + jnp.arange(tpr)) < T).astype(jnp.float32)
                    _, (_, _, w2), _ = route(rows[r * tpr:(r + 1) * tpr], w["router"], plan,
                                             plan.capacity(tpr), valid)
                    drops.append(int(valid.sum()) * plan.kr - int((w2 > 0).sum()))
            out[key + "/drops"] = np.asarray(drops)
    mesh = make_mesh_compat((2, 1), ("data", "model"))
    jmodel.Model.init = lambda self, key: tree("train/param/")   # the drawn state
    res = train("qwen2-1.5b", mesh=mesh, **t.TRAIN_KW)
    out["train/losses"] = np.asarray(res["losses"])
    np.savez(sys.argv[1], **out)
    print("JAX_PARALLEL_OK", len(out))
""")


def _inputs(path):
    """Every case's global parameters, drawn with numpy (their shapes from
    the JAX initialisers at each case's plan, traced without computing)."""
    import jax

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.configs.base import reduced as jreduced
    from repro.configs.registry import get_arch as jget_arch
    from repro.models import moe as jmoe
    from repro.models.transformer import init_params, make_plan

    def shapes(fn):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jax.eval_shape(fn))

    key = jax.random.PRNGKey(0)
    out = {}
    cfg = JModelConfig(**tp_cfg_kw())
    for tp in (2, 4):
        out.update(flat(draw_params(shapes(lambda: init_params(key, make_plan(cfg, tp))), tp),
                        f"tp{tp}/param/"))
    for name, (dp, tp, E, k) in EP_CASES.items():
        mcfg = JModelConfig(**moe_cfg_kw(E, k))
        plan = jmoe.plan_moe(mcfg, tp)
        w = draw_params(shapes(lambda: jmoe.moe_init(key, plan, True, "float32")), 3)
        out.update(flat(w, f"{name}/tight/w/"))
        out.update(flat(w, f"{name}/ample/w/"))
    tcfg = jreduced(jget_arch("qwen2-1.5b"))
    out.update(flat(draw_params(shapes(lambda: init_params(key, make_plan(tcfg, 1))), 0),
                    "train/param/"))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each world's ranks' results): the JAX subprocess and
    the port's worlds run at the same time on the same saved inputs."""
    from repro_torch.launch.mesh import spawn_world

    d = tmp_path_factory.mktemp("parallel")
    inputs, jpath = str(d / "inputs.npz"), str(d / "jax.npz")
    _inputs(inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _PROGRAM, jpath, REPO, inputs], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = {k: spawn_world(_rank_job, k, str(d), args=(inputs, cases), timeout=500)
                for k, cases in WORLDS.items()}
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-3000:]
    assert "JAX_PARALLEL_OK" in stdout
    with np.load(jpath) as z:
        return {k: z[k] for k in z.files}, port


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[1]


def _bits_to_bf16(tree):
    """uint16 leaves (bf16 bits) back to bf16 tensors."""
    if isinstance(tree, dict):
        return {k: _bits_to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_bits_to_bf16(v) for v in tree)
    if tree.dtype == np.uint16:
        return torch.from_numpy(tree.copy()).view(torch.bfloat16)
    return tree


# ---------------------------------------------------------------------------
# The ranks' jobs
# ---------------------------------------------------------------------------


def _tp_case(z, tp):
    from repro_torch import interop
    from repro_torch.configs.base import ModelConfig, ParallelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    cfg = ModelConfig(**tp_cfg_kw())
    mesh = make_host_mesh(model_axis=tp, device="cpu")
    m = Model(cfg, mesh=mesh, device="cpu")
    params = interop.shard_params(unflat(z, f"tp{tp}/param/"), m, mesh)
    toks, nxt = tokens(cfg.vocab_size)
    logits, cache = m.make_prefill()(params, torch.from_numpy(toks), max_len=S + 1)
    dl, _ = m.make_decode_step()(params, cache, torch.from_numpy(nxt), S)
    bt = {k: torch.from_numpy(v) for k, v in batch(cfg.vocab_size).items()}
    params.requires_grad_(True)
    loss, _ = m.loss_fn(params, bt)
    loss.backward()
    grads = m.apply_grad_fixups({n: p.grad for n, p in params.named_parameters()})
    gnorm = m.global_norm(grads)
    gathered = flat(interop.gather_params(grads, m))
    m2 = Model(cfg, mesh=mesh, parallel=ParallelConfig(tp_reduce_bf16=True), device="cpu")
    with torch.no_grad():
        loss2, _ = m2.loss_fn(params, bt)
    return {"prefill": logits.numpy(), "decode": dl.numpy(), "loss": float(loss.detach()),
            "loss_bf16": float(loss2), "gnorm": float(gnorm), "grads": gathered,
            "host": list(mesh.shape.values()), "moved": dict(mesh.moved_bytes)}


def _ep_case(z, name, tag):
    import torch.distributed as dist

    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models import collectives as col
    from repro_torch.models import moe as tmoe
    from repro_torch.models.transformer import moe_local_reference

    dp, tp, E, k = EP_CASES[name]
    cfg = ModelConfig(**moe_cfg_kw(E, k))
    mesh = make_model_mesh((dp, tp), ("data", "model"), device="cpu")
    plan = tmoe.plan_moe(cfg, tp, 1.0)
    plan = tmoe.plan_moe(cfg, tp, float(plan.virtual_experts) if tag == "ample" else 1.0)
    key = f"{name}/{tag}"
    w = unflat(z, key + "/w/")
    ws = tmoe.MoE(plan, True, torch.float32)
    dr, mr = mesh.index("data"), mesh.index("model")
    ps, Fv = plan.per_rank_slots, plan.d_ff_virtual // dp
    experts, ff = slice(mr * ps, (mr + 1) * ps), slice(dr * Fv, (dr + 1) * Fv)
    with torch.no_grad():   # moe_apply's layout: experts over model, d_ff over data
        ws.router.copy_(torch.from_numpy(w["router"]))
        ws.w1 = torch.nn.Parameter(torch.from_numpy(w["w1"][experts][:, :, ff].copy()))
        ws.w3 = torch.nn.Parameter(torch.from_numpy(w["w3"][experts][:, :, ff].copy()))
        ws.w2 = torch.nn.Parameter(torch.from_numpy(w["w2"][experts][:, ff].copy()))
    ws.requires_grad_(True)
    rows = slice(dr * (MOE_B // dp), (dr + 1) * (MOE_B // dp))
    x = torch.from_numpy(moe_x()[rows].copy()).requires_grad_(True)
    mesh.moe_drops = []
    y, aux = tmoe.moe_apply(x, ws, plan, True, mesh, dp_axes=("data",))
    ((y ** 2).sum() + 0.01 * aux).backward()
    router_g = col.all_reduce(ws.router.grad, mesh, "data")   # its data shards' parts

    def whole(g, dims):   # gather a block over (model on dim 0, data on dim f)
        g = col.all_gather(g.contiguous(), mesh, "model", dim=0)
        return col.all_gather(g.contiguous(), mesh, "data", dim=dims)

    out = {"y": col.all_gather(y.detach(), mesh, "data", dim=0).numpy(), "aux": float(aux),
           "gx": col.all_gather(x.grad, mesh, "data", dim=0).numpy(),
           "router": router_g.numpy(), "w1": whole(ws.w1.grad, 2).numpy(),
           "w3": whole(ws.w3.grad, 2).numpy(), "w2": whole(ws.w2.grad, 1).numpy()}
    drops = torch.stack([d for d, _ in mesh.moe_drops]).reshape(1)
    every = [torch.zeros_like(drops) for _ in range(dist.get_world_size())]
    dist.all_gather(every, drops)
    out["drops"] = [int(v) for v in torch.cat(every)]
    if tag == "ample":
        yr, _ = moe_local_reference(torch.from_numpy(moe_x()), _full_moe(w, plan), plan, True)
        out["y_local"] = yr.detach().numpy()
    return out


def _full_moe(w, plan):
    from repro_torch.models import moe as tmoe

    ws = tmoe.MoE(plan, True, torch.float32)
    with torch.no_grad():
        for n in ("router", "w1", "w2", "w3"):
            getattr(ws, n).copy_(torch.from_numpy(w[n]))
    return ws


def _train_case(z):
    from repro_torch import interop
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(model_axis=1, device="cpu")
    tree = _bits_to_bf16(unflat(z, "train/param/"))
    init = ttrain.Model.init_train_state

    def carried(self, gen, optimizer, monitor=None):   # JAX's initial draw, this rank's blocks
        state = init(self, gen, optimizer, monitor)
        named = dict(state.params.named_parameters())
        blocks = self.param_blocks()
        with torch.no_grad():
            for n, leaf in interop._named_from_tree(tree, named).items():
                named[n].copy_(leaf[blocks[n]])
        return state

    ttrain.Model.init_train_state = carried
    try:
        res = ttrain.train("qwen2-1.5b", mesh=mesh, **TRAIN_KW)
    finally:
        ttrain.Model.init_train_state = init
    return {"losses": list(res["losses"]), "steps": res["steps_run"]}


def _rank_job(rank, k, store, path, cases):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=store, rank=rank, world_size=k)
    with np.load(path) as zf:
        z = {key: zf[key] for key in zf.files}
    out = {}
    for case in cases:
        if case.startswith("tp"):
            out[case] = _tp_case(z, int(case[2:]))
        elif case == "train":
            out[case] = _train_case(z)
        else:
            name, tag = case.split("/")
            out[case] = _ep_case(z, name, tag)
    return out


WORLDS = {2: ("tp2", "ep12/tight", "ep12/ample", "train"),
          4: ("tp4", "ep14/tight", "ep22/tight")}


def _ranks(port_runs, case):
    k = next(k for k, cases in WORLDS.items() if case in cases)
    return [r[case] for r in port_runs[k]]


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# The comparisons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_prefill_and_decode_match_jax(jax_runs, port_runs, tp):
    for r in _ranks(port_runs, f"tp{tp}"):
        # the world of tp ranks laid out as JAX lays its 4 devices at tp 4
        assert r["host"] == ([int(v) for v in jax_runs["tp4/host"]] if tp == 4 else [1, 2])
        _close(r["prefill"], jax_runs[f"tp{tp}/prefill"], 1e-5, "prefill")
        _close(r["decode"], jax_runs[f"tp{tp}/decode"], 1e-5, "decode")
        assert r["prefill"].shape == jax_runs[f"tp{tp}/prefill"].shape   # the full vocabulary


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_loss_and_grads_match_jax(jax_runs, port_runs, tp):
    ranks = _ranks(port_runs, f"tp{tp}")
    want = {k[len(f"tp{tp}/grad/"):]: v for k, v in jax_runs.items()
            if k.startswith(f"tp{tp}/grad/")}
    for r in ranks:
        assert r["loss"] == pytest.approx(float(jax_runs[f"tp{tp}/loss"]), rel=2e-6)
        assert r["gnorm"] == pytest.approx(float(jax_runs[f"tp{tp}/gnorm"]), rel=1e-5)
        assert sorted(r["grads"]) == sorted(want)
        for name, g in r["grads"].items():
            _close(g, want[name], 5e-5, name)
        # the model's collectives moved bytes over every kind the layout uses
        assert {"all_reduce", "all_gather"} <= set(r["moved"])
    # kv replicas tied across ranks: every replica slot holds its group's sum
    wk = ranks[0]["grads"]["layers/0/attn/wk"]
    assert np.array_equal(wk[:, :, 0], wk[:, :, -1])


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_reduce_bf16_loss(jax_runs, port_runs, tp):
    want, f32 = float(jax_runs[f"tp{tp}/loss_bf16"]), float(jax_runs[f"tp{tp}/loss"])
    for r in _ranks(port_runs, f"tp{tp}"):
        if tp == 2:   # one rounding of a + b on either side
            assert r["loss_bf16"] == pytest.approx(want, rel=2e-6)
        else:         # four bf16 partials summed in gloo's order, not XLA's
            assert abs(r["loss_bf16"] - want) <= 0.5 * abs(want - f32)
        assert abs(r["loss_bf16"] - r["loss"]) < 5e-3


@pytest.mark.parametrize("case", ["ep12/tight", "ep14/tight", "ep22/tight", "ep12/ample"])
def test_moe_apply_matches_jax(jax_runs, port_runs, case):
    want = {k[len(case) + 1:]: v for k, v in jax_runs.items() if k.startswith(case + "/")}
    for r in _ranks(port_runs, case):
        _close(r["y"], want["y"], 1e-5, "y")
        assert r["aux"] == pytest.approx(float(np.mean(want["aux"])), rel=1e-6)
        _close(r["gx"], want["gx"], 1e-5, "grad x")
        for n in ("router", "w1", "w2", "w3"):
            _close(r[n], want["gw/" + n], 1e-5, "grad " + n)
        assert r["drops"] == [int(v) for v in want["drops"]]
        if case.endswith("tight"):
            assert sum(r["drops"]) > 0          # capacity factor 1.0 drops entries
        else:
            assert sum(r["drops"]) == 0
            _close(r["y_local"], want["y_ref"], 1e-5, "local reference")
            _close(r["y"], r["y_local"], 1e-5, "ample vs local reference")


def test_data_parallel_train_matches_jax(jax_runs, port_runs):
    want = jax_runs["train/losses"]
    assert len(want) == TRAIN_KW["steps"] - 1
    for r in _ranks(port_runs, "train"):
        assert r["steps"] == TRAIN_KW["steps"]
        np.testing.assert_allclose(r["losses"], want, rtol=2e-3)
