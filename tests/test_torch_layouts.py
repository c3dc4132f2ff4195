"""The rest of the parallel layout against the JAX package: the SSM mixer
under tensor parallelism, dense FSDP over ``data``, checkpoints of a
sharded state in both directions, and a dry rank's counts against a live
rank's.

Every input is drawn with numpy from a seed and saved; a JAX program in
two subprocesses (SSM and checkpoint cases, FSDP cases) with 4 forced host
devices runs every JAX case, one compile a case, while the port runs the
same cases in two local gloo worlds (``spawn_world``, a
``FileStore`` under ``tmp_path``): a world of 2 and a world of 4.  A
second round, once both are done, resumes each package's checkpoint in
the other.  All in f32 but the checkpoint runs (reduced qwen2 in bf16, as
``train`` builds it).

* SSM under TP: reduced mamba2-130m with 5 SSD heads (padded to 6 at tp 2
  and to 8 at tp 4) and reduced hymba-1.5b with 6 (padded to 8 at tp 4:
  attention ∥ SSD on one norm), batch 2 × 32, against JAX's
  ``Model(cfg, mesh=(1, tp))`` on the same global parameters: the prefill
  logits (gathered over ``model``) and one decode step within 1e-5 of the
  largest logit, the loss within rtol 1e-6, every gradient after
  ``apply_grad_fixups`` (gathered) within 5e-5 of its tensor's largest
  JAX gradient (the TP partial sums added in another order; the gated
  norm's Σy² is summed over the ranks).
* FSDP with JAX's default ``ParallelConfig()``: reduced qwen2-1.5b on
  (2, 1) and (2, 2), reduced llama4-maverick (a dense and a MoE layer,
  experts over ``model``, their d_ff over ``data``) on (2, 2), batch 4 ×
  16: the first step's loss (the NLL for llama4, whose aux loss JAX reads
  from data shard 0, ROADMAP Queue 3) within rtol 1e-6 and its gathered
  gradients within 5e-5 of their largest; then 3 AdamW steps, each loss
  within rtol 1e-5 and the gathered parameters within 2e-5 of their
  tensor's largest (an update is lr·m̂/√v̂: a gradient entry near zero
  whose rounding differs moves its parameter by up to 2·lr, 1e-6 here).
* Checkpoints: JAX's ``train(mesh=(2, 1), ckpt_dir=…)`` (8 steps, a
  checkpoint after step 4) resumes in the port's sharded ``train`` with
  JAX's losses of steps 5 and 6 within rtol 2e-3 (the bf16 bar of
  ``tests/test_torch_parallel.py``); the port's sharded save (after step
  2 of 3) restores in JAX's ``Checkpointer.restore(like=…)`` with every
  leaf bitwise the port's gathered state.
* Dry against live: one reduced qwen2 training step on a (2, 2) gloo world
  with FSDP, and the same step on a dry rank (``launch.mesh.dry_rank``,
  ``meta``): the payload bytes of every collective kind equal rank 0's
  live counter, and the dry FLOPs equal a ``FlopCounterMode`` count of the
  live step.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 32
FB, FS = 4, 16
SSM_CASES = {"mamba2": ("mamba2-130m", 5), "hymba": ("hymba-1.5b", 6)}
FSDP_CASES = {"qwen21": ("qwen2-1.5b", (2, 1)), "qwen22": ("qwen2-1.5b", (2, 2)),
              "llama22": ("llama4-maverick-400b-a17b", (2, 2))}
FSDP_STEPS, FSDP_LR = 3, 1e-6
CKPT_KW = dict(batch=4, seq=32, log_every=1000)


def cfg_kw(arch, **over):
    """A reduced config's fields (the same for either package)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch

    return dataclasses.asdict(reduced(get_arch(arch), **over))


def ssm_kw(case):
    arch, heads = SSM_CASES[case]
    return cfg_kw(arch, dtype="float32", ssm_heads=heads)


def fsdp_kw(case):
    return cfg_kw(FSDP_CASES[case][0], dtype="float32")


def tokens(vocab):
    rng = np.random.default_rng(7)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, 1)).astype(np.int32))


def batches(vocab, n, b=B, s=S):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        ids = rng.integers(0, vocab, (b, s)).astype(np.int32)
        labels = np.roll(ids, -1, axis=1)
        labels[:, -1] = -1
        out.append({"inputs": ids, "labels": labels})
    return out


def draw_params(shapes, seed):
    """Numpy draws for a JAX parameter tree of ``(shape, dtype name)``
    leaves (a layer's leaves carry the stacked axis first): ones for the
    norms, N(0, 0.02²) tables and biases, N(0, 0.5²) ``A_log`` /
    ``dt_bias``, N(0, 0.2²) convolutions, N(0, 1/fan-in) weights (fan-in
    every axis of a layer leaf but the stacked one and the last for
    ``wo`` and ``out_proj``, its first axis else)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, dt = leaf
        name = path[-1]
        inner = shape[1:] if path[0] == "layers" else shape
        if name in ("ln1", "ln2", "final_norm", "norm", "D_skip"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("embed", "lm_head", "bq", "bk", "bv"):
            a = 0.02 * rng.standard_normal(shape)
        elif name in ("A_log", "dt_bias"):
            a = 0.5 * rng.standard_normal(shape)
        elif name.startswith("conv"):
            a = 0.2 * rng.standard_normal(shape)
        else:
            fan = int(np.prod(inner[:-1])) if name in ("wo", "out_proj") else inner[0]
            if name in ("w1", "w2", "w3") and len(inner) == 3:   # experts [E, in, out]
                fan = inner[1]
            a = rng.standard_normal(shape) / np.sqrt(fan)
        return a.astype(np.float32)

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
        a = tree.detach() if hasattr(tree, "detach") else tree
        if hasattr(a, "dtype") and str(a.dtype) == "torch.bfloat16":
            a = a.view(torch.int16).numpy().view(np.uint16)
        out[prefix[:-1]] = np.asarray(a)
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
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_layouts as t
    from repro.configs.base import ModelConfig
    from repro.core.compat import make_mesh_compat
    from repro.launch.train import train
    from repro.models import Model
    from repro.optim import AdamW, constant_schedule
    import repro.models.model as jmodel
    z = dict(np.load(sys.argv[3]))
    out = {}

    def tree(prefix):
        return jax.tree.map(jnp.asarray, t.unflat(z, prefix))

    def pad_kv(cache):   # room for one decode step on the kv leaves
        def pad(path, c):
            if any(getattr(k, "key", None) == "kv" for k in path):
                return jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0)))
            return c
        return jax.tree_util.tree_map_with_path(pad, cache)

    if sys.argv[5] == "ssm":
        for case in t.SSM_CASES:
            cfg = ModelConfig(**t.ssm_kw(case))
            toks, nxt = t.tokens(cfg.vocab_size)
            bt = {k: jnp.asarray(v) for k, v in t.batches(cfg.vocab_size, 1)[0].items()}
            for tp in (2, 4):
                key = "%s%d" % (case, tp)
                m = Model(cfg, mesh=make_mesh_compat((1, tp), ("data", "model")))

                def run(params, toks, nxt, bt):   # one compile a case
                    logits, cache = m.make_prefill()(params, toks)
                    dl, _ = m.make_decode_step()(params, pad_kv(cache), nxt, t.S)
                    (loss, _), g = jax.value_and_grad(m.loss_fn, has_aux=True)(params, bt)
                    return logits, dl, loss, m.apply_grad_fixups(g)

                logits, dl, loss, g = jax.jit(run)(tree(key + "/param/"), jnp.asarray(toks),
                                                   jnp.asarray(nxt), bt)
                out.update({key + "/prefill": np.asarray(logits),
                            key + "/decode": np.asarray(dl), key + "/loss": np.asarray(loss)})
                out.update(t.flat(g, key + "/grad/"))

        # the checkpoint JAX's sharded train writes after step 4, and its losses
        jmodel.Model.init = lambda self, key: jax.tree.map(
            lambda a: jnp.asarray(a).astype(jnp.bfloat16), tree("ckpt/param/"))
        res = train("qwen2-1.5b", mesh=make_mesh_compat((2, 1), ("data", "model")), steps=8,
                    ckpt_dir=sys.argv[4], ckpt_every=4, **t.CKPT_KW)
        out["ckpt/losses"] = np.asarray(res["losses"])
    else:
        for case, (arch, shape) in t.FSDP_CASES.items():
            cfg = ModelConfig(**t.fsdp_kw(case))
            mesh = make_mesh_compat(shape, ("data", "model"))
            m = Model(cfg, mesh=mesh)
            opt = AdamW(constant_schedule(t.FSDP_LR))
            params = jax.device_put(tree(case + "/param/"), m.param_shardings())
            bspec = NamedSharding(mesh, P("data", None))
            bts = [{k: jax.device_put(jnp.asarray(v), bspec) for k, v in b.items()}
                   for b in t.batches(cfg.vocab_size, t.FSDP_STEPS, t.FB, t.FS)]
            state = m.init_train_state(jax.random.PRNGKey(0), opt)
            state = state._replace(params=params, opt=opt.init(params))
            step, _ = m.make_train_step(opt)

            def run(state, b):   # one compile a case: the step's gradients, then the step
                (loss, met), g = jax.value_and_grad(m.loss_fn, has_aux=True)(state.params, b)
                new, smet = step(state, b)
                return loss, met["nll"], m.apply_grad_fixups(g), new, smet

            run = jax.jit(run)
            nlls = []
            for i, b in enumerate(bts):
                loss, nll, g, state, met = run(state, b)
                if i == 0:
                    out[case + "/loss0"] = np.asarray(loss)
                    out[case + "/nll0"] = np.asarray(nll)
                    out.update(t.flat(g, case + "/grad/"))
                nlls.append(float(met["nll"] if "nll" in met else met["loss"]))
            out[case + "/nlls"] = np.asarray(nlls)
            out.update(t.flat(state.params, case + "/final/"))
    np.savez(sys.argv[1] + ".npz", **out)
    print("JAX_LAYOUTS_OK", len(out))
""")


def _inputs(path):
    """Every case's global parameters, drawn with numpy at each case's
    plan (their shapes from the JAX initialisers, traced without
    computing)."""
    import jax

    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models.transformer import init_params, make_plan

    def shapes(cfg, tp):
        return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jax.eval_shape(
            lambda: init_params(jax.random.PRNGKey(0), make_plan(cfg, tp))))

    out = {}
    for case in SSM_CASES:
        cfg = JModelConfig(**ssm_kw(case))
        for tp in (2, 4):
            out.update(flat(draw_params(shapes(cfg, tp), tp), f"{case}{tp}/param/"))
    for case, (_, (dp, tp)) in FSDP_CASES.items():
        cfg = JModelConfig(**fsdp_kw(case))
        out.update(flat(draw_params(shapes(cfg, tp), 3), f"{case}/param/"))
    cfg = JModelConfig(**cfg_kw("qwen2-1.5b"))
    out.update(flat(draw_params(shapes(cfg, 1), 0), "ckpt/param/"))
    np.savez(path, **out)


# ---------------------------------------------------------------------------
# The ranks' jobs
# ---------------------------------------------------------------------------


def _rows(mesh, a):
    """This rank's rows over ``data`` of a global batch array."""
    n = a.shape[0] // mesh.size("data")
    return torch.from_numpy(a[mesh.index("data") * n:(mesh.index("data") + 1) * n].copy())


def _ssm_case(z, case, tp):
    from repro_torch import interop
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    cfg = ModelConfig(**ssm_kw(case))
    mesh = make_host_mesh(model_axis=tp, device="cpu")
    m = Model(cfg, mesh=mesh)
    params = interop.shard_params(unflat(z, f"{case}{tp}/param/"), m, mesh)
    toks, nxt = tokens(cfg.vocab_size)
    logits, cache = m.make_prefill()(params, torch.from_numpy(toks), max_len=S + 1)
    dl, _ = m.make_decode_step()(params, cache, torch.from_numpy(nxt), S)
    bt = {k: torch.from_numpy(v) for k, v in batches(cfg.vocab_size, 1)[0].items()}
    params.requires_grad_(True)
    loss, _ = m.loss_fn(params, bt)
    loss.backward()
    grads = m.apply_grad_fixups({n: p.grad for n, p in params.named_parameters()})
    return {"prefill": logits.numpy(), "decode": dl.numpy(), "loss": float(loss.detach()),
            "grads": flat(interop.gather_params(grads, m)),
            "heads": params.layers[0].ssm.A_log.shape[0], "moved": dict(mesh.moved_bytes)}


def _fsdp_case(z, case):
    from repro_torch import interop
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_model_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, constant_schedule

    cfg = ModelConfig(**fsdp_kw(case))
    mesh = make_model_mesh(FSDP_CASES[case][1], ("data", "model"), device="cpu")
    m = Model(cfg, mesh=mesh)
    params = interop.shard_params(unflat(z, f"{case}/param/"), m, mesh)
    stored = sum(p.numel() for p in params.parameters())
    bts = [{k: _rows(mesh, v) for k, v in b.items()}
           for b in batches(cfg.vocab_size, FSDP_STEPS, FB, FS)]
    opt = AdamW(constant_schedule(FSDP_LR))
    state = m.train_state_of(params, opt)
    loss, met, grads = m._grads(state.params, bts[0])
    grads = m.apply_grad_fixups(grads)
    out = {"loss0": float(loss), "nll0": float(met["nll"].detach()),
           "grads": flat(interop.gather_params(grads, m)),
           "moved0": dict(mesh.moved_bytes), "stored": stored}
    step, _ = m.make_train_step(opt)
    nlls = []
    for b in bts:
        state, met = step(state, b)
        nlls.append(float(met["nll"] if "nll" in met else met["loss"]))
    out["nlls"] = nlls
    out["final"] = flat(interop.gather_params(state.params, m))
    return out


def _save_case(port_dir):
    """The port's sharded ``train`` on (2, 1) for 3 steps, a checkpoint
    after step 2; returns the gathered state it saved."""
    from repro_torch import interop
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import Model

    mesh = make_host_mesh(model_axis=1, device="cpu")
    res = ttrain.train("qwen2-1.5b", mesh=mesh, steps=3, ckpt_dir=port_dir, ckpt_every=2,
                       **CKPT_KW)
    m = Model(reduced(get_arch("qwen2-1.5b")), mesh=mesh)
    return flat(interop.train_state_tree(res["state"], m))


def _resume_case(jax_dir):
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh

    res = ttrain.train("qwen2-1.5b", mesh=make_host_mesh(model_axis=1, device="cpu"), steps=8,
                       ckpt_dir=jax_dir, ckpt_every=100, **CKPT_KW)
    return {"losses": list(res["losses"]), "steps": res["steps_run"]}


def _live_step():
    """One reduced qwen2 training step on this rank of a (2, 2) mesh with
    FSDP: the mesh's payload bytes over the step and a ``FlopCounterMode``
    count of it."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.mesh import make_model_mesh

    mesh = make_model_mesh((2, 2), ("data", "model"), device="cpu")
    step, state, batch = dry_live_step(mesh)
    before = dict(mesh.moved_bytes)
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    return {"moved": {k: v - before.get(k, 0) for k, v in mesh.moved_bytes.items()},
            "flops": fc.get_total_flops()}


def dry_live_step(mesh):
    """(train step, state, this rank's batch rows) of reduced qwen2 on
    ``mesh``, the same on a live rank and a dry one (no draw: the counts do
    not depend on the values)."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import AdamW, constant_schedule

    m = Model(ModelConfig(**fsdp_kw("qwen22")), mesh=mesh)
    opt = AdamW(constant_schedule(FSDP_LR))
    state = m.train_state_of(m.empty_params(), opt)
    b = batches(m.cfg.vocab_size, 1, FB, FS)[0]
    batch = {k: _rows(mesh, v).to(m.device) for k, v in b.items()}
    return m.make_train_step(opt)[0], state, batch


def _rank_job(rank, k, store, path, cases, dirs):
    import torch.distributed as dist

    torch.set_num_threads(1)   # tiny shapes: one thread a rank, the worlds run side by side
    dist.init_process_group("gloo", store=store, rank=rank, world_size=k)
    with np.load(path) as zf:
        z = {key: zf[key] for key in zf.files}
    out = {}
    for case in cases:
        if case in FSDP_CASES:
            out[case] = _fsdp_case(z, case)
        elif case == "save":
            out[case] = _save_case(dirs["port"])
        elif case == "resume":
            out[case] = _resume_case(dirs["jax"])
        elif case == "live":
            out[case] = _live_step()
        else:
            out[case] = _ssm_case(z, case[:-1], int(case[-1]))
    return out


WORLDS = {2: ("mamba22", "hymba2", "qwen21", "save"),
          4: ("mamba24", "hymba4", "qwen22", "llama22", "live")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's arrays, each world's ranks' results, the resumed world, the
    directories): the JAX subprocess and the port's worlds run at the same
    time on the same saved inputs, then the port resumes JAX's
    checkpoint."""
    from repro_torch.launch.mesh import spawn_world

    d = tmp_path_factory.mktemp("layouts")
    inputs, jpath = str(d / "inputs.npz"), str(d / "jax")
    dirs = {"port": str(d / "port_ckpt"), "jax": str(d / "jax_ckpt")}
    _inputs(inputs)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    procs = {part: subprocess.Popen([sys.executable, "-c", _PROGRAM, jpath + part, REPO,
                                     inputs, dirs["jax"], part], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for part in ("ssm", "fsdp")}
    try:
        with ThreadPoolExecutor(len(WORLDS)) as pool:   # the two worlds side by side
            futs = {k: pool.submit(spawn_world, _rank_job, k, str(d),
                                   args=(inputs, cases, dirs), timeout=500)
                    for k, cases in WORLDS.items()}
            port = {k: f.result() for k, f in futs.items()}
        for proc in procs.values():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, stderr[-3000:]
            assert "JAX_LAYOUTS_OK" in stdout
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    resumed = spawn_world(_rank_job, 2, str(d), args=(inputs, ("resume",), dirs), timeout=300)
    jax_runs = {}
    for part in procs:
        with np.load(jpath + part + ".npz") as z:
            jax_runs.update({k: z[k] for k in z.files})
    return jax_runs, port, resumed, dirs


def _ranks(runs, case):
    k = next(k for k, cases in WORLDS.items() if case in cases)
    return [r[case] for r in runs[1][k]]


def _close(got, want, rel, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * scale, (what, err, scale)


def _grads_close(got, jax_runs, prefix, rel):
    want = {k[len(prefix):]: v for k, v in jax_runs.items() if k.startswith(prefix)}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        _close(g, want[name], rel, name)


# ---------------------------------------------------------------------------
# The comparisons
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mamba22", "mamba24", "hymba2", "hymba4"])
def test_ssm_tp_prefill_and_decode_match_jax(runs, case):
    jax_runs = runs[0]
    arch, heads = SSM_CASES[case[:-1]]
    tp = int(case[-1])
    for r in _ranks(runs, case):
        assert r["heads"] == -(-heads // tp)          # padded heads, split over the ranks
        _close(r["prefill"], jax_runs[case + "/prefill"], 1e-5, "prefill")
        _close(r["decode"], jax_runs[case + "/decode"], 1e-5, "decode")
        assert r["prefill"].shape == jax_runs[case + "/prefill"].shape


@pytest.mark.parametrize("case", ["mamba22", "mamba24", "hymba2", "hymba4"])
def test_ssm_tp_loss_and_grads_match_jax(runs, case):
    jax_runs = runs[0]
    for r in _ranks(runs, case):
        assert r["loss"] == pytest.approx(float(jax_runs[case + "/loss"]), rel=1e-6)
        _grads_close(r["grads"], jax_runs, case + "/grad/", 5e-5)
        assert r["moved"]["all_reduce"] > 0


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_loss_and_grads_match_jax(runs, case):
    jax_runs = runs[0]
    for r in _ranks(runs, case):
        if case.startswith("llama"):   # JAX's loss reads data shard 0's aux (Queue 3)
            assert r["nll0"] == pytest.approx(float(jax_runs[case + "/nll0"]), rel=1e-6)
        else:
            assert r["loss0"] == pytest.approx(float(jax_runs[case + "/loss0"]), rel=1e-6)
        _grads_close(r["grads"], jax_runs, case + "/grad/", 5e-5)
        # the weights were gathered over data and their gradients scattered back
        assert r["moved0"]["all_gather"] > 0 and r["moved0"]["reduce_scatter"] > 0


@pytest.mark.parametrize("case", list(FSDP_CASES))
def test_fsdp_train_steps_match_jax(runs, case):
    jax_runs = runs[0]
    ranks = _ranks(runs, case)
    dp, tp = FSDP_CASES[case][1]
    for r in ranks:
        np.testing.assert_allclose(r["nlls"], jax_runs[case + "/nlls"], rtol=1e-5)
        want = {k[len(case) + 7:]: v for k, v in jax_runs.items()
                if k.startswith(case + "/final/")}
        assert sorted(r["final"]) == sorted(want)
        for name, p in r["final"].items():
            _close(p, want[name], 2e-5, name)
    # each rank stores a block of the weights split over data, not the whole
    whole = sum(v.size for k, v in jax_runs.items() if k.startswith(case + "/final/"))
    assert ranks[0]["stored"] < whole / tp


def test_jax_sharded_checkpoint_resumes_in_port(runs):
    want = runs[0]["ckpt/losses"]
    assert len(want) == 7
    for r in (rank["resume"] for rank in runs[2]):
        assert r["steps"] == 8
        np.testing.assert_allclose(r["losses"], want[5:7], rtol=2e-3)


def test_port_sharded_checkpoint_restores_in_jax(runs):
    import jax

    from repro.checkpoint.checkpointer import Checkpointer
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.models import Model as JModel
    from repro.optim import AdamW as JAdamW
    from repro.optim import constant_schedule as jconst

    saved = _ranks(runs, "save")[0]
    jm = JModel(JModelConfig(**cfg_kw("qwen2-1.5b")))
    like = jax.eval_shape(lambda k: jm.init_train_state(k, JAdamW(jconst(1e-3))),
                          jax.random.PRNGKey(0))
    ck = Checkpointer(runs[3]["port"])
    assert ck.latest_step() == 3
    state, step = ck.restore(like=like)
    assert step == 3
    got = jax.tree.leaves(state.params) + jax.tree.leaves(state.opt.m) \
        + jax.tree.leaves(state.opt.v)
    want_tree = (unflat(saved, "0/"), unflat(saved, "1/1/"), unflat(saved, "1/2/"))
    want = [leaf for t in want_tree for leaf in jax.tree.leaves(t)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        g = np.asarray(g)
        if g.dtype.name == "bfloat16":
            g = g.view(np.uint16)
        assert g.shape == w.shape and np.array_equal(g, w)


def test_dry_rank_counts_match_live(runs):
    from repro_torch.launch import hlo_analysis
    from repro_torch.launch.mesh import dry_rank, make_model_mesh

    live = _ranks(runs, "live")[0]
    mesh = dry_rank(make_model_mesh((2, 2), ("data", "model")))
    step, state, batch = dry_live_step(mesh)
    st = hlo_analysis.count_program(step, state, batch, mesh=mesh)
    assert mesh.moved_bytes == live["moved"]
    assert {"all_gather", "reduce_scatter", "all_reduce"} <= set(mesh.moved_bytes)
    assert st.flops == live["flops"] > 0
    # JAX's convention: result bytes, an all-gather's g times its input
    ag = sum(b * g for (k, g), (_, b) in mesh.calls.items() if k == "all_gather")
    assert st.coll_bytes_alg["all-gather"] == ag
