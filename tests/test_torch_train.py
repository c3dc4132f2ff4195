"""The port's dense-LM training stack (``models/model.py``'s training half,
``models/transformer.py``'s train mode, ``interop``'s state carriers)
against the JAX package's, from JAX states carried across (the two
packages draw weights differently, so every comparison starts from JAX's
draw), on batches of ``synth_batch`` (bitwise the same tokens).

Tolerances, reduced qwen2-1.5b (2 layers, d_model 64, GQA 4/2, QKV bias):

* ``loss_fn`` in f32: the loss within rtol 1e-6, every parameter's
  gradient within 1e-5 of its tensor's largest JAX gradient (the same
  arithmetic in another summation order).  In bf16 the loss within rtol
  1e-3, and each gradient at most 1.5× as far from the f32 gradient of
  the same weights as JAX's bf16 gradient is, plus 2^-9 of that gradient's
  norm: two bf16 backward passes round their intermediates in different
  places, and the port must be as accurate as JAX, not equal to it.
* ``make_train_step`` (f32, 5 steps, each ``monitor_metric``,
  ``microbatches`` 1 and 2): loss and grad_norm within rtol 1e-5 each step,
  ``converged`` equal each step (thresholds between the series' values);
  after 5 steps every parameter entry within 2·Σ lr_t of JAX's.  Adam's
  normalised step moves an entry by ≈ lr·sign(g), so an entry whose
  gradient is ≈ 0 in both packages (rounding noise of either sign, as in
  the k bias, whose gradient softmax nearly cancels) can part by 2·lr a
  step and no more; no more than 0.1% of all entries part by over 1e-5.
* ``apply_grad_fixups`` at JAX's tp = 4 plan, remat policies, the state
  carriers and cross-package checkpoints: bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs.base import ParallelConfig as JParallelConfig
from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_arch as jget_arch
from repro.core import detection as jdet
from repro.data.pipeline import DataConfig, synth_batch
from repro.models import Model as JModel
from repro.models.transformer import make_plan as jmake_plan
from repro.optim import AdamW as JAdamW
from repro.optim import constant_schedule as jconstant
from repro.optim import cosine_schedule as jcosine
from repro_torch import interop
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ParallelConfig
from repro_torch.models.model import Model
from repro_torch.models.transformer import make_plan
from repro_torch.optim import AdamW, constant_schedule, cosine_schedule

ARCH = "qwen2-1.5b"
B, S = 4, 64


def _jmodel(dtype="float32", arch=ARCH):
    return JModel(jreduced(jget_arch(arch), dtype=dtype))


def _port(jm, **kw):
    return Model(interop.model_config_from(jm.cfg), device="cpu", **kw)


def _batches(cfg, n, batch=B, seq=S):
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size)
    return [synth_batch(dc, i, batch, seq) for i in range(n)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _named(tree, m):
    """A JAX parameter-shaped tree as ``{port name: tensor}``."""
    return dict(interop.params_from(jax.tree.map(np.asarray, tree), m).named_parameters())


def _grads(m, params, batch, **kw):
    params.zero_grad(set_to_none=True)
    loss, _ = m.loss_fn(params, _tb(batch), **kw)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone()
                                  for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq_chunk", [512, 16])
def test_f32_loss_and_grads_match_jax(seq_chunk):
    jm = _jmodel()
    jp = jm.init(jax.random.PRNGKey(0))
    m = _port(jm)
    params = interop.params_from(jax.tree.map(np.asarray, jp), m).requires_grad_(True)
    (batch,) = _batches(jm.cfg, 1)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True),
                          static_argnums=2)(jp, _jb(batch), seq_chunk)
    loss, grads = _grads(m, params, batch, seq_chunk=seq_chunk)
    assert loss == pytest.approx(float(jl), rel=1e-6)
    want = _named(jg, m)
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        w = want[name]
        assert g.dtype == w.dtype == torch.float32
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (name, err)


def test_bf16_grads_are_as_accurate_as_jax():
    jm = _jmodel("bfloat16")
    jp = jm.init(jax.random.PRNGKey(0))
    jm32 = _jmodel("float32")
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    m, m32 = _port(jm), _port(jm32)
    params = interop.params_from(jax.tree.map(np.asarray, jp), m).requires_grad_(True)
    (batch,) = _batches(jm.cfg, 1)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss_fn, has_aux=True))(jp, _jb(batch))
    jg32 = jax.jit(jax.grad(lambda p: jm32.loss_fn(p, _jb(batch))[0]))(jp32)
    loss, grads = _grads(m, params, batch)
    assert loss == pytest.approx(float(jl), rel=1e-3)
    want, ref = _named(jg, m), _named(jg32, m32)
    for name, g in grads.items():
        assert g.dtype == torch.bfloat16
        r = ref[name]
        port_err = float(torch.linalg.vector_norm(g.float() - r))
        jax_err = float(torch.linalg.vector_norm(want[name].float() - r))
        assert port_err <= 1.5 * jax_err + 2.0 ** -9 * float(torch.linalg.vector_norm(r)), \
            (name, port_err, jax_err)


def test_loss_fn_refuses_a_chunk_that_does_not_divide_the_sequence():
    jm = _jmodel()
    m = _port(jm)
    params = m.init(torch.Generator().manual_seed(0))
    (batch,) = _batches(jm.cfg, 1)
    with pytest.raises(ValueError, match="seq_chunk"):
        m.loss_fn(params, _tb(batch), seq_chunk=24)


@pytest.mark.parametrize("remat", ["save_mixer", "none"])
def test_remat_policies_give_bitwise_the_same_loss_and_grads(remat):
    jm = _jmodel()
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    (batch,) = _batches(jm.cfg, 1)
    base = _port(jm)
    other = _port(jm, parallel=ParallelConfig(remat=remat))
    l0, g0 = _grads(base, interop.params_from(jp, base).requires_grad_(True), batch)
    l1, g1 = _grads(other, interop.params_from(jp, other).requires_grad_(True), batch)
    assert base.parallel.remat == "block" and l0 == l1
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_unknown_remat_is_refused():
    jm = _jmodel()
    (batch,) = _batches(jm.cfg, 1)
    m = _port(jm, parallel=ParallelConfig(remat="everything"))
    params = m.init(torch.Generator().manual_seed(0)).requires_grad_(True)
    with pytest.raises(ValueError, match="remat"):
        m.loss_fn(params, _tb(batch))


def test_pairs_attention_save_mixer_train_step_matches_jax():
    """``tests/test_perf_variants.py``'s combination, ``attn_impl="pairs"``
    with ``remat="save_mixer"`` and 2 microbatches: one f32 step from a
    carried state, loss and grad_norm within rtol 1e-5 of JAX's."""
    par = ParallelConfig(attn_impl="pairs", remat="save_mixer")
    jm = JModel(jreduced(jget_arch(ARCH), dtype="float32"),
                parallel=JParallelConfig(attn_impl="pairs", remat="save_mixer"))
    m = _port(jm, parallel=par)
    jopt, topt = JAdamW(jconstant(1e-3)), AdamW(constant_schedule(1e-3))
    js = jm.init_train_state(jax.random.PRNGKey(0), jopt)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    (batch,) = _batches(jm.cfg, 1, batch=2, seq=64)
    js, jmet = jax.jit(jm.make_train_step(jopt, microbatches=2)[0])(js, _jb(batch))
    ts, tmet = m.make_train_step(topt, microbatches=2)[0](ts, _tb(batch))
    assert m._ctx("train").attn_impl == "pairs"
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)


# ---------------------------------------------------------------------------
# Gradient fix-ups
# ---------------------------------------------------------------------------


def test_grad_fixups_match_jax_at_tp4():
    """JAX's ``tests/test_models.py`` plan: kv 2 < tp 4, so each kv group
    has 2 replicas; random gradients through both packages' fix-ups."""
    jm = JModel(jreduced(jget_arch(ARCH), dtype="float32", num_heads=4, num_kv_heads=2,
                         head_dim=16))
    jm.plan = jmake_plan(jm.cfg, tp=4)
    assert jm.plan.attn.kv_repl == 2
    m = _port(jm)
    m.plan = make_plan(m.cfg, tp=4)
    rng = np.random.default_rng(3)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = _named(jm.apply_grad_fixups(jax.tree.map(jnp.asarray, grads)), m)
    got = m.apply_grad_fixups(_named(grads, m))
    assert sorted(got) == sorted(want)
    for name in got:
        assert torch.equal(got[name], want[name].to(got[name].dtype)), name
    ap = m.plan.attn
    wk = got["layers.0.attn.wk"].reshape(-1, ap.groups, ap.kv_repl, ap.head_dim)
    assert torch.equal(wk[:, :, 0], wk[:, :, 1])                # replicas tied
    assert not got["embed"][m.cfg.vocab_size:].any()           # padded vocab rows


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

# per monitor metric, the threshold (K = 1, margin 1) that JAX's series
# crosses inside the 5 steps, far from every value of the series
THRESHOLDS = {"loss": 5.0, "update_norm": 0.6, "grad_norm": 2.8}
STEPS = 5


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("metric", list(THRESHOLDS))
def test_train_step_matches_jax(metric, microbatches):
    jm = _jmodel()
    m = _port(jm)
    # launch/train.py's optimizer at steps = 5
    jopt, topt = JAdamW(jcosine(3e-3, 1, STEPS)), AdamW(cosine_schedule(3e-3, 1, STEPS))
    jmon = jdet.for_mode("pfait", eps_tilde=THRESHOLDS[metric], margin=1.0, staleness=1,
                         persistence=4, ord=1.0)
    js = jm.init_train_state(jax.random.PRNGKey(0), jopt, monitor=jmon)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    jstep, _ = jm.make_train_step(jopt, monitor=jmon, microbatches=microbatches,
                                  monitor_metric=metric)
    jstep = jax.jit(jstep)
    tstep, tmon = m.make_train_step(topt, monitor=interop.monitor_from(jmon),
                                    microbatches=microbatches, monitor_metric=metric)
    assert tmon == interop.monitor_from(jmon)
    fired = []
    for batch in _batches(jm.cfg, STEPS):
        js, jmet = jstep(js, _jb(batch))
        ts, tmet = tstep(ts, _tb(batch))
        for k in ("loss", "grad_norm", "converged"):
            assert tmet[k].shape == () and tmet[k].device.type == "cpu"
        assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
        assert bool(tmet["converged"]) == bool(jmet["converged"])
        fired.append(bool(tmet["converged"]))
    assert not fired[0] and fired[-1]   # the threshold is crossed inside the run
    assert int(ts.step) == int(js.step) == STEPS and int(ts.opt.step) == STEPS
    lr = jcosine(3e-3, 1, STEPS)
    bar = 2 * sum(float(lr(jnp.int32(t))) for t in range(1, STEPS + 1))
    want = _named(js.params, m)
    apart = total = 0
    for name, p in ts.params.named_parameters():
        d = (p.detach() - want[name]).abs()
        assert float(d.max()) <= bar, (name, float(d.max()), bar)
        apart, total = apart + int((d > 1e-5).sum()), total + d.numel()
    assert apart <= 1e-3 * total, (apart, total)


def test_microbatched_train_step_matches_plain():
    """JAX's ``tests/test_models.py`` contract, on the port alone, in the
    config's bf16: the loss of 2 microbatches within rtol 1e-3 of one
    batch's, parameters within 3e-2."""
    jm = _jmodel("bfloat16")
    m = _port(jm)
    opt = AdamW(constant_schedule(1e-3))
    (batch,) = _batches(jm.cfg, 1, batch=2, seq=32)
    out = []
    for mb in (1, 2):
        ts = m.init_train_state(torch.Generator().manual_seed(0), opt)
        step, _ = m.make_train_step(opt, microbatches=mb)
        ts, met = step(ts, _tb(batch))
        out.append((float(met["loss"]), [p.detach().float() for p in ts.params.parameters()]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-3)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=3e-2, rtol=0)


@pytest.mark.parametrize("arch", ["starcoder2-3b", "deepseek-7b", "qwen2.5-32b"])
def test_dense_arch_train_step_matches_jax(arch):
    """The other dense archs (GELU MLP, MHA, no bias): one f32 step from a
    carried state; loss and grad_norm within rtol 1e-5, no NaN."""
    jm = _jmodel(arch=arch)
    m = _port(jm)
    jopt, topt = JAdamW(jconstant(1e-3)), AdamW(constant_schedule(1e-3))
    js = jm.init_train_state(jax.random.PRNGKey(0), jopt)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    (batch,) = _batches(jm.cfg, 1, batch=2, seq=32)
    js, jmet = jax.jit(jm.make_train_step(jopt)[0])(js, _jb(batch))
    ts, tmet = m.make_train_step(topt)[0](ts, _tb(batch))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
    assert float(tmet["grad_norm"]) > 0
    assert all(bool(torch.isfinite(p).all()) for p in ts.params.parameters())


# ---------------------------------------------------------------------------
# State carriers and checkpoints across the packages
# ---------------------------------------------------------------------------


def _trained_jax_state(dtype="float32", steps=3):
    """A JAX state with non-zero moments and a primed monitor ring."""
    jm = _jmodel(dtype)
    opt = JAdamW(jconstant(1e-3))
    mon = jdet.for_mode("pfait", eps_tilde=3.8, staleness=2, persistence=4, ord=1.0)
    js = jm.init_train_state(jax.random.PRNGKey(0), opt, monitor=mon)
    step = jax.jit(jm.make_train_step(opt, monitor=mon)[0])
    for batch in _batches(jm.cfg, steps, batch=2, seq=32):
        js, _ = step(js, _jb(batch))
    return jm, js


def _np_leaf(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).cpu().numpy()
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_same_leaves(got, want):
    g = jax.tree.leaves(got, is_leaf=lambda x: isinstance(x, torch.Tensor))
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a, b = _np_leaf(a), _np_leaf(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_to_tree_inverts_params_from(dtype):
    jm, js = _trained_jax_state(dtype, steps=1)
    m = _port(jm)
    tree = jax.tree.map(np.asarray, js.params)
    back = interop.params_to_tree(interop.params_from(tree, m))
    assert jax.tree.structure(jax.tree.map(lambda _: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tree))
    _assert_same_leaves(back, tree)
    # a {name: tensor} dict of the parameter names: the moments' layout
    _assert_same_leaves(interop.params_to_tree(_named(js.opt.m, m)), js.opt.m)


def test_train_state_from_carries_every_leaf():
    jm, js = _trained_jax_state()
    m = _port(jm)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    assert all(p.requires_grad for p in ts.params.parameters())
    assert bool(torch.isfinite(ts.monitor.ring).all())
    _assert_same_leaves(interop.train_state_tree(ts), js)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jm, js = _trained_jax_state()
    m = _port(jm)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    Checkpointer(str(tmp_path)).save(interop.train_state_tree(ts), 7, blocking=True)
    restored, step = JCheckpointer(str(tmp_path)).restore(like=js)
    assert step == 7 and type(restored).__name__ == "TrainState"
    _assert_same_leaves(restored, js)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jm, js = _trained_jax_state()
    m = _port(jm)
    JCheckpointer(str(tmp_path)).save(js, 9, blocking=True)
    like = interop.train_state_tree(interop.train_state_from(jax.tree.map(np.asarray, js), m))
    tree, step = Checkpointer(str(tmp_path)).restore(like=like, device="cpu")
    ts = interop.train_state_from(tree, m)
    assert step == 9
    _assert_same_leaves(interop.train_state_tree(ts), js)
    # and the restored state trains on: the same step as JAX's from there
    opt = JAdamW(jconstant(1e-3))
    mon = jdet.for_mode("pfait", eps_tilde=3.8, staleness=2, persistence=4, ord=1.0)
    (batch,) = _batches(jm.cfg, 1, batch=2, seq=32)
    _, jmet = jax.jit(jm.make_train_step(opt, monitor=mon)[0])(js, _jb(batch))
    _, tmet = m.make_train_step(AdamW(constant_schedule(1e-3)),
                                monitor=interop.monitor_from(mon))[0](ts, _tb(batch))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert bool(tmet["converged"]) == bool(jmet["converged"])


def test_model_reads_its_parallel_config():
    jm = _jmodel()
    par = dataclasses.replace(ParallelConfig(), monitor_mode="nfais2", monitor_staleness=3,
                              remat="save_mixer")
    m = _port(jm, parallel=par)
    ctx = m._ctx("train")
    assert ctx.remat == "save_mixer" and ctx.attn_impl == "blocked" and not ctx.use_kernel
    _, mon = m.make_train_step(AdamW(constant_schedule(1e-3)))
    assert (mon.mode, mon.staleness, mon.eps, mon.ord) == ("nfais2", 3, 1e-2, 1.0)
    ts = m.init_train_state(torch.Generator().manual_seed(0), AdamW(constant_schedule(1e-3)))
    assert ts.monitor.ring.shape == (4,) and int(ts.step) == 0
    with pytest.raises(ValueError, match="monitor_metric"):
        m.make_train_step(AdamW(constant_schedule(1e-3)), monitor_metric="accuracy")
