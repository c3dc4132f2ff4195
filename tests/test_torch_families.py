"""The port's moe, ssm, hybrid and frontend model families against the JAX
package's, with the JAX parameters carried across by ``interop.params_from``.

Reduced grok-1-314b (MoE top-2, every layer), llama4-maverick-400b-a17b
(MoE top-1 + shared expert on alternate layers: scan period 2), mamba2-130m
(attention-free SSD, tied embeddings), hymba-1.5b (attention ∥ SSD,
sliding window), musicgen-medium (audio frontend, GELU MLP) and
llava-next-34b (vision frontend), all in f32, on numpy-seeded inputs.

Tolerances:

* forward, prefill and decode logits and the prefill caches against JAX's:
  1e-5 (atol and rtol; the same f32 arithmetic in another summation
  order);
* prefill(S − 1) + one decode step against the full forward: atol 5e-2,
  rtol 1e-2, JAX's contract (``tests/test_models.py``);
* ``loss_fn`` (with the MoE aux loss): rtol 1e-6; each gradient within
  1e-5 of the largest JAX gradient and 1e-4 of its own tensor's largest;
* one AdamW train step from a carried JAX state: loss and grad_norm rtol
  1e-5; every parameter within 1e-5 (atol and rtol) of JAX's but at most
  0.1% of all entries and, in each tensor, one entry or 0.1% of them, each
  of them one whose gradient is rounding noise, held to 2·lr (Adam's first
  step normalises the gradient: ``test_train_step_matches_jax``);
* ``params_to_tree`` ∘ ``params_from``: bitwise, period 1 and 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_arch as jget_arch
from repro.data.pipeline import DataConfig, synth_batch
from repro.models import Model as JModel
from repro.models import layers as jL
from repro.models.transformer import forward as jforward
from repro.optim import AdamW as JAdamW
from repro.optim import constant_schedule as jconstant
from repro_torch import interop
from repro_torch.models import layers as tL
from repro_torch.models.model import Model
from repro_torch.models.transformer import forward
from repro_torch.optim import AdamW, constant_schedule

ARCHS = ("grok-1-314b", "llama4-maverick-400b-a17b", "mamba2-130m", "hymba-1.5b",
         "musicgen-medium", "llava-next-34b")
B, S = 2, 33
TOL = 1e-5


def _models(arch):
    jm = JModel(jreduced(jget_arch(arch), dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(interop.model_config_from(jm.cfg), device="cpu")
    return jm, jp, m, interop.params_from(jax.tree.map(np.asarray, jp), m)


def _inputs(cfg, n=S, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend is None:
        return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    return rng.standard_normal((B, n, cfg.frontend_dim)).astype(np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _extend(cache, n):
    """The JAX server's cache padding (``serve.py``'s ``extend``)."""
    out = []
    for entry in cache:
        e = dict(entry)
        if "kv" in e:
            e["kv"] = {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
                       for k, v in e["kv"].items()}
        out.append(e)
    return tuple(out)


def _jax_layer(jcache, i, period):
    """Layer i's entry of a JAX stacked cache."""
    return jax.tree.map(lambda a: a[i // period], jcache[i % period])


def _assert_cache_matches(tc, jc, period):
    for i, entry in enumerate(tc):
        want = _jax_layer(jc, i, period)
        assert sorted(entry) == sorted(want)
        if "kv" in entry:
            for name in ("k", "v"):
                _close(entry["kv"][name], want["kv"][name])
        if "ssm" in entry:
            for got, w in zip(entry["ssm"], want["ssm"]):
                _close(got, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_jax(arch):
    jm, jp, m, tp = _models(arch)
    inp = _inputs(m.cfg)
    with torch.inference_mode():
        x, head, _, aux = forward(tp, torch.as_tensor(inp), m.plan, m._ctx("train"))
        full = tL.lm_head(x, head)
    jx, jhead, _, jaux = jforward(jp, jnp.asarray(inp), jm.plan, jm._ctx("train"))
    assert full.shape == (B, S, m.plan.vocab_padded)
    _close(full, jL.lm_head(jx, jhead))
    _close(aux, jaux)
    jl, jc = jax.jit(jm.make_prefill())(jp, jnp.asarray(inp))
    tl, tc = m.make_prefill()(tp, torch.as_tensor(inp))
    _close(tl, jl)
    assert len(tc) == m.cfg.num_layers
    _assert_cache_matches(tc, jc, m.plan.period)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward_and_jax(arch):
    """Prefill over S − 1 positions plus one decode step: the last
    position's logits of the full forward at the JAX contract's bar, and
    JAX's own decode step at 1e-5 (its cache too)."""
    jm, jp, m, tp = _models(arch)
    inp = _inputs(m.cfg, seed=2)
    with torch.inference_mode():
        x, head, _, _ = forward(tp, torch.as_tensor(inp), m.plan, m._ctx("train"))
        full = tL.lm_head(x, head)
    _, cache = m.make_prefill()(tp, torch.as_tensor(inp[:, :S - 1]), max_len=S + 3)
    if m.plan.attn is not None:
        assert cache[0]["kv"]["k"].shape[1] == S + 3
    dl, cache = m.make_decode_step()(tp, cache, torch.as_tensor(inp[:, S - 1:]), S - 1)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, -1].numpy(), atol=5e-2, rtol=1e-2)
    _, jc = jax.jit(jm.make_prefill())(jp, jnp.asarray(inp[:, :S - 1]))
    jdl, jc = jax.jit(jm.make_decode_step())(jp, _extend(jc, 4), jnp.asarray(inp[:, S - 1:]),
                                            jnp.int32(S - 1))
    _close(dl, jdl)
    _assert_cache_matches(cache, jc, m.plan.period)


def _batch(cfg, seq=32):
    dc = DataConfig(seed=0, vocab_size=cfg.vocab_size,
                    frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
    return synth_batch(dc, 0, B, seq)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_grads(jm, jparams, batch, m):
    g = jax.jit(jax.grad(lambda p: jm.loss_fn(p, _jb(batch))[0]))(jparams)
    return dict(interop.params_from(jax.tree.map(np.asarray, g), m).named_parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The loss (with the MoE aux term) within rtol 1e-6; every gradient
    within 1e-5 of the largest JAX gradient of any parameter, and within
    1e-4 of its own tensor's largest: ``A_log`` and ``dt_bias`` sum terms
    over every position and channel of the SSD that nearly cancel (their
    gradients part by up to 1.4e-5 of their own largest, ≈ 2^-27 in
    absolute terms)."""
    jm, jp, m, tp = _models(arch)
    batch = _batch(m.cfg)
    jl, jmet = jax.jit(jm.loss_fn)(jp, _jb(batch))
    tp.requires_grad_(True)
    tl, tmet = m.loss_fn(tp, _tb(batch))
    tl.backward()
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert float(tmet["nll"]) == pytest.approx(float(jmet["nll"]), rel=1e-6)
    assert float(tmet["aux"]) == pytest.approx(float(jmet["aux"]), rel=1e-6, abs=1e-12)
    assert (float(tmet["aux"]) > 0) == m.cfg.is_moe
    want = _jax_grads(jm, jp, batch, m)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, p in tp.named_parameters():
        err = float((p.grad - want[name]).abs().max())
        assert err <= min(1e-5 * gmax, 1e-4 * float(want[name].abs().max())), (name, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """One AdamW step (lr 1e-3) from a carried JAX state.  Adam's first
    step moves an entry by lr · g / (|g| + ε): where |g| is rounding noise
    (below 1e-4 of its tensor's largest gradient) that ratio is noise too.
    Every entry is held to 1e-5 but at most 0.1% of all entries and, in
    each tensor, one entry or 0.1% of them, whichever is more; each of
    those must be such a noise entry, and is held to 2·lr."""
    jm = JModel(jreduced(jget_arch(arch), dtype="float32"))
    m = Model(interop.model_config_from(jm.cfg), device="cpu")
    lr = 1e-3
    jopt, topt = JAdamW(jconstant(lr)), AdamW(constant_schedule(lr))
    js = jm.init_train_state(jax.random.PRNGKey(0), jopt)
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    batch = _batch(m.cfg)
    grads = _jax_grads(jm, js.params, batch, m)
    js, jmet = jax.jit(jm.make_train_step(jopt)[0])(js, _jb(batch))
    ts, tmet = m.make_train_step(topt)[0](ts, _tb(batch))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
    assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
    want = dict(interop.params_from(jax.tree.map(np.asarray, js.params), m).named_parameters())
    apart_all = total = 0
    for name, p in ts.params.named_parameters():
        g, w = grads[name].abs(), want[name]
        d = (p.detach() - w).abs()
        apart = d > TOL + TOL * w.abs()
        noise = g < 1e-4 * g.max()
        assert float(d.max()) <= 2 * lr, name
        assert not bool((apart & ~noise).any()), (name, float(d[~noise].max()))
        assert int(apart.sum()) <= max(1, 1e-3 * d.numel()), (name, int(apart.sum()))
        apart_all, total = apart_all + int(apart.sum()), total + d.numel()
    assert apart_all <= 1e-3 * total, (apart_all, total)


@pytest.mark.parametrize("arch", ["mamba2-130m", "llama4-maverick-400b-a17b"])
def test_params_to_tree_inverts_params_from(arch):
    """Period 1 (mamba2) and period 2 (llama4: dense and MoE layers in
    turn): the JAX tree back, leaf for leaf, and a JAX train state through
    ``train_state_from`` and back through ``train_state_tree``."""
    jm, jp, m, tp = _models(arch)
    assert m.plan.period == (2 if m.cfg.is_moe else 1)
    tree = jax.tree.map(np.asarray, jp)
    back = interop.params_to_tree(tp)
    assert jax.tree.structure(jax.tree.map(lambda _: 0, back)) == \
        jax.tree.structure(jax.tree.map(lambda _: 0, tree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), b)
    named = dict(tp.named_parameters())
    again = interop.params_to_tree(named, m.plan.period)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(back)):
        assert torch.equal(a, b)
    # a whole train state (moments keyed by name) back in JAX's layout
    js = jm.init_train_state(jax.random.PRNGKey(0), JAdamW(jconstant(1e-3)))
    ts = interop.train_state_from(jax.tree.map(np.asarray, js), m)
    got = jax.tree.leaves(interop.train_state_tree(ts),
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = jax.tree.leaves(js)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.detach().cpu().numpy(), np.asarray(b))


@pytest.mark.parametrize("arch", ["musicgen-medium", "mamba2-130m", "llama4-maverick-400b-a17b"])
def test_launch_train_runs_the_family_and_resumes(arch, tmp_path):
    """``launch.train.train`` unchanged on a frontend batch (embeddings
    [B, S, F] in f32), an attention-free model and a period-2 model: a
    3-step run checkpointed at step 2 (its JAX-layout train state) resumes
    to 5 steps from the checkpoint, every loss finite (phase 14(b)'s
    contract)."""
    from repro_torch.launch.train import train

    kw = dict(batch=2, seq=32, use_reduced=True, log_every=1000, ckpt_dir=str(tmp_path),
              ckpt_every=2, device="cpu")
    first = train(arch, steps=3, **kw)
    resumed = train(arch, steps=5, **kw)
    assert first["steps_run"] == 3 and resumed["steps_run"] == 5
    assert len(resumed["losses"]) == 1     # steps 3 and 4 run; the host reads step 3's
    assert np.all(np.isfinite(first["losses"] + resumed["losses"]))
