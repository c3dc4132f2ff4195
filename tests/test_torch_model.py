"""The port's dense model stack against the JAX package's, with the JAX
parameters carried across by ``interop.params_from``.

Reduced qwen2-1.5b (GQA, QKV bias, SwiGLU), starcoder2-3b (GQA, GELU MLP,
no bias) and deepseek-7b (MHA), each in f32 and in bf16: the prefill's
last-position logits and KV cache, teacher-forced decode steps, and
decode-matches-full-forward.  ``Model.init`` gives the JAX tree's shapes
and dtypes with the JAX initialisers' scales.  The other families are
``tests/test_torch_families.py``.

Tolerances: f32 logits and caches 1e-5 (atol and rtol; the same arithmetic
in another summation order); bf16 max|Δ| ≤ 2e-2 × max|JAX| per tensor (a
bf16 rounding that lands on the other side in one input element moves
every product that reads it by up to 2^-8 of the largest term, and the
logits inherit a few such roundings of the residual stream); decode vs full
forward atol 5e-2, rtol 1e-2, the JAX contract of ``tests/test_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jreduced
from repro.configs.registry import get_arch as jget_arch
from repro.models import Model as JModel
from repro.models import layers as jL
from repro.models.transformer import forward as jforward
from repro.models.transformer import init_params as jinit_params
from repro.models.transformer import make_plan as jmake_plan
from repro_torch import interop
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_arch
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL
from repro_torch.models.model import Model
from repro_torch.models.transformer import Transformer, forward, make_plan

ARCHS = ("qwen2-1.5b", "starcoder2-3b", "deepseek-7b")
DTYPES = ("float32", "bfloat16")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, S = 2, 33


def _models(arch, dtype):
    jcfg = jreduced(jget_arch(arch), dtype=dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = Model(interop.model_config_from(jcfg), device="cpu")
    return jm, jp, m, interop.params_from(jax.tree.map(np.asarray, jp), m)


def _tokens(cfg, n=S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _close(t, j, tol):
    got, want = t.float().numpy(), np.asarray(j, np.float32)
    if tol < 1e-3:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= tol * scale, f"max|Δ| {err:.3e} > {tol} × {scale:.3e}"


def _extend(cache, n):
    """The JAX server's cache padding (``serve.py``'s ``extend``)."""
    return tuple({"kv": {k: jnp.pad(v, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
                         for k, v in e["kv"].items()}} for e in cache)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    jm, jp, m, tp = _models(arch, dtype)
    toks = _tokens(m.cfg)
    jl, jc = jax.jit(jm.make_prefill())(jp, jnp.asarray(toks))
    tl, tc = m.make_prefill()(tp, torch.as_tensor(toks))
    assert tl.shape == (B, 1, m.plan.vocab_padded) and tl.dtype == torch.float32
    _close(tl, jl, TOL[dtype])
    assert len(tc) == m.cfg.num_layers
    for i, layer in enumerate(tc):
        assert sorted(layer) == ["kv"]
        for name in ("k", "v"):
            assert layer["kv"][name].dtype == tL.dtype_of(dtype)
            _close(layer["kv"][name], jc[0]["kv"][name][i], TOL[dtype])
    # with room for decoding: the same entries, zeros after them
    _, tc2 = m.make_prefill()(tp, torch.as_tensor(toks), max_len=S + 5)
    for a, b in zip(tc, tc2):
        assert b["kv"]["k"].shape[1] == S + 5
        assert torch.equal(b["kv"]["k"][:, :S], a["kv"]["k"]) and not b["kv"]["v"][:, S:].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch, dtype):
    jm, jp, m, tp = _models(arch, dtype)
    n_new, S0 = 4, S - 4
    toks = _tokens(m.cfg)
    _, jc = jax.jit(jm.make_prefill())(jp, jnp.asarray(toks[:, :S0]))
    jc = _extend(jc, n_new)
    _, tc = m.make_prefill()(tp, torch.as_tensor(toks[:, :S0]), max_len=S0 + n_new)
    jdec, tdec = jax.jit(jm.make_decode_step()), m.make_decode_step()
    for i in range(n_new):
        step = toks[:, S0 + i:S0 + i + 1]
        jl, jc = jdec(jp, jc, jnp.asarray(step), jnp.int32(S0 + i))
        tl, tc = tdec(tp, tc, torch.as_tensor(step), S0 + i)
        _close(tl, jl, TOL[dtype])
    for i, layer in enumerate(tc):
        _close(layer["kv"]["k"], jc[0]["kv"]["k"][i], TOL[dtype])
        _close(layer["kv"]["v"], jc[0]["kv"]["v"][i], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch, dtype):
    """The JAX contract (``tests/test_models.py``): the last position's
    logits of a forward pass over S tokens equal a prefill over S − 1 tokens
    plus one decode step; and the port's full forward is JAX's."""
    jm, jp, m, tp = _models(arch, dtype)
    toks = _tokens(m.cfg, seed=2)
    with torch.inference_mode():
        x, head, _, _ = forward(tp, torch.as_tensor(toks), m.plan, m._ctx("train"))
        full = tL.lm_head(x, head)
    jx, jhead, _, _ = jforward(jp, jnp.asarray(toks), jm.plan, jm._ctx("train"))
    _close(full, jL.lm_head(jx, jhead), TOL[dtype])
    _, cache = m.make_prefill()(tp, torch.as_tensor(toks[:, :S - 1]), max_len=S + 3)
    dl, _ = m.make_decode_step()(tp, cache, torch.as_tensor(toks[:, S - 1:]), S - 1)
    np.testing.assert_allclose(dl[:, 0].numpy(), full[:, -1].numpy(), atol=5e-2, rtol=1e-2)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree_and_scales(arch, tp):
    cfg = reduced(get_arch(arch))
    jtree = jinit_params(jax.random.PRNGKey(0), jmake_plan(jreduced(jget_arch(arch)), tp))
    plan = make_plan(cfg, tp)
    params = Transformer(plan).init_(torch.Generator().manual_seed(0))
    for name in ("embed", "lm_head", "final_norm"):
        t, j = getattr(params, name), jtree[name]
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"
    (unit,) = jtree["layers"]
    assert len(params.layers) == cfg.num_layers
    for blk in params.layers:
        for pname, t in blk.named_parameters():
            leaf = unit
            for part in pname.split("."):
                leaf = leaf[part]
            assert tuple(t.shape) == leaf.shape[1:], pname
            assert str(t.dtype) == f"torch.{leaf.dtype}", pname
    ap = plan.attn
    qmask = tattn.q_valid_mask(ap)
    D, H = cfg.d_model, ap.head_dim
    for blk in params.layers:
        a = blk.attn
        wo = a.wo.float()
        assert not wo[qmask == 0].any()                       # padded heads' rows
        assert abs(float(wo[qmask == 1].std()) * np.sqrt(cfg.num_heads * H) - 1) < 0.1
        assert abs(float(a.wq.float().std()) * np.sqrt(D) - 1) < 0.1
        wk = a.wk.float().reshape(D, ap.groups, ap.kv_repl, H)
        assert torch.equal(wk, wk[:, :, :1].expand_as(wk))   # kv replicas tied
        for b in (a.bq, a.bk, a.bv):
            assert b is None or not b.any()
        assert torch.equal(blk.ln1, torch.ones_like(blk.ln1))
        assert abs(float(blk.mlp.w2.float().std()) * np.sqrt(cfg.d_ff) - 1) < 0.1
    assert abs(float(params.embed.float().std()) / 0.02 - 1) < 0.1


def test_params_from_refuses_a_tree_of_another_shape():
    jm, jp, m, _ = _models("qwen2-1.5b", "float32")
    tree = jax.tree.map(np.asarray, jp)
    unit = dict(tree["layers"][0])
    del unit["ln2"]
    with pytest.raises(ValueError, match="JAX leaves"):
        interop.params_from(dict(tree, layers=(unit,)), m)
