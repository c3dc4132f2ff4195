"""The port's single-device MoE (``models/moe.py``,
``transformer.moe_local_reference`` / ``_local_aux``) against the JAX
package's, on numpy-seeded f32 inputs and the JAX weights carried across.

Tolerances: the plan's virtual-expert arithmetic exactly; the routed output
and the aux loss 1e-5 (atol and rtol; the same f32 arithmetic in another
summation order); the virtual split of an expert against the unsplit
expert 1e-5 (the partial down-projections sum).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import moe as jmoe
from repro.models.transformer import _local_aux as jlocal_aux
from repro.models.transformer import moe_local_reference as jmoe_local
from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import _local_aux, moe_local_reference

# (E, top-k, shared expert): grok-1's 8 experts top-2, llama4's 128 top-1
# with a shared expert, at reduced widths
STYLES = {"grok": (8, 2, False), "llama4": (128, 1, True)}
# the plan's fields, then its derived virtual-expert arithmetic
PLAN_FIELDS = ("num_experts", "top_k", "tp", "d_model", "d_ff",
               "virt_per_expert", "virtual_experts", "d_ff_virtual")


def _cfgs(E, k, shared=False, d=32, f=64):
    kw = dict(name="t", family="moe", num_layers=2, d_model=d, vocab_size=128,
              num_heads=4, num_kv_heads=2, d_ff=f, num_experts=E, experts_per_token=k,
              shared_expert=shared)
    return JModelConfig(**kw), ModelConfig(**kw)


@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("style", list(STYLES))
def test_plan_matches_jax(style, tp):
    E, k, shared = STYLES[style]
    jcfg, cfg = _cfgs(E, k, shared)
    jplan, plan = jmoe.plan_moe(jcfg, tp), tmoe.plan_moe(cfg, tp)
    for f in PLAN_FIELDS:
        assert getattr(plan, f) == getattr(jplan, f), f
    if style == "grok" and tp == 16:   # E < tp: each expert split in two
        assert (plan.virt_per_expert, plan.virtual_experts, plan.d_ff_virtual) == (2, 16, 32)


@pytest.mark.parametrize("tp,E", [(16, 5), (6, 4)])
def test_plan_refuses_what_jax_refuses(tp, E):
    jcfg, cfg = _cfgs(E, 1)
    with pytest.raises(ValueError) as jerr:
        jmoe.plan_moe(jcfg, tp)
    with pytest.raises(ValueError, match=str(jerr.value)):
        tmoe.plan_moe(cfg, tp)


def _weights(plan_j, plan_t, gated, dtype=torch.float32):
    jw = jmoe.moe_init(jax.random.PRNGKey(0), plan_j, gated, jnp.float32)
    w = tmoe.MoE(plan_t, gated, dtype)
    with torch.no_grad():
        for name, t in w.named_parameters():
            t.copy_(torch.from_numpy(np.array(jw[name])))
    return jw, w


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("tp", [1, 16])
@pytest.mark.parametrize("style", list(STYLES))
def test_local_reference_and_aux_match_jax(style, tp, gated):
    """The dense one-hot MoE at tp 1 and at JAX's production tp = 16
    layout (grok's experts split into 2 virtual experts), gated (SwiGLU)
    and GELU."""
    E, k, shared = STYLES[style]
    jcfg, cfg = _cfgs(E, k, shared)
    jplan, plan = jmoe.plan_moe(jcfg, tp), tmoe.plan_moe(cfg, tp)
    jw, w = _weights(jplan, plan, gated)
    x = np.random.default_rng(7).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    y, aux = moe_local_reference(torch.from_numpy(x), w, plan, gated)
    jy, jaux = jmoe_local(jnp.asarray(x), jw, jplan, gated)
    assert y.shape == (2, 8, cfg.d_model) and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    # _local_aux alone, on the same routing
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, cfg.d_model) @ w.router, dim=-1)
    topi = torch.topk(probs, plan.top_k, dim=-1).indices
    want = jlocal_aux(jnp.asarray(probs.numpy()), jnp.asarray(topi.numpy()), jplan)
    assert float(_local_aux(probs, topi, plan)) == pytest.approx(float(want), rel=1e-6)


def test_virtual_split_is_exact():
    """Grok at tp = 16: the same logical experts as one slice each (tp 1)
    and as two virtual slices along d_ff give the same output."""
    E, k, _ = STYLES["grok"]
    _, cfg = _cfgs(E, k)
    p1, p16 = tmoe.plan_moe(cfg, 1), tmoe.plan_moe(cfg, 16)
    w1 = tmoe.MoE(p1, True, torch.float32).init_(torch.Generator().manual_seed(0))
    w16 = tmoe.MoE(p16, True, torch.float32)
    r, Fv = p16.virt_per_expert, p16.d_ff_virtual
    with torch.no_grad():
        w16.router.copy_(w1.router)
        for e in range(E):
            for v in range(r):
                sl = slice(v * Fv, (v + 1) * Fv)
                w16.w1[e * r + v].copy_(w1.w1[e][:, sl])
                w16.w3[e * r + v].copy_(w1.w3[e][:, sl])
                w16.w2[e * r + v].copy_(w1.w2[e][sl])
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 8, cfg.d_model))
                         .astype(np.float32))
    y1, a1 = moe_local_reference(x, w1, p1, True)
    y16, a16 = moe_local_reference(x, w16, p16, True)
    torch.testing.assert_close(y16, y1, atol=1e-5, rtol=1e-5)
    assert float(a16) == float(a1)


def test_init_matches_jax_shapes_and_scales():
    """``MoE.init_`` against ``moe_init``: shapes and dtypes (bf16
    experts, f32 router) and the draws' scales."""
    E, k, _ = STYLES["llama4"]
    jcfg, cfg = _cfgs(E, k, d=64, f=128)
    jplan, plan = jmoe.plan_moe(jcfg, 1), tmoe.plan_moe(cfg, 1)
    jw = jmoe.moe_init(jax.random.PRNGKey(0), jplan, True, jnp.bfloat16)
    w = tmoe.MoE(plan, True, torch.bfloat16).init_(torch.Generator().manual_seed(0))
    for name, t in w.named_parameters():
        assert tuple(t.shape) == jw[name].shape and str(t.dtype) == f"torch.{jw[name].dtype}"
    for t, s in ((w.router, 64), (w.w1, 64), (w.w3, 64), (w.w2, 128)):
        assert abs(float(t.float().std()) * np.sqrt(s) - 1) < 0.05
