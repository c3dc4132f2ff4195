"""The port's attention and layers against the JAX package's, on the same
numpy inputs made from a seed.

The flash kernel's plain version (``flash_attention_ref``, flat layout) and
the model-layout dispatcher on the CPU (``ops.flash_attention`` → the
blocked ``attention_fwd``) are held to the JAX oracles; Pallas interpret
mode is not used (jax 0.9.0 has no ``pl.load``).  A CUDA tensor must launch
the kernel and never reach the plain version (a fake card checks the
dispatch here; ``test_torch_cuda.py`` runs the kernel on the card).

Tolerances: f32 2e-5 (atol and rtol; summation order, as
``tests/test_kernels.py:83``), bf16 3e-2 (one bf16 rounding of an O(1)
output); exact where both sides run the same formula on the same bits
(masks, plans).
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jflash_ops
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref
from repro.models import attention as jattn
from repro.models import layers as jL
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import flash_attention as tfk
from repro_torch.kernels.flash_attention import ops as tflash_ops
from repro_torch.kernels.flash_attention.ref import bf16_output_bar
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tflash_ref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tL

F32, BF16 = np.float32, "bfloat16"
TOL = {F32: 2e-5, BF16: 3e-2}
JDT = {F32: jnp.float32, BF16: jnp.bfloat16}
TDT = {F32: torch.float32, BF16: torch.bfloat16}

# tests/test_kernels.py FLASH_CASES, plus a ragged S = 200 GQA P = 6 case
FLASH_CASES = [
    # (BH, BN, Sq, H, causal, window, dtype)
    (8, 4, 256, 64, True, 0, F32),
    (4, 4, 256, 128, False, 0, F32),
    (6, 2, 384, 64, True, 128, F32),
    (4, 2, 128, 64, True, 64, F32),
    (4, 2, 256, 64, True, 0, BF16),
    (12, 2, 200, 32, True, 0, F32),
]


def _pair(arr, dt):
    """The same values as a JAX array and a tensor of dtype ``dt`` (bf16 is
    rounded once, by JAX, and carried bit for bit)."""
    j = jnp.asarray(arr, JDT[dt])
    t = torch.from_numpy(np.array(j, np.float32)).to(TDT[dt])
    return j, t


def _close(t, j, dt, tol=None):
    tol = TOL[dt] if tol is None else tol
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("BH,BN,Sq,H,causal,window,dt", FLASH_CASES)
def test_flash_ref_matches_jax(BH, BN, Sq, H, causal, window, dt):
    rng = np.random.default_rng(0)
    jq, tq = _pair(rng.standard_normal((BH, Sq, H)), dt)
    jk, tk = _pair(rng.standard_normal((BN, Sq, H)), dt)
    jv, tv = _pair(rng.standard_normal((BN, Sq, H)), dt)
    want = jflash_ref(jq, jk, jv, causal=causal, window=window)
    got = tflash_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == TDT[dt] and got.shape == (BH, Sq, H)
    _close(got, want, dt)
    # on the CPU the kernel's wrapper is its plain version
    assert torch.equal(tfk.flash_attention_flat(tq, tk, tv, causal=causal, window=window), got)


def _tensor_core_arithmetic(q, k, v, causal, window, block=128):
    """The bf16 kernel's arithmetic in plain PyTorch: 128-row q and kv
    tiles over the causal / window band, f32 scores scaled in f32 into
    log2 units, NEG_INF masking, f32 (m, l, acc) with exp2, l summed from
    the f32 p, p rounded to bf16 for the P·V product, the output rounded
    once to bf16."""
    BH, Sq, H = q.shape
    BN, Skv, _ = k.shape
    scale = np.float32(np.log2(np.e) / np.sqrt(H))
    out = torch.empty_like(q)
    n_kv = -(-Skv // block)
    for bh in range(BH):
        kf, vf = k[bh // (BH // BN)].float(), v[bh // (BH // BN)].float()
        for q0 in range(0, Sq, block):
            qf = q[bh, q0:q0 + block].float()
            q_pos = torch.arange(q0, q0 + qf.shape[0])[:, None]
            hi = min((q0 + block - 1) // block + 1, n_kv) if causal else n_kv
            lo = (q0 - window + 1) // block if window > 0 and q0 - window + 1 > 0 else 0
            m = torch.full((qf.shape[0], 1), -1e30)
            l = torch.zeros((qf.shape[0], 1))
            acc = torch.zeros((qf.shape[0], H))
            for jb in range(lo, hi):
                kv = slice(jb * block, (jb + 1) * block)
                s = (qf @ kf[kv].T) * scale
                kv_pos = torch.arange(jb * block, jb * block + s.shape[1])[None, :]
                ok = torch.ones_like(s, dtype=torch.bool)
                if causal:
                    ok &= kv_pos <= q_pos
                if window > 0:
                    ok &= kv_pos > q_pos - window
                s = torch.where(ok, s, torch.tensor(-1e30))
                m_new = torch.maximum(m, s.amax(dim=1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * alpha + p.sum(dim=1, keepdim=True)
                acc = acc * alpha + p.bfloat16().float() @ vf[kv]
                m = m_new
            out[bh, q0:q0 + block] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out


@pytest.mark.parametrize("BH,BN,S,H,causal,window", [
    (4, 2, 300, 32, True, 0), (4, 2, 300, 32, True, 40), (4, 2, 300, 32, False, 0),
    (6, 1, 77, 16, True, 0), (2, 2, 260, 64, True, 0),
])
def test_tensor_core_arithmetic_stays_under_the_derived_bf16_bar(BH, BN, S, H, causal, window):
    """The element-wise bar ``bf16_output_bar`` (the one ``chip_smoke.py``
    and the card tests hold the bf16 kernel to) admits the rounding of p to
    bf16 that the tensor-core kernel makes, measured against the JAX plain
    version, and still fails an output that drops a kv tile."""
    rng = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal((n, S, H)), BF16)
                                    for n in (BH, BN, BN))
    want = torch.from_numpy(np.array(jflash_ref(jq, jk, jv, causal=causal, window=window),
                                     np.float32)).bfloat16()
    bar = bf16_output_bar(want, tq, tk, tv, causal=causal, window=window)
    # its spread term is the plain version applied to |v|
    spread = (bar - 2.0 ** -7 * (want.double().abs() + want.double().square().mean().sqrt()))
    jspread = jflash_ref(jq.astype(jnp.float32), jk.astype(jnp.float32),
                         jnp.abs(jv.astype(jnp.float32)), causal=causal, window=window)
    np.testing.assert_allclose((2.0 ** 8 * spread).numpy(), np.asarray(jspread), rtol=2e-5,
                               atol=2e-6)
    got = _tensor_core_arithmetic(tq, tk, tv, causal, window)
    share = float(((got.double() - want.double()).abs() / bar).max())
    assert got.dtype == torch.bfloat16 and 0.0 < share <= 1.0
    if causal and window == 0:
        dropped = tflash_ref(tq, tk, tv, causal=True, window=S - 64)
        assert float(((dropped.double() - want.double()).abs() / bar).max()) > 1.0


# (B, S, N, P, H, causal, window, dtype) on the model's grouped layout
MODEL_CASES = [
    (2, 128, 2, 3, 32, True, 0, F32),
    (1, 200, 2, 6, 16, True, 64, F32),
    (2, 96, 1, 4, 16, False, 0, F32),
    (2, 1100, 1, 2, 16, True, 0, F32),     # two kv blocks of 1024, the last ragged
    (2, 64, 2, 2, 32, True, 0, BF16),
]


def _qkv(B, S, N, P, H, dt, seed=1, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (_pair(rng.standard_normal((B, S, N, P, H)), dt),
            _pair(rng.standard_normal((B, Skv, N, H)), dt),
            _pair(rng.standard_normal((B, Skv, N, H)), dt))


@pytest.mark.parametrize("B,S,N,P,H,causal,window,dt", MODEL_CASES)
def test_flash_ops_on_cpu_matches_jax_attention_fwd(B, S, N, P, H, causal, window, dt):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, S, N, P, H, dt)
    # the JAX dispatcher off the TPU runs attention_fwd: the same numbers
    want = jflash_ops.flash_attention(jq, jk, jv, causal=causal, window=window)
    got = tflash_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (B, S, N, P, H) and got.dtype == TDT[dt]
    _close(got, want, dt)
    _close(tattn.attention_fwd(tq, tk, tv, causal=causal, window=window),
           jattn.attention_fwd(jq, jk, jv, causal=causal, window=window), dt)


@pytest.mark.parametrize("Sq,Skv,q_offset,block_kv,window,causal", [
    (5, 37, 32, 16, 0, True),
    (8, 40, 32, 7, 12, True),
    (16, 16, 0, 4, 0, False),
    (3, 50, 47, 64, 5, True),
])
def test_attention_fwd_with_q_offset_matches_jax(Sq, Skv, q_offset, block_kv, window, causal):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, Sq, 2, 3, 16, F32, seed=2, Skv=Skv)
    kw = dict(causal=causal, window=window, block_kv=block_kv, q_offset=q_offset)
    _close(tattn.attention_fwd(tq, tk, tv, **kw), jattn.attention_fwd(jq, jk, jv, **kw), F32)
    kw.pop("block_kv")
    _close(tattn.mha_reference(tq, tk, tv, **kw), jattn.mha_reference(jq, jk, jv, **kw), F32)


@pytest.mark.parametrize("window", [0, 48])
def test_attention_fwd_pairs_matches_jax(window):
    """``tests/test_perf_variants.py``'s case: the block-skipping pairs
    softmax against JAX's and against the blocked ``attention_fwd``; then
    its gradients against JAX's pairs gradients."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 128, 2, 3, 32, F32, seed=5)
    kw = dict(causal=True, window=window, block_q=32, block_kv=32)
    got = tattn.attention_fwd_pairs(tq, tk, tv, **kw)
    _close(got, jattn.attention_fwd_pairs(jq, jk, jv, **kw), F32)
    _close(got, jattn.attention_fwd(jq, jk, jv, causal=True, window=window, block_kv=32), F32)
    ct = np.random.default_rng(6).standard_normal(tuple(got.shape)).astype(np.float32)
    jg = jax.grad(lambda q, k, v: jnp.sum(jattn.attention_fwd_pairs(q, k, v, **kw) * ct),
                  argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (tattn.attention_fwd_pairs(*leaves, **kw) * torch.from_numpy(ct)).sum().backward()
    for t, j in zip(leaves, jg):
        _close(t.grad, j, F32)


def test_attention_fwd_pairs_refuses_blocks_that_do_not_divide():
    (_, tq), (_, tk), (_, tv) = _qkv(1, 48, 1, 1, 16, F32)
    with pytest.raises(ValueError, match="must divide"):
        tattn.attention_fwd_pairs(tq, tk, tv, block_q=32, block_kv=32)


@pytest.mark.parametrize("ring,window,per_seq", [
    (False, 0, False), (False, 6, False), (True, 0, False), (False, 4, True), (True, 0, True),
])
def test_decode_attention_matches_jax(ring, window, per_seq):
    B, Sc = 3, 20
    (jq, tq), (jk, tk), (jv, tv) = _qkv(B, 1, 2, 2, 16, F32, seed=3, Skv=Sc)
    for cl in ([5, 20, 27] if per_seq else [1, 9, 20, 33]):
        jcl = jnp.asarray(cl, jnp.int32)
        want = jattn.decode_attention(jq, jk, jv, jcl, window=window, ring=ring)
        got = tattn.decode_attention(tq, tk, tv, torch.as_tensor(cl), window=window, ring=ring)
        _close(got, want, F32)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(4)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(tL.rope_freqs(16, theta).numpy(),
                                   np.asarray(jL.rope_freqs(16, theta)), rtol=1e-6)
        for dt in (F32, BF16):
            jx, tx = _pair(rng.standard_normal((2, 3, 40, 16)), dt)
            pos = np.arange(7, 47)
            got = tL.apply_rope(tx, torch.as_tensor(pos), theta)
            assert got.dtype == TDT[dt]
            # f32: angles up to 46 rad, sin/cos of two libraries
            _close(got, jL.apply_rope(jx, jnp.asarray(pos), theta), dt,
                   tol=1e-5 if dt == F32 else None)
    for dt in (F32, BF16):
        jx, tx = _pair(3.0 * rng.standard_normal((4, 5, 64)), dt)
        js, ts = _pair(1.0 + 0.1 * rng.standard_normal(64), dt)
        got = tL.rmsnorm(tx, ts, 1e-5)
        assert got.dtype == TDT[dt]
        _close(got, jL.rmsnorm(jx, js, 1e-5), dt)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dt", [F32, BF16])
def test_mlp_apply_matches_jax(gated, dt):
    d, f = 64, 128
    p = jL.mlp_init(jax.random.PRNGKey(0), d, f, gated, JDT[dt])
    mlp = tL.MLP(d, f, gated, TDT[dt])
    with torch.no_grad():
        for name, w in p.items():
            getattr(mlp, name).copy_(torch.from_numpy(np.asarray(w, np.float32)))
    jx, tx = _pair(np.random.default_rng(5).standard_normal((2, 7, d)), dt)
    _close(tL.mlp_apply(mlp, tx, gated), jL.mlp_apply(p, jx, gated), dt)


def test_embed_and_lm_head_match_jax():
    rng = np.random.default_rng(6)
    jemb, temb = _pair(rng.standard_normal((32, 16)), BF16)
    toks = rng.integers(0, 32, (2, 5))
    assert torch.equal(tL.embed_lookup(temb, torch.as_tensor(toks)).float(),
                       torch.from_numpy(np.asarray(jL.embed_lookup(jemb, jnp.asarray(toks)),
                                                   np.float32)))
    jx, tx = _pair(rng.standard_normal((2, 5, 16)), BF16)
    got = tL.lm_head(tx, temb)
    assert got.dtype == torch.float32
    _close(got, jL.lm_head(jx, jemb), F32)


@pytest.mark.parametrize("heads,kv,hd,tp", [
    (12, 2, 128, 1), (12, 2, 128, 16), (40, 8, 128, 16), (25, 5, 64, 16), (24, 24, 64, 16),
    (32, 32, 128, 4), (4, 1, 16, 1), (48, 8, 128, 3),
])
def test_plan_and_q_mask_match_jax(heads, kv, hd, tp):
    tp_plan = tattn.plan_attention(heads, kv, hd, tp)
    jp_plan = jattn.plan_attention(heads, kv, hd, tp)
    assert tp_plan.__dict__ == jp_plan.__dict__
    for h in range(heads):
        assert tp_plan.q_slot_pos(h) == jp_plan.q_slot_pos(h)
    for s in range(tp_plan.slots):
        assert tp_plan.kv_slot_group(s) == jp_plan.kv_slot_group(s)
    np.testing.assert_array_equal(tattn.q_valid_mask(tp_plan).numpy(),
                                  np.asarray(jattn.q_valid_mask(jp_plan)))


def test_plan_refuses_heads_not_a_multiple_of_kv_heads():
    for plan in (tattn.plan_attention, jattn.plan_attention):
        with pytest.raises(ValueError, match="multiple of num_kv_heads"):
            plan(7, 2, 16, 1)


def _attn_pair(d, plan, bias, dt, seed=0):
    p = jattn.attn_init(jax.random.PRNGKey(seed), d, plan, bias, JDT[dt])
    if bias:   # non-zero biases, so their broadcast is checked
        rng = np.random.default_rng(seed)
        p = dict(p, **{b: jnp.asarray(0.1 * rng.standard_normal(p[b].shape), JDT[dt])
                       for b in ("bq", "bk", "bv")})
    tplan = tattn.plan_attention(plan.num_heads, plan.num_kv_heads, plan.head_dim, plan.tp)
    mod = tattn.Attention(d, tplan, bias, TDT[dt])
    with torch.no_grad():
        for name, w in p.items():
            getattr(mod, name).copy_(torch.from_numpy(np.asarray(w, np.float32)))
    return p, mod, tplan


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("bias,window", [(True, 0), (False, 8)])
def test_attn_apply_prefill_matches_jax(use_kernel, bias, window):
    d, S = 64, 24
    plan = jattn.plan_attention(4, 2, 16, 1)
    p, mod, tplan = _attn_pair(d, plan, bias, F32)
    jx, tx = _pair(np.random.default_rng(7).standard_normal((2, S, d)), F32)
    pos = np.arange(S)
    jy, (jk, jv) = jattn.attn_apply(p, jx, plan, 1e4, jnp.asarray(pos), window=window,
                                    block_kv=16)
    ty, (tk, tv) = tattn.attn_apply(mod, tx, tplan, 1e4, torch.as_tensor(pos), window=window,
                                    block_kv=16, use_kernel=use_kernel)
    _close(ty, jy, F32)
    _close(tk, jk, F32)
    _close(tv, jv, F32)


@pytest.mark.parametrize("ring", [False, True])
def test_attn_apply_decode_writes_cache_and_matches_jax(ring):
    d, Sc, B = 64, 12, 2
    plan = jattn.plan_attention(4, 2, 16, 1)
    p, mod, tplan = _attn_pair(d, plan, True, F32, seed=1)
    rng = np.random.default_rng(8)
    jkc, tkc = _pair(rng.standard_normal((B, Sc, 2, 16)), F32)
    jvc, tvc = _pair(rng.standard_normal((B, Sc, 2, 16)), F32)
    for cache_len in (3, Sc - 1, Sc + 4):
        jx, tx = _pair(rng.standard_normal((B, 1, d)), F32)
        jy, (jk2, jv2) = jattn.attn_apply(
            p, jx, plan, 1e4, jnp.asarray([cache_len]), cache=(jkc, jvc),
            cache_len=jnp.int32(cache_len), ring=ring)
        tk2, tv2 = tkc.clone(), tvc.clone()
        ty, (tk3, tv3) = tattn.attn_apply(
            mod, tx, tplan, 1e4, torch.as_tensor([cache_len]), cache=(tk2, tv2),
            cache_len=cache_len, ring=ring)
        assert tk3 is tk2 and tv3 is tv2     # written in place
        _close(ty, jy, F32)
        _close(tk2, jk2, F32)
        _close(tv2, jv2, F32)
        jkc, jvc, tkc, tvc = jk2, jv2, tk2, tv2


# ---------------------------------------------------------------------------
# dispatch: a CUDA tensor launches the kernel, never the plain version
# ---------------------------------------------------------------------------


class _FakeLib:
    def __init__(self):
        self.calls, self.rc = [], 0

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return self.rc
        return fn


def _forbidden(*a, **k):
    raise AssertionError("the plain version ran on a CUDA tensor")


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "on_cuda", lambda *t: True)
    monkeypatch.setattr(_build, "load", lambda name, sigs: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(tfk, "flash_attention_ref", _forbidden)
    monkeypatch.setattr(tattn, "attention_fwd", _forbidden)
    tfk.reset_launches()
    yield lib
    tfk.reset_launches()


def test_cuda_tensors_launch_the_flash_kernel_never_plain(fake_card):
    B, S, N, P, H = 2, 40, 2, 3, 32
    q = torch.randn(B, S, N, P, H, dtype=torch.bfloat16)
    k = torch.randn(B, S, N, H, dtype=torch.bfloat16)
    out = tflash_ops.flash_attention(q, k, k.clone(), causal=True, window=16)
    assert out.shape == (B, S, N, P, H)
    (name, args), = fake_card.calls
    # (q, k, v, o, BH, BN, Sq, Skv, H, causal, window, stream)
    assert name == "flash_attention_bf16" and args[4:11] == (12, 4, 40, 40, 32, 1, 16)
    kf = torch.randn(2, 24, 16)
    tfk.flash_attention_flat(torch.randn(4, 30, 16), kf, kf, causal=False)
    assert fake_card.calls[1][0] == "flash_attention_f32"
    assert fake_card.calls[1][1][4:11] == (4, 2, 30, 24, 16, 0, 0)
    assert tfk.LAUNCHES == {"flash_attention_flat": 2}
    assert tfk.LAUNCH_SHAPES == {(12, 4, 40, 40, 32, True, 16, "bf16"): 1,
                                 (4, 2, 30, 24, 16, False, 0, "f32"): 1}


def test_flash_kernel_refuses_misaligned_inputs(fake_card):
    """TMA and the 16-byte loads need each operand on a 16-byte boundary."""
    k = torch.randn(2, 16, 32, dtype=torch.bfloat16)
    q = torch.randn(6 * 16 * 32 + 1, dtype=torch.bfloat16)[1:].view(6, 16, 32)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        tfk.flash_attention_flat(q, k, k)
    assert fake_card.calls == [] and tfk.LAUNCHES["flash_attention_flat"] == 0


def test_flash_kernel_bad_inputs_and_launch_errors_raise(fake_card):
    q = torch.randn(6, 16, 32)
    k = torch.randn(2, 16, 32)
    with pytest.raises(ValueError, match="head dim"):
        tfk.flash_attention_flat(torch.randn(6, 16, 24), torch.randn(2, 16, 24),
                                 torch.randn(2, 16, 24))
    with pytest.raises(ValueError, match="multiple of BN"):
        tfk.flash_attention_flat(torch.randn(5, 16, 32), k, k)
    with pytest.raises(TypeError, match="f32/bf16"):
        tfk.flash_attention_flat(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="contiguous"):
        tfk.flash_attention_flat(q.transpose(0, 1).contiguous().transpose(0, 1), k, k)
    fake_card.rc = 700
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        tfk.flash_attention_flat(q, k, k)
    assert tfk.LAUNCHES["flash_attention_flat"] == 0 and not tfk.LAUNCH_SHAPES
