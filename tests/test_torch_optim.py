"""The port's optimizer, gradient compression and data pipeline against
the JAX package's (``optim/adamw.py``, ``optim/grad_compression.py``,
``data/pipeline.py``), on the same inputs made from a seed with numpy.

* ``synth_batch``: bitwise JAX's tokens, labels and frontend embeddings;
  the ``Prefetcher`` behaviours of ``tests/test_train_loop.py:128-182`` and
  ``tests/test_substrate.py:26-47``; ``device_batches`` on the CPU.
* AdamW: three steps of the port's ``update`` against JAX's on the same
  tree, f32 / bf16 parameters and moments, with and without clipping.
  Tolerances: f32 results rtol 2e-6 (the clip scale, ``b ** step`` and the
  global norm's summation may differ by an f32 unit); bf16 results within
  one bf16 unit of JAX's (2^-8 relative), since an f32 unit of difference
  can round a value to the neighbouring bf16 number.  The schedules within
  rtol 1e-6 plus 1e-7 of the peak (where 1 + cos cancels at the end); the
  AdamW contracts of JAX's tests.
* int8 compression: ``quantize_int8``, ``dequantize_int8`` and
  ``ef_compress`` bitwise (``torch.round`` and ``jnp.round`` both round
  half to even); ``compressed_psum`` / ``compressed_tree_psum`` over the
  stacked transport and over a gloo world of 2 ranks against JAX's over 2
  forced host devices (one subprocess), within 2^-22 of the dequantised
  terms |q·s| (the mean: of their sum over the shards / 2): JAX's
  compiled program contracts ``q·s + t`` into one FMA (XLA on the CPU),
  where the port rounds the product first, so the two part by one
  rounding of a product.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import AdamW as JAdamW
from repro.optim import constant_schedule as jconstant
from repro.optim import cosine_schedule as jcosine
from repro.optim import grad_compression as jgc
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as tpipe
from repro_torch.optim import AdamW, apply_updates, constant_schedule, cosine_schedule
from repro_torch.optim import grad_compression as tgc
from repro_torch.runtime.transport import StackedTransport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_UNIT = 2.0 ** -8


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name, what
    g, w = got.float().numpy(), want.astype(np.float32)
    if got.dtype == torch.bfloat16:
        np.testing.assert_allclose(g, w, rtol=BF16_UNIT, atol=0, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-30, err_msg=what)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,batch,seq,vocab,frontend,shard", [
    (0, 0, 3, 16, 128, 0, 0),
    (7, 3, 4, 16, 1000, 0, 0),
    (1, 41, 4, 64, 256, 0, 2),
    (0, 0, 4, 32, 64, 8, 0),
    (5, 12, 2, 4096, 151936, 0, 0),
])
def test_synth_batch_is_bitwise_jax(seed, step, batch, seq, vocab, frontend, shard):
    jc = jpipe.DataConfig(seed=seed, vocab_size=vocab, frontend_dim=frontend)
    tc = tpipe.DataConfig(seed=seed, vocab_size=vocab, frontend_dim=frontend)
    want = jpipe.synth_batch(jc, step, batch, seq, shard)
    got = tpipe.synth_batch(tc, step, batch, seq, shard)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_data_determinism_and_stream_independence():
    dc = tpipe.DataConfig(seed=7, vocab_size=1000)
    a = tpipe.synth_batch(dc, step=3, batch=4, seq=16)
    b = tpipe.synth_batch(dc, step=3, batch=4, seq=16)
    c = tpipe.synth_batch(dc, step=4, batch=4, seq=16)
    np.testing.assert_array_equal(a["inputs"], b["inputs"])
    assert not np.array_equal(a["inputs"], c["inputs"])
    assert a["inputs"].max() < 1000
    np.testing.assert_array_equal(a["labels"][:, :-1], a["inputs"][:, 1:])
    assert (a["labels"][:, -1] == -1).all() and a["labels"].dtype == np.int32


def test_prefetcher_orders_steps_and_resumes():
    pf = tpipe.Prefetcher(lambda s: {"step": s}, start_step=5)
    steps = [next(pf)[0] for _ in range(4)]
    pf.close()
    assert steps == [5, 6, 7, 8]


def test_prefetcher_stops_iteration_after_close():
    pf = tpipe.Prefetcher(lambda step: step * 10, depth=2)
    step, item = next(pf)
    assert item == step * 10
    pf.close()
    with pytest.raises(StopIteration):
        for _ in range(8):   # drain whatever was buffered, then stop
            next(pf)


def test_prefetcher_surfaces_producer_death():
    def boom(step):
        if step >= 2:
            raise RuntimeError("synthetic producer failure")
        return step

    pf = tpipe.Prefetcher(boom, depth=1)
    with pytest.raises(RuntimeError, match="producer") as exc_info:
        for _ in range(8):
            next(pf)
    assert "synthetic producer failure" in str(exc_info.value.__cause__)
    pf.close()


def test_prefetcher_is_deterministic_and_ordered():
    pf = tpipe.Prefetcher(lambda step: step * step, start_step=5, depth=2)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert got == [(5, 25), (6, 36), (7, 49), (8, 64)]


def test_device_batches_on_the_cpu_are_synth_batch():
    cfg = reduced(get_arch("qwen2-1.5b"))
    shape = ShapeConfig("custom", seq_len=32, global_batch=2, kind="train")
    data = tpipe.device_batches(cfg, shape, device="cpu", seed=3, start_step=4)
    try:
        for want_step in (4, 5):
            step, batch = next(data)
            assert step == want_step
            want = jpipe.synth_batch(jpipe.DataConfig(seed=3, vocab_size=cfg.vocab_size),
                                     step, 2, 32)
            for k in want:
                assert batch[k].device.type == "cpu" and batch[k].dtype == torch.int32
                np.testing.assert_array_equal(batch[k].numpy(), want[k])
    finally:
        data.close()


def test_device_batches_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shape = ShapeConfig("custom", seq_len=8, global_batch=1, kind="train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpipe.device_batches(reduced(get_arch("qwen2-1.5b")), shape)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(rng, dtype):
    shapes = {"w": (4, 3), "b": (3,), "nest": [{"k": (2, 2, 2)}, {"z": (5,)}]}

    def draw(s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32).astype(dtype)

    return {"w": draw(shapes["w"]), "b": draw(shapes["b"]),
            "nest": [{"k": draw((2, 2, 2))}, {"z": draw((5,))}]}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(_t, tree)


def _leaves_close(got_tree, want_tree, what):
    got = jax.tree.leaves(got_tree, is_leaf=lambda x: isinstance(x, torch.Tensor))
    want = jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, what)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.01, 100.0])   # under / over the clip norm
@pytest.mark.parametrize("sched", ["constant", "cosine"])
def test_adamw_update_matches_jax(pdtype, moment_dtype, grad_scale, sched):
    np_dtype = ml_dtypes.bfloat16 if pdtype == "bfloat16" else np.float32
    rng = np.random.default_rng(0)
    params = _tree(rng, np_dtype)
    if sched == "constant":
        jopt = JAdamW(jconstant(1e-2), moment_dtype=moment_dtype)
        topt = AdamW(constant_schedule(1e-2), moment_dtype=moment_dtype)
    else:
        jopt = JAdamW(jcosine(1e-2, 2, 10), moment_dtype=moment_dtype)
        topt = AdamW(cosine_schedule(1e-2, 2, 10), moment_dtype=moment_dtype)
    jp, tp = _jtree(params), _ttree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * grad_scale)
                             .astype(np.float32).astype(a.dtype), params)
        ju, js, jn = jopt.update(_jtree(grads), js, jp)
        tu, ts, tn = topt.update(_ttree(grads), ts, tp)
        assert (float(jn) > 1.0) == (grad_scale > 1.0)   # the clip is (in)active
        _close(tn, jn, "gnorm")
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        _leaves_close(tu, ju, "updates")
        _leaves_close(ts.m, js.m, "m")
        _leaves_close(ts.v, js.v, "v")
        # carry JAX's state forward on both sides, so each step is held alone
        jp = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        tp = _ttree(jax.tree.map(np.asarray, jp))
        ts = ts._replace(m=_ttree(jax.tree.map(np.asarray, js.m)),
                         v=_ttree(jax.tree.map(np.asarray, js.v)))


def test_apply_updates_adds_in_place_in_the_parameter_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    ids = {k: id(v) for k, v in p.items()}
    out = apply_updates(p, {"w": torch.full((3,), 0.5, dtype=torch.bfloat16),
                            "b": torch.full((2,), 0.25)})
    assert out is p and {k: id(v) for k, v in p.items()} == ids
    assert p["w"].dtype == torch.bfloat16 and torch.equal(p["w"], torch.full((3,), 1.5,
                                                                              dtype=torch.bfloat16))
    assert torch.equal(p["b"], torch.full((2,), 0.25))


@pytest.mark.parametrize("peak,warmup,total,floor", [(1.0, 10, 100, 0.1), (3e-3, 1, 5, 0.1),
                                                     (3e-3, 7, 150, 0.0)])
def test_schedules_match_jax(peak, warmup, total, floor):
    steps = np.arange(0, total + 5, dtype=np.int32)
    want = np.asarray(jax.vmap(jcosine(peak, warmup, total, floor))(jnp.asarray(steps)))
    got = cosine_schedule(peak, warmup, total, floor)(torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32
    # near the end 1 + cos(π·frac) cancels: hold it to f32 units of the peak
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7 * peak)
    c = constant_schedule(0.125)(torch.tensor(3, dtype=torch.int32))
    assert c.dtype == torch.float32 and float(c) == float(jconstant(0.125)(jnp.int32(3)))


def test_cosine_schedule_shape():
    lr = cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(torch.tensor(0))) == pytest.approx(0.0)
    assert float(lr(torch.tensor(10))) == pytest.approx(1.0, rel=1e-2)
    assert float(lr(torch.tensor(100))) == pytest.approx(0.1, rel=1e-2)


def test_adamw_optimizes_quadratic():
    opt = AdamW(constant_schedule(0.1), weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = opt.init(params)
    for _ in range(200):
        upd, st, _ = opt.update({"w": 2 * params["w"]}, st, params)
        apply_updates(params, upd)
    assert float(params["w"].abs().max()) < 0.1


def test_adamw_update_returns_triple_with_bf16_moments():
    opt = AdamW(constant_schedule(1e-2), moment_dtype="bfloat16")
    params = {"w": torch.ones((4, 3)), "b": torch.zeros((3,), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16 and state.v["b"].dtype == torch.bfloat16
    grads = {k: torch.full(p.shape, 0.5, dtype=p.dtype) for k, p in params.items()}
    updates, new_state, gnorm = opt.update(grads, state, params)
    for k in params:
        assert updates[k].shape == params[k].shape and updates[k].dtype == params[k].dtype
        assert new_state.m[k].dtype == torch.bfloat16
        assert new_state.v[k].dtype == torch.bfloat16
    assert gnorm.shape == () and gnorm.dtype == torch.float32
    assert int(new_state.step) == 1 and float(gnorm) > 0


def test_adamw_bf16_moments_accumulate_in_f32():
    """Moment math happens in f32 then casts back: repeated identical grads
    drive m toward g without bf16 stagnation."""
    opt = AdamW(constant_schedule(1e-2), b1=0.5, moment_dtype="bfloat16", clip_norm=1e9)
    params = {"w": torch.ones(8)}
    state = opt.init(params)
    g = {"w": torch.full((8,), 0.125)}
    for _ in range(20):
        _, state, _ = opt.update(g, state, params)
    np.testing.assert_allclose(state.m["w"].float().numpy(), 0.125, rtol=0.02)


def test_adamw_grad_clipping_reports_the_pre_clip_norm():
    opt = AdamW(constant_schedule(0.1), clip_norm=1.0, moment_dtype="bfloat16")
    params = {"w": torch.ones(3, dtype=torch.bfloat16)}
    st = opt.init(params)
    assert st.m["w"].dtype == torch.bfloat16
    upd, _, gnorm = opt.update({"w": torch.full((3,), 100.0)}, st, params)
    assert float(gnorm) == pytest.approx(100.0 * np.sqrt(3), rel=1e-6)
    # clipped: Adam's first step is lr · sign(g) (+ weight decay), not 100×
    assert float(upd["w"].float().abs().max()) < 0.2


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------


def _grad(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    if len(shape) > 1 and shape[0] > 1:
        x[0] = 0.0                      # an all-zero row: scale floors at 1e-12
        x.reshape(shape[0], -1)[-1, :2] = [127.0 * 0.5, -127.0 * 1.5]   # ties
    return x


@pytest.mark.parametrize("shape", [(8, 64), (5,), (3, 4, 6), (1, 3)])
def test_quantize_and_ef_compress_are_bitwise_jax(shape):
    rng = np.random.default_rng(len(shape))
    x = _grad(rng, shape)
    err = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tgc.dequantize_int8(q, s, shape).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js, shape)))
    got = tgc.ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    want = jgc.ef_compress(jnp.asarray(x), jnp.asarray(err))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ef = tgc.ef_init({"a": torch.from_numpy(x), "b": [torch.zeros(2, dtype=torch.bfloat16)]})
    assert ef["a"].dtype == torch.float32 and not ef["a"].any() and ef["b"][0].shape == (2,)


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32))
    q, s = tgc.quantize_int8(x)
    err = (tgc.dequantize_int8(q, s, x.shape) - x).abs()
    assert bool((err <= s * 0.5 + 1e-6).all())


PSUM_SHAPES = ((6, 16), (7,), (2, 3, 4))


def _psum_inputs(p=2):
    """Per shard: a gradient leaf of each of ``PSUM_SHAPES`` and its error
    state, f32."""
    rng = np.random.default_rng(11)
    g = [[_grad(rng, s) * (1 + r) for s in PSUM_SHAPES] for r in range(p)]
    e = [[(rng.standard_normal(s) * 1e-2).astype(np.float32) for s in PSUM_SHAPES]
         for r in range(p)]
    return g, e


_PROGRAM = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, os.path.join(sys.argv[2], "tests"))
    import test_torch_optim as t
    from repro.core.compat import make_mesh_compat, shard_map_compat
    from repro.optim import grad_compression as gc

    mesh = make_mesh_compat((2,), ("pod",))
    g, e = t._psum_inputs()
    out = {}
    for j in range(len(t.PSUM_SHAPES)):
        G = jnp.stack([jnp.asarray(g[r][j]) for r in range(2)])
        E = jnp.stack([jnp.asarray(e[r][j]) for r in range(2)])
        f = shard_map_compat(lambda a, b: tuple(x[None] for x in gc.compressed_psum(a[0], b[0])),
                             mesh, (P("pod"), P("pod")), (P("pod"), P("pod")))
        mean, err = jax.jit(f)(G, E)
        out[f"mean/{j}"], out[f"err/{j}"] = np.asarray(mean), np.asarray(err)

    def tree_body(a, b):
        tree = {"x": a[0][0], "y": [a[1][0]]}
        errs = {"x": b[0][0], "y": [b[1][0]]}
        m, ne = gc.compressed_tree_psum(tree, errs)
        return (m["x"][None], m["y"][0][None]), (ne["x"][None], ne["y"][0][None])

    spec = (P("pod"), P("pod"))
    f = shard_map_compat(tree_body, mesh, (spec, spec), (spec, spec))
    args = tuple(jnp.stack([jnp.asarray(g[r][j]) for r in range(2)]) for j in (0, 2))
    eargs = tuple(jnp.stack([jnp.asarray(e[r][j]) for r in range(2)]) for j in (0, 2))
    (mx, my), (ex, ey) = jax.jit(f)(args, eargs)
    out.update({"tree/mx": np.asarray(mx), "tree/my": np.asarray(my),
                "tree/ex": np.asarray(ex), "tree/ey": np.asarray(ey)})
    np.savez(sys.argv[1], **out)
    print("JAX_PSUM_OK")
""")


@pytest.fixture(scope="module")
def jax_psum(tmp_path_factory):
    """JAX's ``compressed_psum`` over 2 forced host devices, from one
    subprocess."""
    path = tmp_path_factory.mktemp("jax_psum") / "psum.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"),
                                         env.get("PYTHONPATH", "")])
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PROGRAM, str(path), REPO], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "JAX_PSUM_OK" in out.stdout
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _port_psum(transport, shards):
    """The port's results for ``shards`` (the local ones of ``transport``)."""
    g, e = _psum_inputs()
    out = {}
    for j in range(len(PSUM_SHAPES)):
        mean, err = tgc.compressed_psum({r: torch.from_numpy(g[r][j]) for r in shards},
                                        {r: torch.from_numpy(e[r][j]) for r in shards},
                                        transport)
        for r in shards:
            out[f"mean/{j}/{r}"], out[f"err/{j}/{r}"] = mean[r].numpy(), err[r].numpy()
    trees = {r: {"x": torch.from_numpy(g[r][0]), "y": [torch.from_numpy(g[r][2])]}
             for r in shards}
    errs = {r: {"x": torch.from_numpy(e[r][0]), "y": [torch.from_numpy(e[r][2])]}
            for r in shards}
    m, ne = tgc.compressed_tree_psum(trees, errs, transport)
    for r in shards:
        out[f"tree/mx/{r}"], out[f"tree/my/{r}"] = m[r]["x"].numpy(), m[r]["y"][0].numpy()
        out[f"tree/ex/{r}"], out[f"tree/ey/{r}"] = ne[r]["x"].numpy(), ne[r]["y"][0].numpy()
    return out


def _psum_bounds():
    """Per result key, the bar of each shard's result: 2^-22 times its
    dequantised terms, |q·s| (the error state) or their sum over the
    shards / 2 (the mean)."""
    g, e = _psum_inputs()
    deq = [[tgc.dequantize_int8(*tgc.quantize_int8(torch.from_numpy(g[r][j] + e[r][j])),
                                g[r][j].shape).abs().numpy() for j in range(len(PSUM_SHAPES))]
           for r in range(2)]
    out = {}
    for j in range(len(PSUM_SHAPES)):
        out[f"mean/{j}"] = [(deq[0][j] + deq[1][j]) / 2] * 2
        out[f"err/{j}"] = [deq[0][j], deq[1][j]]
    for key, j in (("x", 0), ("y", 2)):
        out[f"tree/m{key}"], out[f"tree/e{key}"] = out[f"mean/{j}"], out[f"err/{j}"]
    return {k: [2.0 ** -22 * b for b in v] for k, v in out.items()}


def _assert_psum_matches(got, want, shards):
    """Within one rounding of a product of JAX's: XLA contracts
    ``q·s + t`` into one FMA in JAX's compiled program, where the port
    rounds the product first."""
    bounds = _psum_bounds()
    for key, arr in want.items():
        for r in shards:
            d = np.abs(got[f"{key}/{r}"].astype(np.float64) - arr[r])
            assert (d <= bounds[key][r]).all(), (key, r, float(d.max()))


def test_compressed_psum_stacked_matches_jax(jax_psum):
    got = _port_psum(StackedTransport(2, torch.device("cpu")), (0, 1))
    _assert_psum_matches(got, jax_psum, (0, 1))
    # every shard holds the same mean
    np.testing.assert_array_equal(got["mean/0/0"], got["mean/0/1"])


def _psum_rank_job(rank, k, store):
    from repro_torch.launch.mesh import make_shard_group
    from repro_torch.runtime.transport import GroupTransport

    group = make_shard_group((k,), "gloo", store=store, rank=rank, device="cpu")
    return _port_psum(GroupTransport(group), (rank,))


def test_compressed_psum_over_a_gloo_world_matches_jax(jax_psum, tmp_path):
    from repro_torch.launch.mesh import spawn_world

    ranks = spawn_world(_psum_rank_job, 2, str(tmp_path), timeout=300)
    for r, got in enumerate(ranks):
        _assert_psum_matches(got, jax_psum, (r,))
