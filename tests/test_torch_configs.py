"""The port's model configurations against the JAX package's: every
registered architecture, and its ``reduced`` form, equal field by field
with equal derived properties; the shapes, the parallel and run configs
and the registry's shape and cell lookups (exact: these are pure data)."""
import dataclasses

import pytest

from repro.configs import base as jbase
from repro.configs import registry as jreg
from repro_torch import interop
from repro_torch.configs import base as tbase
from repro_torch.configs import registry as treg

NAMES = sorted(jreg.ARCHS)
PROPERTIES = ("resolved_head_dim", "is_moe", "is_ssm", "has_ssm", "has_attention",
              "d_inner", "resolved_ssm_heads", "supports_long_context")
METHODS = ("moe_layer_mask", "num_params", "num_active_params")


def _assert_same(t, j):
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for p in PROPERTIES:
        assert getattr(t, p) == getattr(j, p), p
    for m in METHODS:
        assert getattr(t, m)() == getattr(j, m)(), m


def test_registry_holds_the_same_names():
    assert sorted(treg.ARCHS) == NAMES
    with pytest.raises(KeyError) as te:
        treg.get_arch("no-such-arch")
    with pytest.raises(KeyError) as je:
        jreg.get_arch("no-such-arch")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", NAMES)
def test_config_equals_jax(name):
    _assert_same(treg.get_arch(name), jreg.get_arch(name))


@pytest.mark.parametrize("name", NAMES)
def test_reduced_equals_jax(name):
    _assert_same(tbase.reduced(treg.get_arch(name)), jbase.reduced(jreg.get_arch(name)))
    kw = dict(dtype="float32", num_layers=3, d_model=96)
    _assert_same(tbase.reduced(treg.get_arch(name), **kw),
                 jbase.reduced(jreg.get_arch(name), **kw))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "hymba-1.5b"])
def test_model_config_from_jax(name):
    j = jbase.reduced(jreg.get_arch(name), dtype="float32")
    t = interop.model_config_from(j)
    assert isinstance(t, tbase.ModelConfig)
    _assert_same(t, j)


def test_shapes_equal_jax():
    assert list(tbase.SHAPES) == list(jbase.SHAPES)
    for t, j in zip(tbase.ALL_SHAPES, jbase.ALL_SHAPES):
        assert dataclasses.asdict(t) == dataclasses.asdict(j) and t.is_decode == j.is_decode
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.asdict(getattr(tbase, name)) == \
            dataclasses.asdict(getattr(jbase, name))
    for name in jbase.SHAPES:
        assert dataclasses.asdict(treg.get_shape(name)) == \
            dataclasses.asdict(jreg.get_shape(name))
    with pytest.raises(KeyError) as te:
        treg.get_shape("no-such-shape")
    with pytest.raises(KeyError) as je:
        jreg.get_shape("no-such-shape")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("cls", ["ParallelConfig", "RunConfig"])
def test_parallel_and_run_configs_equal_jax(cls):
    t, j = getattr(tbase, cls), getattr(jbase, cls)
    assert [(f.name, f.default) for f in dataclasses.fields(t)
            if f.default is not dataclasses.MISSING] == \
        [(f.name, f.default) for f in dataclasses.fields(j)
         if f.default is not dataclasses.MISSING]
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    if cls == "RunConfig":
        arch = "qwen2-1.5b"
        tr = t(model=treg.get_arch(arch), shape=tbase.TRAIN_4K)
        jr = j(model=jreg.get_arch(arch), shape=jbase.TRAIN_4K)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)


@pytest.mark.parametrize("include_skipped", [False, True])
def test_cells_equal_jax(include_skipped):
    got = [(a.name, s.name, ok, why) for a, s, ok, why in treg.all_cells(include_skipped)]
    want = [(a.name, s.name, ok, why) for a, s, ok, why in jreg.all_cells(include_skipped)]
    assert got == want and len(got) == (40 if include_skipped else len(want))
    for a, s, ok, why in treg.all_cells(True):
        assert treg.cell_is_runnable(a, s) == (ok, why)
