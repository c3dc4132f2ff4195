"""The port's model configurations against the JAX package's: every
registered architecture, and its ``reduced`` form, equal field by field
with equal derived properties (exact: these are pure data)."""
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
