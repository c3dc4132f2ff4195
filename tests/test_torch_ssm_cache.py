"""The SSM cache a prefill returns owns exactly its own bytes.

``models/ssm.py:causal_conv`` hands back the W − 1 tail rows of the padded
conv input as the next call's state.  JAX's slice is a copy; a view would
keep each layer's whole [B, S + W − 1, C] input alive inside the cache
(and count it in the dry run's ``output_bytes``).

* After a reduced mamba2-130m and hymba-1.5b prefill (B = 1 and 2, S =
  256), every ``SSMCache`` leaf's storage holds exactly its ``nbytes``, and
  the conv tails equal JAX's ``causal_conv`` state on the same inputs.
* On a dry (2, 2) rank, a prefill's ``output_bytes`` are the sum of its
  outputs' bytes (logits and every cache leaf).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import dry_rank, make_model_mesh
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model

ARCHS = ("mamba2-130m", "hymba-1.5b")


def _leaves(tree, out):
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    return out


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_leaves_own_their_bytes(arch, B):
    cfg = reduced(get_arch(arch))
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(B)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 256)).astype(np.int64))
    _, cache = m.make_prefill()(params, tokens)
    caches = [e["ssm"] for e in cache]
    assert len(caches) == cfg.num_layers and all(c is not None for c in caches)
    for c in caches:
        for name, t in c._asdict().items():
            assert t.untyped_storage().nbytes() == t.nbytes, (name, tuple(t.shape))


def test_conv_tail_is_jax_state_and_a_copy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 40, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    y, state = tssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w))
    jy, jstate = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    assert state.shape == (1, 3, 24) and state.untyped_storage().nbytes() == state.nbytes


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_prefill_output_bytes_are_its_outputs(arch, monkeypatch):
    shape = ShapeConfig("prefill_32k", 256, 2, "prefill")
    monkeypatch.setattr(dryrun, "get_arch", lambda a: reduced(get_arch(a)))
    monkeypatch.setattr(dryrun, "get_shape", lambda s: shape)
    mesh = dry_rank(make_model_mesh((2, 2), ("data", "model")))
    rec = dryrun.lower_cell(arch, "prefill_32k", False, mesh=mesh)

    model = Model(reduced(get_arch(arch)), mesh=mesh)
    fn, args, _ = dryrun.build_cell(model, shape)
    out = hlo_analysis.trace_program(fn, *args, mesh=mesh).out
    leaves = _leaves(out, [])
    assert any(t.dim() == 3 and t.shape[1] == 3 for t in leaves)   # the conv tails
    assert rec["memory"]["output_bytes"] == sum(t.nbytes for t in leaves)
