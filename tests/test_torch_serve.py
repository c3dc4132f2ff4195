"""The port's serving loop against the JAX ``serve``: an f32 reduced
qwen2-1.5b registered in both registries, JAX's own seed-initialised
parameters carried across, the same prompts.  ``tokens``, ``finished``,
``steps`` and ``stopped_by`` must be equal (exact: greedy argmax over f32
logits that agree to ~1e-6, far inside the gaps between the top logits).

One case per staleness K runs at batch 1 with ``eos_id`` set to the token
JAX emitted at position 4, so the K-stale detector fires K steps after
the EOS and the drain mask rewrites the over-run tokens.  The moe, ssm,
hybrid and frontend families run the same comparison, reduced and in f32.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import reduced as jreduced
from repro.launch import serve as jserve
from repro.models import Model as JModel
from repro_torch import interop
from repro_torch.configs import registry as treg
from repro_torch.launch import serve as tserve
from repro_torch.models.model import Model

ARCH = "qwen2-1.5b-f32-test"


@pytest.fixture
def tiny_f32(monkeypatch):
    jcfg = dataclasses.replace(jreduced(jreg.get_arch("qwen2-1.5b"), dtype="float32"),
                               name=ARCH)
    monkeypatch.setitem(jreg.ARCHS, ARCH, jcfg)
    monkeypatch.setitem(treg.ARCHS, ARCH, interop.model_config_from(jcfg))
    return jcfg


def _port_run(jcfg, batch, prompt_len, max_new, seed, **kw):
    """The port's loop on JAX's parameters and JAX's prompts."""
    m = Model(treg.get_arch(ARCH), device="cpu")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(seed)))
    prompts = tserve.make_prompts(jcfg.vocab_size, batch, prompt_len, seed)
    return tserve.generate(m, interop.params_from(tree, m), prompts, max_new, **kw)


def _assert_same(got, want):
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["finished"], want["finished"])
    assert got["steps"] == want["steps"]
    assert got["stopped_by"] == want["stopped_by"]


def test_prompts_are_the_jax_draws():
    want = np.random.default_rng(7).integers(3, 500, (3, 9))
    got = tserve.make_prompts(500, 3, 9, 7)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


@pytest.mark.parametrize("batch,prompt_len,max_new,seed", [(4, 16, 12, 0), (3, 21, 9, 5)])
def test_serve_loop_matches_jax(tiny_f32, batch, prompt_len, max_new, seed):
    want = jserve.serve(ARCH, batch=batch, prompt_len=prompt_len, max_new=max_new,
                        use_reduced=False, seed=seed)
    got = _port_run(tiny_f32, batch, prompt_len, max_new, seed)
    assert got["tokens"].shape == (batch, max_new)
    _assert_same(got, want)
    assert got["wall_s"] > 0 and got["prefill_s"] > 0 and got["decode_s"] > 0


@pytest.mark.parametrize("staleness", [0, 2, 4])
def test_detector_fires_and_drains_like_jax(tiny_f32, staleness):
    kw = dict(batch=1, prompt_len=12, max_new=16, seed=3)
    first = jserve.serve(ARCH, use_reduced=False, **kw)
    eos = int(first["tokens"][0, 3])
    want = jserve.serve(ARCH, use_reduced=False, eos_id=eos, staleness=staleness, **kw)
    got = _port_run(tiny_f32, kw["batch"], kw["prompt_len"], kw["max_new"], kw["seed"],
                    eos_id=eos, staleness=staleness)
    _assert_same(got, want)
    assert got["stopped_by"] == "detector" and bool(got["finished"][0])
    # ``finished`` reads decoded tokens only (position ≥ 1; the prefill's
    # token is not checked, as in JAX), and the monitor sees the flag K
    # checks late: K steps run past the first decoded EOS (found in the
    # first run's tokens, which the drain to ``eos`` has not rewritten)
    hit = 1 + int(np.argmax(first["tokens"][0, 1:] == eos))
    assert got["steps"] == hit + staleness
    assert (got["tokens"][0, hit:] == eos).all()     # over-run drained


def test_serve_on_cpu_and_cli(capsys, monkeypatch):
    out = tserve.serve("starcoder2-3b", batch=2, prompt_len=10, max_new=5, device="cpu")
    assert out["tokens"].shape == (2, 5) and out["stopped_by"] in ("budget", "detector")
    assert out["steps"] == 4 and out["tok_per_s"] > 0
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-1.5b", "--batch", "2",
                                      "--prompt-len", "8", "--max-new", "4",
                                      "--device", "cpu"])
    tserve.main()
    assert "[serve] generated (2, 4)" in capsys.readouterr().out


FAMILIES = ("grok-1-314b", "llama4-maverick-400b-a17b", "mamba2-130m", "hymba-1.5b",
            "musicgen-medium", "llava-next-34b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_loop_matches_jax_for_every_family(monkeypatch, arch):
    """The moe, ssm, hybrid and frontend families, reduced, in f32: a
    frontend model's prompts are the JAX server's normal draws and its
    decode steps read ``one_hot(token, F)`` (tokens ≥ F a zero row)."""
    name = f"{arch}-f32-test"
    jcfg = dataclasses.replace(jreduced(jreg.get_arch(arch), dtype="float32"), name=name)
    monkeypatch.setitem(jreg.ARCHS, name, jcfg)
    monkeypatch.setitem(treg.ARCHS, name, interop.model_config_from(jcfg))
    kw = dict(batch=2, prompt_len=16, max_new=6, seed=1)
    want = jserve.serve(name, use_reduced=False, **kw)
    m = Model(treg.get_arch(name), device="cpu")
    tree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.PRNGKey(kw["seed"])))
    F = jcfg.frontend_dim if jcfg.frontend else 0
    prompts = tserve.make_prompts(jcfg.vocab_size, kw["batch"], kw["prompt_len"], kw["seed"], F)
    assert prompts.dtype == (np.float32 if F else np.int32)
    got = tserve.generate(m, interop.params_from(tree, m), prompts, kw["max_new"])
    _assert_same(got, want)
    assert got["logits_finite"]


def test_frontend_decode_input_is_jax_one_hot():
    tok = np.array([0, 5, 31, 32, 40], np.int32)
    got = tserve._decode_input(torch.as_tensor(tok), 32)
    want = jax.nn.one_hot(tok, 32, dtype=np.float32)[:, None, :]
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 1, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(tserve._decode_input(torch.as_tensor(tok), 0), torch.as_tensor(tok)[:, None])
