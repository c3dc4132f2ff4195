"""Error-feedback int8 gradient compression (port of
``optim/grad_compression.py``).

A mean over shards with int8 wire traffic: each shard quantises its
error-corrected gradient per row (symmetric, scale max|row| / 127, round
half to even as ``jnp.round``), the payloads and scales are all-gathered
and every shard sums the dequantised blocks locally — exact for
per-shard scales, no second reduction round.  The quantisation residual
is carried into the next step (error feedback).

The JAX package's ``compressed_psum`` runs inside ``shard_map`` over an
axis name; here the group is a transport of ``runtime/transport.py``
(``StackedTransport``: every shard in this process; ``GroupTransport``:
one shard per rank), whose ``all_gather`` takes the place of
``jax.lax.all_gather``.  Values are ``{shard: tensor}`` maps over the
transport's local shards, as everywhere on the transports.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten

Shards = Dict[int, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization; returns (q [r, c] i8, scale [r, 1])."""
    flat = x.reshape(x.shape[0] if x.dim() > 1 else 1, -1)
    scale = flat.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def ef_compress(g: torch.Tensor, err: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one gradient leaf.

    Returns (q, scale, new_err) with g + err == deq(q, scale) + new_err."""
    corrected = g.to(torch.float32) + err
    q, scale = quantize_int8(corrected)
    deq = dequantize_int8(q, scale, g.shape)
    return q, scale, corrected - deq


def ef_init(grads: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compressed_psum(g: Shards, err: Shards, transport) -> Tuple[Shards, Shards]:
    """Mean over the transport's shards with int8 wire traffic; returns
    (mean gradient, new error state), each a ``{shard: tensor}`` map over
    the local shards."""
    qs, scales, errs = {}, {}, {}
    for i in g:
        qs[i], scales[i], errs[i] = ef_compress(g[i], err[i])
    q_all = torch.stack(transport.all_gather(qs))         # [n, r, c] int8 wire
    s_all = torch.stack(transport.all_gather(scales))     # [n, r, 1] f32 (tiny)
    total = torch.sum(q_all.to(torch.float32) * s_all, dim=0)
    n = q_all.shape[0]
    return {i: (total / n).reshape(g[i].shape) for i in g}, errs


def compressed_tree_psum(grads: Dict[int, Any], err_state: Dict[int, Any], transport):
    """``compressed_psum`` over every leaf of each shard's gradient tree;
    returns (mean grads, new err state), ``{shard: tree}`` maps."""
    flat_g = {i: tree_leaves(t) for i, t in grads.items()}
    flat_e = {i: tree_leaves(t) for i, t in err_state.items()}
    out = {i: [] for i in grads}
    errs = {i: [] for i in grads}
    for j in range(len(next(iter(flat_g.values())))):
        r, ne = compressed_psum({i: f[j] for i, f in flat_g.items()},
                                {i: f[j] for i, f in flat_e.items()}, transport)
        for i in grads:
            out[i].append(r[i].to(flat_g[i][j].dtype))
            errs[i].append(ne[i])

    return ({i: tree_unflatten(grads[i], out[i]) for i in grads},
            {i: tree_unflatten(err_state[i], errs[i]) for i in grads})
