"""Carry the JAX package's configuration and state across to the port.

A solver run is made of its stencil, its monitor / solver / shard-runtime
configs, its mesh partition and its arrays; a model of its
``ModelConfig`` and its parameter tree.  The readers below take any object
with the JAX classes' fields (they read attributes only, so this module
imports nothing of the JAX package) and build the port's frozen
dataclasses; ``tensor_from`` moves arrays and ``params_from`` a JAX
parameter tree, as numpy arrays, into a port model's parameters.
``train_state_from`` carries a JAX ``TrainState`` across (parameters,
Adam moments and step, monitor); ``params_to_tree`` and
``train_state_tree`` give the port's state back in JAX's tree layout
(layers stacked ``[L, …]``), the layout ``launch/train.py`` checkpoints,
so either package restores the other's training checkpoints.
``shard_params`` carries a JAX tree of global parameters into this rank's
blocks of a model on a mesh (``Model.param_specs``), and
``gather_params`` puts the blocks of every rank back together;
``train_state_tree(state, model)`` gathers a sharded training state into
JAX's layout of global leaves (what a checkpoint holds), and
``train_state_from`` keeps this rank's blocks of one.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.detection import MonitorConfig
from repro_torch.runtime.shard_runtime import ShardRuntimeConfig
from repro_torch.solvers.convdiff import Stencil
from repro_torch.solvers.fixed_point import SolverConfig
from repro_torch.solvers.partition import MeshPartition

if TYPE_CHECKING:
    from repro_torch.models.model import Model, TrainState
    from repro_torch.models.transformer import Transformer


def stencil_from(obj) -> Stencil:
    """The seven coefficients of a ``Stencil`` (or any object with them)."""
    return Stencil(*(float(getattr(obj, f)) for f in
                     ("diag", "xm", "xp", "ym", "yp", "zm", "zp")))


def monitor_from(obj) -> MonitorConfig:
    return MonitorConfig(mode=str(obj.mode), eps=float(obj.eps),
                         eps_tilde=float(obj.eps_tilde),
                         staleness=int(obj.staleness),
                         persistence=int(obj.persistence), ord=float(obj.ord))


def solver_config_from(obj) -> SolverConfig:
    return SolverConfig(stencil=stencil_from(obj.stencil),
                        monitor=monitor_from(obj.monitor),
                        inner_sweeps=int(obj.inner_sweeps),
                        max_outer=int(obj.max_outer), sweep=str(obj.sweep),
                        use_kernel=bool(obj.use_kernel),
                        fuse_residual=bool(obj.fuse_residual))


def _per_shard_field(v):
    return int(v) if np.isscalar(v) else tuple(int(e) for e in v)


def shard_config_from(obj) -> ShardRuntimeConfig:
    """The shard runtime's config, mesh shape and comm overlap included."""
    mesh_shape = getattr(obj, "mesh_shape", None)
    return ShardRuntimeConfig(
        monitor=monitor_from(obj.monitor), reduction=str(obj.reduction),
        inner_sweeps=_per_shard_field(obj.inner_sweeps),
        halo_delay=_per_shard_field(obj.halo_delay),
        contrib_lag=_per_shard_field(obj.contrib_lag),
        max_outer=int(obj.max_outer), trace_len=int(obj.trace_len),
        sweep=str(obj.sweep),
        mesh_shape=None if mesh_shape is None else tuple(int(s) for s in mesh_shape),
        overlap=bool(getattr(obj, "overlap", False)))


def partition_from(obj) -> MeshPartition:
    """The port's ``MeshPartition`` of the same grid and mesh shape."""
    return MeshPartition(int(obj.n), tuple(int(s) for s in obj.shape))


def tensor_from(array, device: DeviceLike = None,
                dtype: torch.dtype = None) -> torch.Tensor:
    """A numpy-convertible array (numpy, or any object with ``__array__``)
    as a tensor on ``device`` (default ``cuda``)."""
    return torch.as_tensor(np.asarray(array), dtype=dtype,
                           device=resolve_device(device))


def model_config_from(obj) -> ModelConfig:
    """The port's ``ModelConfig`` with every field of ``obj``."""
    return ModelConfig(**{f.name: getattr(obj, f.name)
                          for f in dataclasses.fields(ModelConfig)})


def _as_tensor(a) -> torch.Tensor:
    """A numpy array as a tensor.  bf16 arrives as an ``ml_dtypes`` array,
    which ``torch.as_tensor`` refuses: its bits are viewed as uint16 and
    reinterpreted, which is exact.  A tensor is returned as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _leaf_names(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaf_names(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def _named_from_tree(tree: Mapping[str, Any], names) -> Dict[str, torch.Tensor]:
    """The leaves of a JAX parameter-shaped tree under the port's parameter
    ``names`` (a ``Transformer``'s ``named_parameters()`` order), as
    tensors.  The JAX layers are a tuple over the scan period of dicts
    whose leaves are stacked ``[steps, …]``; layer ``i`` of the port takes
    step ``i // period`` of entry ``i % period``."""
    units = tree["layers"]
    period = len(units)
    per_layer: Dict[int, set] = {}
    for name in names:
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            per_layer.setdefault(int(i), set()).add(rest)
    for i, got in per_layer.items():
        want = set(_leaf_names(units[i % period]))
        if got != want:
            raise ValueError(f"layer {i}: JAX leaves {sorted(want)} "
                             f"!= port parameters {sorted(got)}")
    out = {}
    for name in names:
        if not name.startswith("layers."):
            out[name] = _as_tensor(tree[name])
            continue
        _, i, rest = name.split(".", 2)
        leaf = units[int(i) % period]
        for part in rest.split("."):
            leaf = leaf[part]
        step = int(i) // period
        out[name] = leaf[step] if isinstance(leaf, torch.Tensor) else \
            _as_tensor(np.asarray(leaf)[step])
    return out


def params_from(tree: Mapping[str, Any], model: "Model") -> "Transformer":
    """A JAX parameter tree (``Model.init``'s, leaves as numpy arrays or
    tensors) as the port model's parameters on ``model.device``."""
    from repro_torch.models.transformer import Transformer

    params = Transformer(model.plan, model.device)
    named = dict(params.named_parameters())
    with torch.no_grad():
        for name, leaf in _named_from_tree(tree, named).items():
            named[name].copy_(leaf)
    return params


def params_to_tree(params, period: int = 1) -> Dict[str, Any]:
    """The inverse of ``params_from``: JAX's parameter tree of host tensors
    (``layers`` a tuple of ``period`` unit entries, entry j holding layers
    j, j + period, … stacked ``[L / period, …]``), from a ``Transformer``
    (its own period) or a ``{name: tensor}`` dict under its parameter names
    (moments, gradients) with the given ``period``."""
    if isinstance(params, torch.nn.Module):
        period = params.period
        named = dict(params.named_parameters())
    else:
        named = dict(params)
    tree: Dict[str, Any] = {}
    stacks: Dict[Tuple[int, Tuple[str, ...]], list] = {}
    for name, t in named.items():
        t = t.detach().to("cpu", copy=True)   # a snapshot: training updates in place
        if not name.startswith("layers."):
            tree[name] = t
            continue
        _, i, rest = name.split(".", 2)
        stacks.setdefault((int(i) % period, tuple(rest.split("."))), []).append((int(i), t))
    units: Tuple[Dict[str, Any], ...] = tuple({} for _ in range(period))
    for (j, path), items in stacks.items():
        d = units[j]
        for part in path[:-1]:
            d = d.setdefault(part, {})
        d[path[-1]] = torch.stack([t for _, t in sorted(items, key=lambda it: it[0])])
    tree["layers"] = units
    return tree


def train_state_tree(state: "TrainState", model: "Model" = None,
                     keep: bool = True) -> Optional[tuple]:
    """The port's ``TrainState`` in the JAX ``TrainState``'s tree layout:
    ``(params, (step, m, v), monitor fields, step)``, the parameter and
    moment trees from ``params_to_tree``.  Either package's checkpointer
    flattens it into the JAX state's leaves, in the same order.  With
    ``model`` on a mesh the parameters and moments are gathered into their
    global tensors first (``gather_params``; every rank calls it, and a
    rank that passes ``keep=False`` takes part in the gathers and gets
    None)."""
    period = state.params.period
    if model is not None and model.mesh is not None:
        params, m, v = (gather_params(t, model, keep) for t in
                        (state.params, state.opt.m, state.opt.v))
        if not keep:
            return None
    else:
        params, m, v = (params_to_tree(state.params), params_to_tree(state.opt.m, period),
                        params_to_tree(state.opt.v, period))
    return (params, (state.opt.step, m, v), tuple(state.monitor), state.step)


def train_state_from(state, model: "Model") -> "TrainState":
    """A JAX ``TrainState`` (leaves as arrays), or a tree in its layout
    (``train_state_tree``'s, or what a checkpointer restores in it), as the
    port's ``TrainState`` on ``model.device``: the parameters trainable,
    the Adam step and moments (in their own dtypes) keyed by parameter
    name, and the monitor state.  On a mesh the leaves are global and this
    rank keeps its block of each (``shard_params``)."""
    from repro_torch.core.detection import MonitorState
    from repro_torch.models.model import TrainState
    from repro_torch.optim.adamw import AdamState

    tree, (opt_step, m, v), monitor, step = state
    sharded = model.mesh is not None
    params = (shard_params(tree, model) if sharded else params_from(tree, model)
              ).requires_grad_(True)
    names = [n for n, _ in params.named_parameters()]
    blocks = model.param_blocks() or {}
    dev = model.device

    def on_dev(a) -> torch.Tensor:
        return _as_tensor(a).to(dev)

    def moments(t):
        return {n: (leaf[blocks[n]] if n in blocks else leaf).contiguous().to(dev)
                for n, leaf in _named_from_tree(t, names).items()}

    return TrainState(params=params,
                      opt=AdamState(step=on_dev(opt_step), m=moments(m), v=moments(v)),
                      monitor=MonitorState(*(on_dev(x) for x in monitor)),
                      step=on_dev(step))


def shard_params(tree: Mapping[str, Any], model: "Model", mesh=None) -> "Transformer":
    """A JAX parameter tree of *global* leaves (numpy arrays or tensors) as
    this rank's blocks of ``model``'s parameters on ``model.device``, by
    ``model.param_specs()`` (``mesh``, if given, must be the model's)."""
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("shard_params: the mesh is not the model's")
    blocks = model.param_blocks() or {}
    params = model.empty_params()
    named = dict(params.named_parameters())
    with torch.no_grad():
        for name, leaf in _named_from_tree(tree, named).items():
            block = blocks.get(name)
            named[name].copy_(leaf[block] if block is not None else leaf)
    return params


def gather_params(params, model: "Model", keep: bool = True) -> Any:
    """The inverse of ``shard_params``: every rank's blocks of ``params``
    (a ``Transformer``, or a ``{name: tensor}`` dict of gradients or
    moments under its names) gathered over the mesh into JAX's tree of
    global host tensors.  Every rank of the mesh calls it; each leaf moves
    to the host as soon as it is whole, so the card holds one gathered
    leaf at a time.  With ``keep=False`` the rank takes part in the
    gathers and gets None."""
    from repro_torch.launch.mesh import spec_axes
    from repro_torch.models.collectives import all_gather

    named = dict(params.named_parameters()) if isinstance(params, torch.nn.Module) \
        else dict(params)
    specs = model.param_specs() if model.mesh is not None else {}
    out = {}
    for name, t in named.items():
        t = t.detach()
        for d, axes in enumerate(specs.get(name, ())):
            if spec_axes(axes):
                t = all_gather(t.contiguous(), model.mesh, tuple(spec_axes(axes)), dim=d)
        if keep:
            out[name] = t.to("cpu", copy=True)
    return params_to_tree(out, model.plan.period) if keep else None
