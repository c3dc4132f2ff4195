"""Carry the JAX package's configuration and state across to the port.

A solver run is made of its stencil, its monitor / solver / shard-runtime
configs, its mesh partition and its arrays; a model of its
``ModelConfig`` and its parameter tree.  The readers below take any object
with the JAX classes' fields (they read attributes only, so this module
imports nothing of the JAX package) and build the port's frozen
dataclasses; ``tensor_from`` moves arrays and ``params_from`` a JAX
parameter tree, as numpy arrays, into a port model's parameters.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Mapping

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
    from repro_torch.models.model import Model
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
    reinterpreted, which is exact."""
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


def params_from(tree: Mapping[str, Any], model: "Model") -> "Transformer":
    """A JAX parameter tree (``Model.init``'s, leaves as numpy arrays) as
    the port model's parameters on ``model.device``.  The JAX layers are a
    tuple over the scan period of dicts whose leaves are stacked
    ``[steps, …]``; layer ``i`` of the port takes step ``i // period`` of
    entry ``i % period``."""
    from repro_torch.models.transformer import Transformer

    params = Transformer(model.plan, model.device)
    with torch.no_grad():
        for name in ("embed", "lm_head", "final_norm"):
            if getattr(params, name) is not None:
                getattr(params, name).copy_(_as_tensor(tree[name]))
        units = tree["layers"]
        period = len(units)
        for i, blk in enumerate(params.layers):
            unit = units[i % period]
            step = i // period
            names = dict(blk.named_parameters())
            if set(names) != set(_leaf_names(unit)):
                raise ValueError(f"layer {i}: JAX leaves {sorted(_leaf_names(unit))} "
                                 f"!= port parameters {sorted(names)}")
            for pname, t in names.items():
                leaf = unit
                for part in pname.split("."):
                    leaf = leaf[part]
                t.copy_(_as_tensor(np.asarray(leaf)[step]))
    return params
