"""Carry the JAX package's configuration and state across to the port.

The solver has no learned weights: what a JAX run is made of is its
stencil, its monitor / solver / shard-runtime configs, its mesh partition
and its arrays.  The readers below take any object with the JAX classes'
fields (they read attributes only, so this module imports nothing of the
JAX package) and build the port's frozen dataclasses; ``tensor_from``
moves arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.detection import MonitorConfig
from repro_torch.runtime.shard_runtime import ShardRuntimeConfig
from repro_torch.solvers.convdiff import Stencil
from repro_torch.solvers.fixed_point import SolverConfig
from repro_torch.solvers.partition import MeshPartition


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
