"""torch API compat shims (port of ``core/compat.py``).

The JAX module bridges jax releases (``jax.shard_map`` against
``jax.experimental.shard_map``, ``jax.make_mesh``'s ``axis_types``,
``jax.lax.axis_size``).  The port's version-dependent names are the
collectives of ``torch.distributed`` that the model's parallel layout
calls: the tensor all-gather and reduce-scatter (``all_gather_single`` /
``reduce_scatter_single`` on newer releases, ``all_gather_into_tensor`` /
``reduce_scatter_tensor`` before, ``_all_gather_base`` /
``_reduce_scatter_base`` on older ones).  Everything version-dependent
goes through here so that call sites stay clean.

``make_mesh_compat`` and ``axis_size_compat`` keep their JAX names: a mesh
built from a shape and axis names (``launch.mesh.ModelMesh``, one process
group per axis), and the size of one of its axes.  ``shard_map_compat`` has
no counterpart: under ``torch.distributed`` every rank runs its own body,
so the body is called directly and its collectives name the mesh's groups
(``models/collectives.py``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist


def _newest(*names):
    """The first of ``names`` this release of ``torch.distributed`` has."""
    return next(getattr(dist, n) for n in names if hasattr(dist, n))


def all_gather_into_tensor(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """Gather every rank's ``inp`` into ``out`` (concatenated along dim 0)."""
    _newest("all_gather_single", "all_gather_into_tensor", "_all_gather_base")(
        out, inp, group=group)


def reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """Sum ``inp`` over the ranks and keep this rank's dim-0 block in ``out``."""
    _newest("reduce_scatter_single", "reduce_scatter_tensor", "_reduce_scatter_base")(
        out, inp, op=dist.ReduceOp.SUM, group=group)


def make_mesh_compat(shape: Sequence[int], axes: Sequence[str], *, device=None):
    """A ``launch.mesh.ModelMesh`` of ``shape`` over ``axes`` laid over the
    ranks of the running world (row-major), with one process group per
    axis; with no process group initialised, a description without groups
    (the JAX ``make_mesh`` binds devices, which a description need not)."""
    from repro_torch.launch.mesh import make_model_mesh

    return make_model_mesh(tuple(shape), tuple(axes), device=device)


def axis_size_compat(mesh, axis) -> int:
    """The size of mesh axis ``axis`` (a name or a tuple of names)."""
    return mesh.size(axis)
