"""Shard groups — the port's counterpart of the JAX package's shard meshes.

The JAX package lays the shards of its runtimes over a device mesh
(``launch/mesh.py:make_shard_mesh``, one block owner per device).  The port
lays them over the ranks of a ``torch.distributed`` process group, one shard
per process:

* ``ShardGroup`` holds the mesh shape (1-D to 3-D, ranks row-major as
  ``solvers.partition.MeshPartition`` ranks shards), the rank and backend
  of the default process group, and the rank's device;
* ``make_shard_group`` joins (or reuses) the process group and picks the
  device: ``cuda:<local rank>`` under NCCL, the caller's device under gloo;
* ``local_slices`` says which block of the global state, and which rows of
  PageRank's operator, a rank owns — the counterpart of JAX's
  ``state_spec`` / ``mesh_state_spec``;
* ``place_blocks`` moves the local shards' blocks of an array to the
  shard's device (only those blocks, over a group);
* ``spawn_world`` starts a local world of k ranks (spawned processes that
  meet at a ``FileStore``), runs a job on each and returns their results;
  a rank that raises, dies or hangs ends the world with an error.

The model's meshes (the JAX module's ``make_production_mesh``,
``make_host_mesh`` and ``dp_axes_of``) are ``ModelMesh``es: a shape over
named axes (``("data", "model")`` or ``("pod", "data", "model")``), this
rank's coordinates on it, and one process group per axis (the ranks that
share every other coordinate).  ``P`` is the port's ``PartitionSpec``: an
axis name, a tuple of names or None per tensor dimension;
``spec_slices`` says which block of a global tensor a rank holds under
it.  ``make_production_mesh`` only describes the 16×16 or 2×16×16 mesh (no
group, no device), as the JAX function touches no device at import;
``dry_rank`` puts one rank on such a layout, on ``meta``.
"""
from __future__ import annotations

import math
import os
import queue
import time
import traceback
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.solvers.partition import MeshPartition

BACKENDS = ("gloo", "nccl")


def shard_axis_names(axis: str, ndim: int) -> Tuple[str, ...]:
    """Axis names of a shard mesh: the single historical ``axis`` for 1-D,
    ``(axis_x, axis_y[, axis_z])`` for multi-axis meshes."""
    if ndim == 1:
        return (axis,)
    return tuple(f"{axis}_{d}" for d in ("x", "y", "z")[:ndim])


def mesh_shape(shape: Union[int, Sequence[int]]) -> Tuple[int, ...]:
    """A validated shard-mesh shape: an int is the 1-D mesh ``(p,)``."""
    out = tuple(int(s) for s in shape) if isinstance(shape, (tuple, list)) \
        else (int(shape),)
    if not 1 <= len(out) <= 3 or any(s < 1 for s in out):
        raise ValueError(f"mesh shape {shape!r} must be 1-3 positive ints")
    return out


def mesh_coords(rank: int, shape: Sequence[int]) -> Tuple[int, ...]:
    """Row-major coordinates of ``rank`` on a mesh of ``shape``."""
    out = []
    for s in reversed(shape):
        rank, c = divmod(rank, s)
        out.append(c)
    return tuple(reversed(out))


@dataclass(eq=False)
class ShardGroup:
    """The ranks of the default process group laid out as a shard mesh;
    this process is shard ``rank``.  The transport's counters:
    ``staged_bytes``, the bytes gloo staged between the card and the host,
    ``staged_s`` the host seconds that took (stream synchronisations
    included), and ``wait_s`` the host seconds blocked in transfers and
    collectives."""

    shape: Tuple[int, ...]
    rank: int
    backend: str
    device: torch.device
    axis: str = "shard"
    staged_bytes: int = 0
    staged_s: float = 0.0
    wait_s: float = 0.0

    @property
    def p(self) -> int:
        return math.prod(self.shape)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return shard_axis_names(self.axis, len(self.shape))


def shard_axes_of(group: ShardGroup) -> Tuple[str, ...]:
    """All shard axes of a group, in grid-axis order."""
    return group.axis_names


def _rank_of(rank: Optional[int]) -> int:
    if rank is not None:
        return int(rank)
    if dist.is_initialized():
        return dist.get_rank()
    if "RANK" not in os.environ:
        raise ValueError("pass rank= or set RANK: the process group is not "
                         "initialised yet")
    return int(os.environ["RANK"])


def _nccl_device(rank: int, world: int) -> torch.device:
    """``cuda:<local rank>`` for an NCCL rank; raises where a rank would
    have no card of its own (NCCL refuses two ranks on one device)."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not dist.is_nccl_available() or local_world > cards:
        raise RuntimeError(
            f"NCCL needs one card per rank: {local_world} local ranks, {cards} "
            "cards (NCCL refuses two ranks on one device); run ranks that "
            "share a card, or the CPU, with backend='gloo'")
    return torch.device("cuda", local)


def make_shard_group(shape: Union[int, Sequence[int]], backend: str, *,
                     store=None, device: DeviceLike = None,
                     rank: Optional[int] = None,
                     axis: str = "shard") -> ShardGroup:
    """This process's place in a shard mesh of ``prod(shape)`` ranks.

    The first call joins the default process group (through ``store``, a
    ``torch.distributed`` store, or ``env://`` without one); later calls
    reuse it, for any mesh shape of the same size.  The caller names the
    backend, and nothing switches it after a failure.  Under NCCL the rank
    runs on ``cuda:<local rank>``; under gloo on ``device``, default
    ``cuda`` (``_device.resolve_device``: never the CPU unless asked).
    """
    shape = mesh_shape(shape)
    world = math.prod(shape)
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    r = _rank_of(rank)
    if backend == "nccl":
        dev = _nccl_device(r, world)
        if device is not None and torch.device(device) != dev:
            raise ValueError(f"an NCCL rank runs on {dev}, not {device}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    if not dist.is_initialized():
        kw = dict(store=store) if store is not None else dict(init_method="env://")
        dist.init_process_group(backend, rank=r, world_size=world, **kw)
    if dist.get_backend() != backend or dist.get_world_size() != world \
            or dist.get_rank() != r:
        raise ValueError(
            f"the process group ({dist.get_backend()}, rank {dist.get_rank()} of "
            f"{dist.get_world_size()}) is not rank {r} of a {backend} world "
            f"of {world} (mesh {shape})")
    return ShardGroup(shape=shape, rank=r, backend=backend, device=dev, axis=axis)


FAMILIES = ("convdiff", "pagerank")


def local_slices(family: str, group: Union[ShardGroup, int, Sequence[int]], n: int,
                 rank: Optional[int] = None) -> Tuple[slice, ...]:
    """The block of the global state that ``rank`` (default: the group's
    own rank) owns on ``group`` (a ``ShardGroup`` or a mesh shape):
    convdiff's ``MeshPartition`` block of the (n, n, n) grid, or PageRank's
    row block ``r·n/p`` onward (of the state, and of the rows of its
    operator).  The counterpart of JAX's ``state_spec`` /
    ``mesh_state_spec``."""
    shape = group.shape if isinstance(group, ShardGroup) else mesh_shape(group)
    r = group.rank if rank is None else int(rank)
    if family == "convdiff":
        part = MeshPartition(n, shape)
        return tuple(slice(o, o + e) for o, e in zip(part.offsets(r), part.block))
    if family == "pagerank":
        if len(shape) != 1:
            raise ValueError(f"pagerank shards are 1-D row blocks; got mesh {shape}")
        if n % shape[0]:
            raise ValueError(f"n={n} not divisible by shard count p={shape[0]}")
        nb = n // shape[0]
        return (slice(r * nb, (r + 1) * nb),)
    raise KeyError(f"family {family!r} not in {FAMILIES}")


def place_blocks(a, slices: Mapping[int, tuple], device: torch.device,
                 dtype: Optional[torch.dtype] = None, *,
                 gshape: Optional[Sequence[int]] = None,
                 what: str = "") -> Dict[int, torch.Tensor]:
    """The blocks ``a[slices[i]]`` of the local shards ``i`` on ``device``,
    contiguous.

    ``a`` (a tensor, or anything numpy converts) is the global array, of
    shape ``gshape`` where that is given; or, where one shard is local and
    ``gshape`` is given, that shard's block already.  Only the local blocks
    reach ``device``: where several shards are local (the stacked
    transport) the whole array moves once, else only the one block moves.
    ``what`` opens the message for any other shape."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if gshape is None or tuple(a.shape) == tuple(gshape):
        if len(slices) > 1:
            a = a.to(device, dtype)   # the whole array, once
        return {i: a[s].to(device, dtype).contiguous() for i, s in slices.items()}
    if len(slices) == 1:
        ((i, s),) = slices.items()
        block = tuple(len(range(*si.indices(g))) for si, g in zip(s, gshape)) \
            + tuple(gshape[len(s):])
        if tuple(a.shape) == block:
            return {i: a.to(device, dtype).contiguous()}
    raise ValueError(what + (" (or the local block)" if len(slices) == 1 else "")
                     + f", got {tuple(a.shape)}")


# ---------------------------------------------------------------------------
# Local worlds of spawned ranks
# ---------------------------------------------------------------------------


def _rank_main(job: Callable, rank: int, k: int, path: str, args: tuple,
               results) -> None:
    """One spawned rank: run ``job(rank, k, store, *args)`` and report its
    result, or its traceback, to the parent."""
    # a local world talks over the loopback interface only
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        out = job(rank, k, dist.FileStore(path, k), *args)
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which fails the world
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(job: Callable, k: int, store_dir: str, *, args: tuple = (),
                timeout: float = 600.0) -> List[Any]:
    """Run ``job(rank, k, store, *args)`` on each rank of a local world of
    ``k`` spawned processes and return the results in rank order.

    ``job`` must be importable (it is pickled by name) and return picklable
    host values.  The ranks meet at a ``FileStore`` under ``store_dir`` (no
    fixed port).  A rank that raises ends the world at once with its
    traceback; a rank that dies without a result, or a world that has not
    finished within ``timeout`` seconds, ends it too.  Every process is
    stopped before this returns or raises.
    """
    ctx = torch.multiprocessing.get_context("spawn")
    path = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(job, r, k, path, args, results),
                         daemon=True) for r in range(k)]
    out: List[Any] = [None] * k
    got = [False] * k
    deadline = time.monotonic() + timeout
    try:
        for pr in procs:
            pr.start()
        while not all(got):
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"world of {k}: ranks {[r for r in range(k) if not got[r]]} "
                    f"did not finish within {timeout:g} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r in range(k) if not got[r] and not procs[r].is_alive()]
                if dead:
                    raise RuntimeError(
                        f"world of {k}: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} without a result") from None
                continue
            if not ok:
                raise RuntimeError(f"world of {k}: rank {rank} failed:\n{payload}")
            out[rank], got[rank] = payload, True
    finally:
        started = [pr for pr in procs if pr.pid is not None]
        for pr in started:
            pr.join(timeout=30 if all(got) else 0.1)
        for pr in started:
            if pr.is_alive():
                pr.terminate()
                pr.join(timeout=10)
            if pr.is_alive():
                pr.kill()
                pr.join()
        results.close()
        if os.path.exists(path):
            os.remove(path)
    return out


# ---------------------------------------------------------------------------
# The model's meshes and partition specs
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: per tensor dimension an axis name, a tuple of axis
    names (the dimension split over their product, the first major), or
    None (replicated) — ``jax.sharding.PartitionSpec``'s counterpart.
    Missing trailing dimensions are replicated.  As JAX's, a tuple of one
    name is that name and an empty tuple is None."""

    def __new__(cls, *parts):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return None if not a else (a[0] if len(a) == 1 else a)
            return a

        return super().__new__(cls, tuple(norm(a) for a in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def spec_axes(axis) -> Tuple[str, ...]:
    """The axis names of one spec entry: () for None, (name,) for a name."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclass(eq=False)
class ModelMesh:
    """Ranks laid row-major over named axes.  ``coords`` is this rank's
    place (None for a mesh that only describes a layout, such as the
    production meshes); ``groups`` holds one process group per axis, and
    one for the data-parallel axes together where there are two, each
    over the ranks that share every other coordinate.  An axis of size 1
    needs no group.  The counters are ``ShardGroup``'s: ``staged_bytes``
    moved between the card and the host for gloo, ``staged_s`` the host
    seconds that took (stream synchronisations included) and ``wait_s``
    the host seconds blocked in collectives; ``moved_bytes`` / ``moved_s``
    hold the payload bytes and host seconds of each kind of collective
    (``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``),
    and ``calls`` the number of calls and payload bytes of each (kind,
    group size), from which ``launch.hlo_analysis`` reckons result and
    wire bytes.  ``moe_drops``, when a list, collects each MoE dispatch's
    (dropped, routed) entry counts as device tensors.  A dry rank
    (``dry_rank``: backend ``"dry"``, device ``meta``) runs the model's
    collectives with no process group, counting what they would move."""

    axis_names: Tuple[str, ...]
    devices_shape: Tuple[int, ...]
    coords: Optional[Tuple[int, ...]] = None
    rank: Optional[int] = None
    backend: Optional[str] = None
    device: Optional[torch.device] = None
    groups: Dict[Tuple[str, ...], Any] = None
    staged_bytes: int = 0
    staged_s: float = 0.0
    wait_s: float = 0.0
    moved_bytes: Dict[str, int] = None
    moved_s: Dict[str, float] = None
    calls: Dict[Tuple[str, int], Tuple[int, int]] = None
    moe_drops: Optional[list] = None

    def __post_init__(self):
        self.groups = dict(self.groups or {})
        self.moved_bytes = dict(self.moved_bytes or {})
        self.moved_s = dict(self.moved_s or {})
        self.calls = dict(self.calls or {})

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, in axis order (JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices_shape))

    def size(self, axis) -> int:
        """The size of an axis, or the product over a tuple of axes."""
        shape = self.shape
        return math.prod(shape[a] for a in spec_axes(axis))

    def index(self, axis) -> int:
        """This rank's coordinate along an axis (row-major over a tuple)."""
        if self.coords is None:
            raise ValueError(f"mesh {self.shape} describes a layout: no rank has a place on it")
        pos = dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in spec_axes(axis):
            idx = idx * self.shape[a] + pos[a]
        return idx

    def group(self, axis):
        """The process group over an axis (or a tuple of axes)."""
        key = spec_axes(axis)
        if len(key) > 1 and set(key) == set(self.axis_names):
            return dist.group.WORLD
        if key not in self.groups:
            raise ValueError(f"mesh {self.shape} has no process group over {key}")
        return self.groups[key]

    def count(self, kind: str, nbytes: int, seconds: float, group_size: int) -> None:
        """One collective of ``kind`` over ``group_size`` ranks whose input
        (this rank's payload) holds ``nbytes``."""
        self.moved_bytes[kind] = self.moved_bytes.get(kind, 0) + int(nbytes)
        self.moved_s[kind] = self.moved_s.get(kind, 0.0) + seconds
        n, b = self.calls.get((kind, group_size), (0, 0))
        self.calls[kind, group_size] = (n + 1, b + int(nbytes))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes: every axis but ``model``."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _group_sets(shape: Sequence[int], axes: Sequence[str], over: Tuple[str, ...]):
    """Rank lists of the groups over the axes ``over``: one per combination
    of the other axes' coordinates, ranks in row-major order of ``over``."""
    inner = [i for i, a in enumerate(axes) if a in over]
    outer = [i for i, a in enumerate(axes) if a not in over]
    sets = []
    for oc in np.ndindex(*[shape[i] for i in outer]):
        ranks = []
        for ic in np.ndindex(*[shape[i] for i in inner]):
            c = [0] * len(shape)
            for i, v in zip(outer, oc):
                c[i] = v
            for i, v in zip(inner, ic):
                c[i] = v
            ranks.append(int(np.ravel_multi_index(c, shape)))
        sets.append(ranks)
    return sets


def make_model_mesh(shape: Sequence[int], axes: Sequence[str], *,
                    device: DeviceLike = None) -> ModelMesh:
    """A mesh of ``shape`` over ``axes`` on the running world: this rank's
    coordinates and the groups every axis needs (every rank makes every
    group, in the same order, as ``torch.distributed.new_group`` wants).
    Without a process group the mesh only describes the layout, unless it
    holds one rank (then collectives have nothing to do).  The device is
    ``cuda:<local rank>`` under NCCL, else ``device`` (default ``cuda``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            return ModelMesh(axes, shape)
        return ModelMesh(axes, shape, coords=(0,) * len(shape), rank=0,
                         device=resolve_device(device))
    world, me = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a mesh of {shape} needs {n} ranks; the world has {world}")
    backend = dist.get_backend()
    dev = _nccl_device(me, world) if backend == "nccl" else resolve_device(device)
    groups = {}
    wanted = [(a,) for a, s in zip(axes, shape) if s > 1]
    dp = tuple(a for a in axes if a != "model")
    if len(dp) > 1 and len(dp) < len(axes):
        wanted.append(dp)
    for over in wanted:
        for ranks in _group_sets(shape, axes, over):
            g = dist.new_group(ranks)
            if me in ranks:
                groups[over] = g
    return ModelMesh(axes, shape, coords=mesh_coords(me, shape), rank=me, backend=backend,
                     device=dev, groups=groups)


def make_production_mesh(*, multi_pod: bool = False) -> ModelMesh:
    """The 16×16 single-pod (256 chips) or 2×16×16 two-pod (512 chips)
    layout, as a description: no process group, no device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ModelMesh(axes, shape)


def dry_rank(mesh: ModelMesh, coords: Optional[Sequence[int]] = None) -> ModelMesh:
    """A copy of ``mesh``'s layout (such as ``make_production_mesh()``) seen
    from one rank (``coords``, default rank 0's) that computes no value:
    device ``meta``, backend ``"dry"``, no process group.  A ``Model`` on it
    builds and runs this rank's program on ``meta`` tensors, and every
    collective counts its payload (``launch/dryrun.py``)."""
    coords = tuple(int(c) for c in (coords if coords is not None
                                    else (0,) * len(mesh.devices_shape)))
    if len(coords) != len(mesh.devices_shape) or any(
            not 0 <= c < n for c, n in zip(coords, mesh.devices_shape)):
        raise ValueError(f"coordinates {coords} are not on the mesh {mesh.shape}")
    rank = int(np.ravel_multi_index(coords, mesh.devices_shape))
    return ModelMesh(mesh.axis_names, mesh.devices_shape, coords=coords, rank=rank,
                     backend="dry", device=torch.device("meta"))


def make_host_mesh(model_axis: int = 1, *, device: DeviceLike = None) -> ModelMesh:
    """A ``(world / model_axis, model_axis)`` mesh over the ranks of the
    running world (one rank, and no process group, when none is running)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the world of {n} ranks")
    return make_model_mesh((n // model_axis, model_axis), ("data", "model"), device=device)


def spec_slices(spec: Sequence, shape: Sequence[int], mesh: ModelMesh) -> Tuple[slice, ...]:
    """The block of a global tensor of ``shape`` that this rank holds
    under ``spec``: each dimension split evenly over its axes' product,
    this rank's coordinate (row-major over the axes) picking the block."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    out = []
    for d, n in enumerate(shape):
        axes = spec_axes(spec[d]) if d < len(spec) else ()
        k = mesh.size(axes) if axes else 1
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} ({n}) does not split over "
                             f"{axes} ({k} ranks)")
        i = mesh.index(axes) if axes else 0
        out.append(slice(i * (n // k), (i + 1) * (n // k)))
    return tuple(out)
