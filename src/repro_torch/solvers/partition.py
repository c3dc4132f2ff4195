"""Partition of the convection–diffusion grid over a process grid or a
1-D/2-D/3-D shard mesh.

``GridPartition`` is the paper's fixed ``px × py`` (x, y)-plane grid with
the whole z-interval local (§4.1); ``process_grid`` factors p into it.
``ConvDiffProblem`` validates its ``(n, p)`` against them.

``MeshPartition`` is the geometry the mesh shard runtime builds against:
per-shard blocks and offsets, row-major rank ↔ coords, face-neighbour
topology, and the double-buffer space of the stale halo ring.  It is pure
Python, a copy of the JAX package's contract (``solvers/partition.py``) so
that the port imports nothing of it; ranks are row-major over the mesh axes,
so per-shard knobs index the same shard in both packages.  The 7-point
stencil exchanges faces only — no edges or corners.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

def process_grid(p: int) -> Tuple[int, int]:
    """Factor p into the most-square (px, py) grid (the paper uses 2-D grids)."""
    best = (p, 1)
    for px in range(1, int(math.isqrt(p)) + 1):
        if p % px == 0:
            best = (p // px, px)
    return best


@dataclass(frozen=True)
class GridPartition:
    """Partition of an ``n × n × n`` interior grid over a ``px × py`` grid."""

    n: int
    px: int
    py: int

    def __post_init__(self):
        if self.n % self.px or self.n % self.py:
            raise ValueError(f"n={self.n} not divisible by ({self.px},{self.py})")

    @property
    def p(self) -> int:
        """Total subdomain count px x py."""
        return self.px * self.py

    @property
    def block(self) -> Tuple[int, int, int]:
        """Per-subdomain block extents (x, y, full z pencil)."""
        return (self.n // self.px, self.n // self.py, self.n)

    def coords(self, i: int) -> Tuple[int, int]:
        """Row-major (cx, cy) grid coordinates of rank i."""
        return divmod(i, self.py)

    def rank(self, cx: int, cy: int) -> int:
        """Row-major rank of grid coordinates (cx, cy)."""
        return cx * self.py + cy

    def neighbors(self, i: int) -> List[int]:
        """Face-adjacent ranks of subdomain i (4-neighbourhood)."""
        cx, cy = self.coords(i)
        out = []
        if cx > 0:
            out.append(self.rank(cx - 1, cy))
        if cx < self.px - 1:
            out.append(self.rank(cx + 1, cy))
        if cy > 0:
            out.append(self.rank(cx, cy - 1))
        if cy < self.py - 1:
            out.append(self.rank(cx, cy + 1))
        return out

    def side(self, i: int, j: int) -> str:
        """Which face of subdomain i touches neighbour j: x-|x+|y-|y+."""
        (cx, cy), (dx, dy) = self.coords(i), self.coords(j)
        if dx == cx - 1 and dy == cy:
            return "x-"
        if dx == cx + 1 and dy == cy:
            return "x+"
        if dx == cx and dy == cy - 1:
            return "y-"
        if dx == cx and dy == cy + 1:
            return "y+"
        raise ValueError(f"{j} is not a neighbour of {i}")

    def offsets(self, i: int) -> Tuple[int, int]:
        """Global (x, y) grid offsets of subdomain i's block origin."""
        cx, cy = self.coords(i)
        bx, by, _ = self.block
        return (cx * bx, cy * by)


#: face labels per grid axis, (minus, plus) — the exchange vocabulary
FACES = (("x-", "x+"), ("y-", "y+"), ("z-", "z+"))


@dataclass(frozen=True)
class MeshPartition:
    """Partition of an ``n × n × n`` grid over a 1-D/2-D/3-D process mesh.

    ``shape`` is ``(px,)``, ``(px, py)`` or ``(px, py, pz)``: grid axis d
    is split into ``shape[d]`` equal slabs; axes beyond ``len(shape)`` stay
    whole (a 1-D partition is the runtime's x-pencil).
    """

    n: int
    shape: Tuple[int, ...]

    def __post_init__(self):
        shape = tuple(int(s) for s in self.shape)
        object.__setattr__(self, "shape", shape)
        if not 1 <= len(shape) <= 3:
            raise ValueError(f"mesh shape {shape} must be 1-D, 2-D, or 3-D")
        if any(s < 1 for s in shape):
            raise ValueError(f"mesh shape {shape} must be >= 1 per axis")
        for s in shape:
            if self.n % s:
                raise ValueError(
                    f"n={self.n} not divisible by mesh shape {shape}")

    # -- basic facts --------------------------------------------------------
    @property
    def ndim(self) -> int:
        """Partitioned mesh dimensionality (1, 2 or 3)."""
        return len(self.shape)

    @property
    def p(self) -> int:
        """Total shard count (product of the mesh shape)."""
        return int(math.prod(self.shape))

    @property
    def full_shape(self) -> Tuple[int, int, int]:
        """``shape`` padded with trailing 1s to the three grid axes."""
        return tuple(self.shape) + (1,) * (3 - self.ndim)

    @property
    def block(self) -> Tuple[int, int, int]:
        """Per-shard block extents along the three grid axes."""
        return tuple(self.n // s for s in self.full_shape)

    def block_spec(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """Per-axis ``(offset, extent)`` of shard i's block."""
        return tuple(zip(self.offsets(i), self.block))

    # -- rank <-> coords (row-major) -----------------------------------------
    def coords(self, i: int) -> Tuple[int, ...]:
        """Row-major mesh coordinates of rank i."""
        if not 0 <= i < self.p:
            raise ValueError(f"rank {i} out of range for p={self.p}")
        out = []
        for s in reversed(self.shape):
            i, c = divmod(i, s)
            out.append(c)
        return tuple(reversed(out))

    def rank(self, *coords: int) -> int:
        """Row-major rank of the given mesh coordinates."""
        if len(coords) != self.ndim:
            raise ValueError(f"expected {self.ndim} coords, got {coords}")
        r = 0
        for c, s in zip(coords, self.shape):
            if not 0 <= c < s:
                raise ValueError(f"coords {coords} out of mesh {self.shape}")
            r = r * s + c
        return r

    def offsets(self, i: int) -> Tuple[int, int, int]:
        """Global grid offsets of shard i's block origin."""
        c = self.coords(i) + (0,) * (3 - self.ndim)
        return tuple(cd * bd for cd, bd in zip(c, self.block))

    # -- face-neighbour topology --------------------------------------------
    def neighbors(self, i: int) -> List[int]:
        """Face-adjacent ranks of shard i across every mesh axis."""
        c = self.coords(i)
        out = []
        for d in range(self.ndim):
            for step in (-1, +1):
                cd = c[d] + step
                if 0 <= cd < self.shape[d]:
                    out.append(self.rank(*(c[:d] + (cd,) + c[d + 1:])))
        return out

    def face(self, i: int, j: int) -> str:
        """Which face of shard i touches neighbour j (``FACES`` labels)."""
        ci, cj = self.coords(i), self.coords(j)
        diff = [b - a for a, b in zip(ci, cj)]
        for d, dd in enumerate(diff):
            if dd in (-1, +1) and all(o == 0 for k, o in enumerate(diff)
                                      if k != d):
                return FACES[d][0 if dd == -1 else 1]
        raise ValueError(f"{j} is not a face neighbour of {i}")

    # -- double-buffer space (the stale halo ring) ---------------------------
    def face_shapes(self) -> Dict[str, Tuple[int, int]]:
        """Shape of each exchanged face plane, keyed by ``FACES`` label:
        x-planes ``(by, bz)``, y-planes ``(bx, bz)``, z-planes ``(bx, by)``."""
        bx, by, bz = self.block
        plane = {0: (by, bz), 1: (bx, bz), 2: (bx, by)}
        out = {}
        for d in range(self.ndim):
            for label in FACES[d]:
                out[label] = plane[d]
        return out

    def ring_slots(self, max_delay: int) -> int:
        """Ring length the stale-halo buffer needs: ``max_delay + 1`` slots,
        at least 2 (the exchange of step k+1 lands in a slot the sweep of
        step k does not read)."""
        if max_delay < 0:
            raise ValueError(f"max_delay={max_delay} must be >= 0")
        return max(int(max_delay) + 1, 2)

    def buffer_elems(self, max_delay: int = 0) -> int:
        """Total per-shard halo double-buffer space, in elements."""
        slots = self.ring_slots(max_delay)
        return slots * sum(a * b for a, b in self.face_shapes().values())
