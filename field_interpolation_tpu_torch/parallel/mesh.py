"""The mesh of a sharded solve: one process (rank) per shard.

Counterpart of the ``jax.sharding.Mesh`` the reference shards over. Ranks of
the default process group are laid out row-major over ``shape``, as
``Mesh(np.array(devices).reshape(shape))`` lays out devices in the
reference's tests; grid dim d is sharded over mesh axis d.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...] = ()

    def __post_init__(self):
        shape = tuple(int(n) for n in self.shape)
        names = tuple(self.axis_names) or ("x", "y", "z", "w")[:len(shape)]
        if len(names) != len(shape) or any(n < 1 for n in shape):
            raise ValueError(f"mesh shape {shape} with axis names {names}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if world != self.size:
                raise ValueError(f"mesh {shape} has {self.size} shards, the process "
                                 f"group {world} ranks")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def coords(self, rank: int | None = None) -> tuple[int, ...]:
        """Mesh coordinates of ``rank`` (this process's by default)."""
        rank = dist.get_rank() if rank is None else rank
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_at(self, coords) -> int:
        rank = 0
        for c, n in zip(coords, self.shape):
            rank = rank * n + c
        return rank

    def shards(self, ndim: int) -> tuple[int, ...]:
        """Shards per grid dim of an ``ndim``-D grid (1 past the mesh's axes)."""
        if any(n > 1 for n in self.shape[ndim:]):
            raise ValueError(f"mesh {self.shape} has more sharded axes than the "
                             f"grid's {ndim} dims")
        return self.shape[:ndim] + (1,) * (ndim - len(self.shape))

    def neighbour(self, axis: int, step: int) -> int | None:
        """The rank ``step`` places along mesh ``axis`` from this one, or None
        past the mesh's edge (or for an axis the mesh does not have)."""
        if axis >= len(self.shape):
            return None
        c = list(self.coords())
        c[axis] += step
        if not 0 <= c[axis] < self.shape[axis]:
            return None
        return self.rank_at(c)
