"""N-D lattice metadata: the port's copy of ``field_interpolation_tpu.grid``.

Pure Python, copied rather than imported, because importing the reference
package would import JAX. A grid is a frozen dataclass of plain ints, so it
can key caches of per-shape constants (multigrid transfers, band tables).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Grid:
    """A dense regular lattice of scalar unknowns with unit spacing.

    ``shape`` is the number of nodes per axis, C-order. Continuous sample
    positions live in lattice coordinates ``[0, shape[d] - 1]`` (SPEC.md).
    """

    shape: tuple[int, ...]

    def __post_init__(self):
        shape = tuple(int(n) for n in self.shape)
        object.__setattr__(self, "shape", shape)
        if not 1 <= len(shape) <= 3:
            raise ValueError(f"Grid supports 1–3 dims, got {len(shape)}")
        if any(n < 2 for n in shape):
            raise ValueError(f"Each axis needs >= 2 nodes, got {shape}")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_nodes(self) -> int:
        return math.prod(self.shape)

    @property
    def strides(self) -> tuple[int, ...]:
        """C-order flat-index strides (node index = sum(coord * stride))."""
        out = []
        acc = 1
        for n in reversed(self.shape):
            out.append(acc)
            acc *= n
        return tuple(reversed(out))

    @property
    def num_corners(self) -> int:
        return 1 << self.ndim

    def coarsen(self) -> "Grid":
        """Next-coarser multigrid level: nodes at even fine indices."""
        return Grid(tuple(max(2, (n + 1) // 2) for n in self.shape))


def grid_2d(w: int, h: int) -> Grid:
    return Grid((h, w))


def grid_3d(nx: int, ny: int, nz: int) -> Grid:
    return Grid((nz, ny, nx))
