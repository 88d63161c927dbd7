"""Static grid metadata for vertex-centered 2D grids.

Counterpart of the reference's ``Grid`` (reference core/grid.py:10).
The reference Grid owns a mutable numpy array; here the grid is *pure static
metadata* (shape, spacing, domain) — field arrays are separate jax values so
everything stays functional and jittable. Arrays are stored **padded** to
multiples of (16, 128) with the logical (nx, ny) region at the origin;
padding cells are kept at zero and masked out of every operator. The
padding gives every level an even shape (the parity-plane transfers need
it) and at least one spare line per axis (the periodic wrap ghost).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SUBLANE = 16  # bf16 sublane tile; also valid (over-aligned) for fp32
LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def padded_shape(nx: int, ny: int) -> Tuple[int, int]:
    """Storage shape for a logical (nx, ny) grid, (16, 128)-aligned."""
    return (_round_up(nx, SUBLANE), _round_up(ny, LANE))


@dataclasses.dataclass(frozen=True)
class Grid:
    """Vertex-centered uniform grid on a rectangle, boundary points included.

    ``nx`` points span [x0, x1] so the spacing is hx = (x1-x0)/(nx-1).
    Mirrors reference core/grid.py:18 (nx, ny, domain, hx, hy) minus the
    embedded data array.
    """

    nx: int
    ny: int
    domain: Tuple[float, float, float, float] = (0.0, 1.0, 0.0, 1.0)

    def __post_init__(self):
        if self.nx < 3 or self.ny < 3:
            raise ValueError(f"grid must be at least 3x3, got {self.nx}x{self.ny}")

    @property
    def hx(self) -> float:
        x0, x1, _, _ = self.domain
        return (x1 - x0) / (self.nx - 1)

    @property
    def hy(self) -> float:
        _, _, y0, y1 = self.domain
        return (y1 - y0) / (self.ny - 1)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.nx, self.ny)

    @property
    def shape_padded(self) -> Tuple[int, int]:
        return padded_shape(self.nx, self.ny)

    @property
    def num_points(self) -> int:
        return self.nx * self.ny

    @property
    def num_interior(self) -> int:
        return (self.nx - 2) * (self.ny - 2)

    def can_coarsen(self) -> bool:
        """True if standard 2:1 coarsening keeps at least one interior point.

        Mirrors reference core/grid.py:140 ((n-1) even and coarse n >= 3).
        """
        return (
            (self.nx - 1) % 2 == 0
            and (self.ny - 1) % 2 == 0
            and (self.nx - 1) // 2 + 1 >= 3
            and (self.ny - 1) // 2 + 1 >= 3
        )

    def coarsen(self) -> "Grid":
        """Return the 2:1-coarsened grid (reference core/grid.py:140)."""
        if not self.can_coarsen():
            raise ValueError(f"cannot coarsen {self.nx}x{self.ny}")
        return Grid((self.nx - 1) // 2 + 1, (self.ny - 1) // 2 + 1, self.domain)

    def refine(self) -> "Grid":
        """Return the 2:1-refined grid (reference core/grid.py:159)."""
        return Grid(2 * (self.nx - 1) + 1, 2 * (self.ny - 1) + 1, self.domain)

    def coordinates(self, padded: bool = False):
        """Host-side (numpy) coordinate meshes X, Y of shape (nx, ny).

        With ``padded=True`` the arrays have the padded storage shape; padding
        cells continue the uniform spacing (harmless — they are always masked).
        """
        x0, x1, y0, y1 = self.domain
        if padded:
            px, py = self.shape_padded
            x = x0 + self.hx * np.arange(px)
            y = y0 + self.hy * np.arange(py)
        else:
            x = np.linspace(x0, x1, self.nx)
            y = np.linspace(y0, y1, self.ny)
        return np.meshgrid(x, y, indexing="ij")

    def pad_field(self, field: np.ndarray) -> np.ndarray:
        """Zero-pad a logical (nx, ny) array to the padded storage shape."""
        field = np.asarray(field)
        if field.shape != (self.nx, self.ny):
            raise ValueError(
                f"field shape {field.shape} != grid shape {(self.nx, self.ny)}"
            )
        px, py = self.shape_padded
        out = np.zeros((px, py), dtype=field.dtype)
        out[: self.nx, : self.ny] = field
        return out

    def unpad_field(self, field) -> np.ndarray:
        """Slice the logical (nx, ny) region out of a padded array."""
        return np.asarray(field)[: self.nx, : self.ny]
