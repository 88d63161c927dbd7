"""Static grid metadata for vertex-centered 3D grids.

The reference's 3D solvers are stubs (reference
applications/poisson_solver.py:483-557 and heat_solver.py:752-792 raise
NotImplementedError); this build implements 3D for real. Arrays are stored
padded to multiples of 16 and 128 on the *last two* axes and to an even
size on x, logical region at the origin.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .grid import LANE, SUBLANE, _round_up


def padded_shape3d(nx: int, ny: int, nz: int) -> Tuple[int, int, int]:
    # x rounds to even so parity-plane transfers can reshape (nx is 2^k+1,
    # i.e. odd); tiling only constrains the trailing two dims.
    return (_round_up(nx, 2), _round_up(ny, SUBLANE), _round_up(nz, LANE))


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """Vertex-centered uniform grid on a box, boundary points included."""

    nx: int
    ny: int
    nz: int
    domain: Tuple[float, float, float, float, float, float] = (
        0.0, 1.0, 0.0, 1.0, 0.0, 1.0
    )

    def __post_init__(self):
        if min(self.nx, self.ny, self.nz) < 3:
            raise ValueError(
                f"grid must be at least 3^3, got {self.nx}x{self.ny}x{self.nz}"
            )

    @property
    def hx(self) -> float:
        x0, x1 = self.domain[0], self.domain[1]
        return (x1 - x0) / (self.nx - 1)

    @property
    def hy(self) -> float:
        y0, y1 = self.domain[2], self.domain[3]
        return (y1 - y0) / (self.ny - 1)

    @property
    def hz(self) -> float:
        z0, z1 = self.domain[4], self.domain[5]
        return (z1 - z0) / (self.nz - 1)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.nx, self.ny, self.nz)

    @property
    def shape_padded(self) -> Tuple[int, int, int]:
        return padded_shape3d(self.nx, self.ny, self.nz)

    @property
    def num_points(self) -> int:
        return self.nx * self.ny * self.nz

    @property
    def num_interior(self) -> int:
        return (self.nx - 2) * (self.ny - 2) * (self.nz - 2)

    def can_coarsen(self) -> bool:
        return all(
            (n - 1) % 2 == 0 and (n - 1) // 2 + 1 >= 3
            for n in (self.nx, self.ny, self.nz)
        )

    def coarsen(self) -> "Grid3D":
        if not self.can_coarsen():
            raise ValueError(f"cannot coarsen {self.shape}")
        return Grid3D(
            (self.nx - 1) // 2 + 1, (self.ny - 1) // 2 + 1,
            (self.nz - 1) // 2 + 1, self.domain,
        )

    def refine(self) -> "Grid3D":
        return Grid3D(
            2 * (self.nx - 1) + 1, 2 * (self.ny - 1) + 1,
            2 * (self.nz - 1) + 1, self.domain,
        )

    def coordinates(self, padded: bool = False):
        x0, x1, y0, y1, z0, z1 = self.domain
        if padded:
            px, py, pz = self.shape_padded
            x = x0 + self.hx * np.arange(px)
            y = y0 + self.hy * np.arange(py)
            z = z0 + self.hz * np.arange(pz)
        else:
            x = np.linspace(x0, x1, self.nx)
            y = np.linspace(y0, y1, self.ny)
            z = np.linspace(z0, z1, self.nz)
        return np.meshgrid(x, y, z, indexing="ij")

    def pad_field(self, field: np.ndarray) -> np.ndarray:
        field = np.asarray(field)
        if field.shape != self.shape:
            raise ValueError(f"field shape {field.shape} != {self.shape}")
        out = np.zeros(self.shape_padded, dtype=field.dtype)
        out[: self.nx, : self.ny, : self.nz] = field
        return out

    def unpad_field(self, field) -> np.ndarray:
        return np.asarray(field)[: self.nx, : self.ny, : self.nz]
