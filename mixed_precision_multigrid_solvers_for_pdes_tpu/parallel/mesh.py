"""Device-mesh construction and sharding specs for spatial domain decomposition.

Replacement for the reference's thread-driven multi-GPU layer
(reference gpu/multi_gpu.py:39-298, multi_gpu_solver.py:22-117):

- STRIP_X / STRIP_Y / BLOCK_2D decompositions (reference
  multi_gpu_solver.py:342-445) become 1D/2D ``jax.sharding.Mesh`` axes.
- ADAPTIVE decomposition (pick the longer dimension,
  reference multi_gpu_solver.py:438-443) becomes mesh-shape selection here.
- Device discovery/load-balancing (reference multi_gpu.py:85-264) collapses
  to ``jax.devices()``: the cards of one host are identical and joined all
  to all, so the mesh shape follows the algorithm alone.

Grid levels are sharded ('x','y') over padded arrays while each device keeps
at least a tile; below that the level is **replicated** (coarse-level
agglomeration — the thing the reference faked with a damped-residual
correction, reference multi_gpu_solver.py:574-593).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.grid import Grid

AXES = ("x", "y")


def choose_mesh_shape(n_devices: int, grid: Optional[Grid] = None) -> Tuple[int, int]:
    """Pick a 2D mesh shape: near-square, longer grid dimension gets the
    larger mesh axis (reference ADAPTIVE semantics, multi_gpu_solver.py:438)."""
    best = (1, n_devices)
    for mx in range(1, n_devices + 1):
        if n_devices % mx:
            continue
        my = n_devices // mx
        if abs(mx - my) < abs(best[0] - best[1]):
            best = (mx, my)
    mx, my = best
    if grid is not None and grid.nx < grid.ny and mx > my:
        mx, my = my, mx
    return (mx, my)


def make_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int]] = None,
    grid: Optional[Grid] = None,
) -> Mesh:
    """Build a 2D ('x','y') device mesh over the given / all devices."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = choose_mesh_shape(len(devices), grid)
    arr = np.asarray(devices[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(arr, AXES)


def grid_sharding(mesh: Mesh, grid: Grid, min_points_per_device: int = 16):
    """NamedSharding for a level: block-partitioned while every device keeps
    >= min_points_per_device rows/cols of the padded array, else replicated
    (coarse-level agglomeration switchover)."""
    px, py = grid.shape_padded
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    # gate on LOGICAL extent: sharding a level whose logical points fit on one
    # device just spreads padding around (and the blocks must tile evenly)
    spec_x = "x" if grid.nx // mx >= min_points_per_device and px % mx == 0 else None
    spec_y = "y" if grid.ny // my >= min_points_per_device and py % my == 0 else None
    return NamedSharding(mesh, P(spec_x, spec_y))


def grid_sharding3d(mesh: Mesh, grid3d, min_points_per_device: int = 16):
    """NamedSharding for a 3D level: block-partition (x, y) over the mesh,
    keep z (the lane axis) local — stencil halos then ride the mesh in x/y
    only, and every z-line (the line-smoother solve direction) stays on one
    device."""
    px, py, pz = grid3d.shape_padded
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    spec_x = "x" if grid3d.nx // mx >= min_points_per_device and px % mx == 0 \
        else None
    spec_y = "y" if grid3d.ny // my >= min_points_per_device and py % my == 0 \
        else None
    return NamedSharding(mesh, P(spec_x, spec_y, None))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Graded sub-mesh agglomeration
# ---------------------------------------------------------------------------

GRADED_AXES = ("xo", "xi", "yo", "yi")


def _factor2(m: int) -> Tuple[int, int]:
    """(outer, inner) factoring of one mesh axis: inner=2 gives one 2-way
    agglomeration step; odd / unit axes get no intermediate tier."""
    return (m // 2, 2) if m % 2 == 0 and m > 1 else (m, 1)


def make_graded_mesh(
    devices: Optional[Sequence] = None,
    shape: Optional[Tuple[int, int, int, int]] = None,
    grid: Optional[Grid] = None,
) -> Mesh:
    """4-axis mesh ('xo','xi','yo','yi') for graded coarse-level
    agglomeration: each spatial mesh axis is factored into outer x inner.

    Fine levels shard over both factors (identical layout to the plain
    ('x','y') mesh); mid levels shard over the OUTER factors only — a true
    sub-mesh, with (xi*yi)-way replica groups, so the shrink collective is
    an all-gather within small inner groups instead of a full all-gather to
    every device; the coarsest levels replicate. This is the sub-mesh
    variant of the coarse-grid handling the reference faked entirely
    (reference gpu/multi_gpu_solver.py:574-593); the two-tier
    block->replicated default lives in grid_sharding above."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        mx, my = choose_mesh_shape(len(devices), grid)
        shape = _factor2(mx) + _factor2(my)
    arr = np.asarray(devices[: int(np.prod(shape))]).reshape(shape)
    return Mesh(arr, GRADED_AXES)


def graded_sharding(mesh: Mesh, grid: Grid, min_points_per_device: int = 16):
    """NamedSharding with three tiers per axis: block over (outer, inner)
    while every device keeps >= min_points_per_device logical rows/cols,
    else block over the outer factor only (inner groups replicate), else
    replicated. Requires a mesh from make_graded_mesh."""
    px, py = grid.shape_padded

    def axis_spec(n, p, outer_name, inner_name):
        outer = mesh.shape[outer_name]
        inner = mesh.shape[inner_name]
        full = outer * inner
        if n // full >= min_points_per_device and p % full == 0:
            return (outer_name, inner_name)
        if outer > 1 and n // outer >= min_points_per_device \
                and p % outer == 0:
            return outer_name
        return None

    return NamedSharding(
        mesh,
        P(axis_spec(grid.nx, px, "xo", "xi"),
          axis_spec(grid.ny, py, "yo", "yi")),
    )


def shard_level_arrays(mesh: Mesh, grid: Grid, *arrays, min_points_per_device: int = 16):
    """device_put arrays with the level's sharding."""
    sh = grid_sharding(mesh, grid, min_points_per_device)
    out = tuple(jax.device_put(a, sh) for a in arrays)
    return out if len(out) > 1 else out[0]
