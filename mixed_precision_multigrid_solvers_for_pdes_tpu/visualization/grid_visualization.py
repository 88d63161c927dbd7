"""Grid hierarchy and sharding-layout visualization.

Counterpart of reference visualization/grid_visualization.py:24-384
(GridVisualizer: hierarchy, refinement patterns) plus an addition:
device-partition layout maps for sharded levels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.grid import Grid
from ._backend import finish, get_plt


class GridVisualizer:
    def plot_hierarchy(self, grids: Sequence[Grid], *, max_levels: int = 4,
                       save=None, show=False):
        """Draw the first few levels' point lattices side by side
        (reference grid_visualization.py hierarchy plot)."""
        plt = get_plt()
        shown = list(grids)[:max_levels]
        fig, axes = plt.subplots(1, len(shown),
                                 figsize=(3.2 * len(shown), 3.2),
                                 squeeze=False)
        for k, g in enumerate(shown):
            ax = axes[0][k]
            X, Y = g.coordinates()
            ax.plot(X.ravel(), Y.ravel(), ".", ms=max(1, 6 - k))
            ax.set_title(f"level {k}: {g.nx}x{g.ny}")
            ax.set_aspect("equal")
            ax.set_xticks([]); ax.set_yticks([])
        return finish(fig, save, show)

    def plot_coarsening_path(self, grid: Grid, *, save=None, show=False):
        """Level sizes down the hierarchy (points + memory per level)."""
        plt = get_plt()
        sizes = []
        g = grid
        sizes.append(g.num_points)
        while g.can_coarsen():
            g = g.coarsen()
            sizes.append(g.num_points)
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.semilogy(range(len(sizes)), sizes, "o-")
        ax.set_xlabel("level"); ax.set_ylabel("grid points")
        ax.set_title(f"hierarchy from {grid.nx}x{grid.ny} "
                     f"({len(sizes)} levels)")
        ax.grid(True, alpha=0.3)
        return finish(fig, save, show)

    def plot_sharding_layout(self, grid: Grid, mesh_shape: Tuple[int, int], *,
                             min_points_per_device: int = 16,
                             save=None, show=False):
        """Device-ownership map of a level under an (mx, my) mesh —
        the counterpart of the reference's domain-decomposition diagrams
        (reference multi_gpu_solver.py:342-445 strip/block partitions)."""
        plt = get_plt()
        px, py = grid.shape_padded
        mx, my = mesh_shape
        owner = np.zeros((px, py))
        replicated = (px // mx < min_points_per_device or px % mx or
                      py // my < min_points_per_device or py % my)
        if not replicated:
            bx, by = px // mx, py // my
            for i in range(mx):
                for j in range(my):
                    owner[i * bx:(i + 1) * bx, j * by:(j + 1) * by] = i * my + j
        fig, ax = plt.subplots(figsize=(5.5, 5))
        im = ax.imshow(owner.T, origin="lower", cmap="tab20",
                       interpolation="nearest")
        title = (f"{grid.nx}x{grid.ny} on {mx}x{my} mesh"
                 + (" (replicated: below tile threshold)" if replicated else ""))
        ax.set_title(title)
        ax.axvline(grid.nx - 0.5, c="k", lw=1, ls="--")
        ax.axhline(grid.ny - 0.5, c="k", lw=1, ls="--")
        fig.colorbar(im, ax=ax, label="device")
        return finish(fig, save, show)
