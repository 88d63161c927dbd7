"""Visualization suite (matplotlib, headless-safe).

Counterpart of reference src/multigrid/visualization/ (8 modules,
visualization/__init__.py:19-60): solution surfaces/contours/error maps,
convergence histories, performance comparisons, grid hierarchies, analysis
plots, interactive exploration, and a solver dashboard. All figure functions
return the Figure and accept ``save=path``; the matplotlib import is deferred
and forced to Agg when no display is present, so nothing here can break a
headless host.
"""

from .solution_plots import SolutionVisualizer  # noqa: F401
from .convergence_plots import ConvergencePlotter  # noqa: F401
from .performance_plots import PerformancePlotter  # noqa: F401
from .grid_visualization import GridVisualizer  # noqa: F401
from .analysis_plots import AnalysisVisualizer  # noqa: F401
from .interactive_plots import InteractivePlotter  # noqa: F401
from .dashboard import SolverDashboard  # noqa: F401
