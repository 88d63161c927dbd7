from . import multigrid  # noqa: F401
from .multigrid import (  # noqa: F401
    Level,
    MultigridConfig,
    build_hierarchy,
    convergence_factor,
    fmg,
    mg_cycle,
    mg_solve,
)
from . import refinement  # noqa: F401
from .refinement import adaptive_solve, adaptive_solve3d, ir_solve  # noqa: F401
from . import iterative, krylov, multigrid3d  # noqa: F401
from .multigrid3d import build_hierarchy3d, mg_cycle3d, mg_solve3d  # noqa: F401
from .iterative import iterative_solve  # noqa: F401
from .krylov import bicgstab, gmres, pcg, stencil_matvec  # noqa: F401
