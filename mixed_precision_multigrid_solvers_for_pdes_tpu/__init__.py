"""Mixed-precision geometric multigrid solvers for PDEs, in JAX.

A JAX/XLA framework with the capabilities of the reference
``Mixed_Precision_Multigrid_Solvers_for_PDEs`` project (CPU/CUDA, see
reference src/multigrid/__init__.py), re-designed as whole-solve jitted
programs for an accelerator (NVIDIA H100):

- One functional multigrid driver (V/W/F-cycles, FMG) jitted end-to-end,
  replacing the reference's five parallel driver implementations
  (reference solvers/multigrid.py:28, corrected_multigrid.py:24,
  advanced_multigrid.py:36, gpu/gpu_solver.py:24,504).
- A single parameterized stencil operator ``-div(a grad u) + lam*u`` covering
  Poisson, Helmholtz, variable coefficients and implicit heat steps.
- Smoothing, residuals and transfers as whole-array XLA operations that
  the compiler fuses, replacing the reference's CUDA-C string kernels
  (reference gpu/cuda_kernels.py).
- Mixed precision as dtype-static stages + iterative refinement (bf16/fp32
  cycles, fp64 residual accumulation), replacing PrecisionManager /
  GPUPrecisionManager (reference core/precision.py:18, gpu/gpu_precision.py:28).
- Distribution via jax.sharding.Mesh + shard_map + ppermute halo exchange,
  replacing the reference's CuPy thread-driven multi-GPU code
  (reference gpu/multi_gpu_solver.py:67).

float64 is enabled globally (explicit fp32/bf16 arrays are unaffected)
because high-accuracy residual norms and coarse-grid math need it.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

__version__ = "0.1.0"

from . import core, ops, solvers, models, parallel, utils  # noqa: E402,F401
from . import applications, preconditioning  # noqa: E402,F401
from .core.grid import Grid  # noqa: E402,F401
from .core.precision import Precision, PrecisionPolicy  # noqa: E402,F401
from .solvers.multigrid import (  # noqa: E402,F401
    MultigridConfig,
    build_hierarchy,
    mg_solve,
    mg_cycle,
)
from .models.problems import Problem, poisson_mms_sinsin  # noqa: E402,F401
from .core.grid3d import Grid3D  # noqa: E402,F401
from .solvers.multigrid3d import (  # noqa: E402,F401
    build_hierarchy3d,
    mg_solve3d,
)
