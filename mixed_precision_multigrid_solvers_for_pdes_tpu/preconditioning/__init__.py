"""Preconditioners for the Krylov layer (solvers.krylov).

Counterpart of the reference preconditioning package
(reference preconditioning/base.py, diagonal.py, ilu.py,
multigrid_preconditioner.py), re-designed as pure callables z = M(r) that jit
into the Krylov loop. The reference's ILU — an inherently sequential
triangular-solve preconditioner — is kept for parity as a host/CPU path and
superseded on the device by the Chebyshev polynomial preconditioner (same
role: stronger-than-Jacobi smoothing of the residual, but expressed as
stencil applies that run in parallel).
"""

from .base import (  # noqa: F401
    AdaptivePreconditioner,
    composite,
    identity,
)
from .chebyshev import chebyshev  # noqa: F401
from .diagonal import block_line, diagonal, scaled_diagonal  # noqa: F401
from .ilu import ILUKPreconditioner, ILUPreconditioner  # noqa: F401
from .multigrid_preconditioner import (  # noqa: F401
    multigrid_preconditioner,
    multigrid_preconditioner3d,
)
