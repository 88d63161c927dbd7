"""Chebyshev polynomial preconditioner — the device-side ILU replacement.

The reference's ILU(k) (reference preconditioning/ilu.py:18-383) earns its
keep by being a stronger-than-Jacobi approximate inverse; its triangular
solves are sequential and hostile to wide SIMD/systolic hardware. The standard
accelerator-native substitute is a Chebyshev polynomial in the Jacobi-scaled
operator: z = p_k(D^{-1}A) D^{-1} r, optimal over [lmin, lmax] estimates of
the spectrum. Pure stencil applies — fuses entirely into the Krylov loop, and
(unlike ILU) stays SPD for CG whenever A is.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops import stencil as st_mod
from ..ops.stencil import Stencil


def laplacian_eig_bounds(nx: int, ny: int, hx: float, hy: float) -> Tuple[float, float]:
    """Spectral bounds of D^{-1}A for the 5-point Laplacian on a (nx, ny) grid
    (reference operators/laplacian.py:126-158 computes the same 1D eigenvalues)."""
    sx = np.sin(np.pi / (2 * (nx - 1))) ** 2
    sy = np.sin(np.pi / (2 * (ny - 1))) ** 2
    wx, wy = 1.0 / hx**2, 1.0 / hy**2
    denom = 2 * wx + 2 * wy
    lmin = (4 * wx * sx + 4 * wy * sy) / denom
    lmax = (4 * wx * (1 - sx) + 4 * wy * (1 - sy)) / denom
    return float(lmin), float(lmax)


def chebyshev(
    st: Stencil,
    unknown,
    *,
    degree: int = 4,
    bounds: Optional[Tuple[float, float]] = None,
    grid=None,
) -> Callable:
    """Degree-``degree`` Chebyshev approximation of (D^{-1}A)^{-1} D^{-1}.

    ``bounds`` are (lmin, lmax) of D^{-1}A; default targets the smoothing
    range [lmax/30, lmax*1.05] (the usual smoother convention) unless exact
    Laplacian bounds are available via ``grid``.
    """
    if bounds is None:
        if grid is not None:
            lmin, lmax = laplacian_eig_bounds(grid.nx, grid.ny, grid.hx, grid.hy)
            lmin = max(lmin, lmax / 30.0)
        else:
            lmin, lmax = 2.0 / 30.0, 2.0
    else:
        lmin, lmax = bounds

    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def apply(r):
        dtype = r.dtype
        rm = jnp.where(unknown, r, jnp.zeros((), dtype))

        def dinv_a(x):
            ax = st_mod.apply(st, x) / st.c
            return jnp.where(unknown, ax, jnp.zeros((), dtype))

        dinv_r = rm / st.c
        # standard Chebyshev iteration for A z = r with zero initial guess
        rho_old = 1.0 / sigma
        z = (1.0 / theta) * dinv_r
        d = z
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv_r - dinv_a(z))
            z = z + d
            rho_old = rho
        return jnp.where(unknown, z, jnp.zeros((), dtype))

    return apply
