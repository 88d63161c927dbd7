"""Galerkin (RAP) coarse-grid operators.

``A_c = R M_f A M_f P`` where R/P are the cycle's actual restriction and
prolongation and ``M_f`` masks to the fine unknown set — i.e. exactly the
operator the two-grid correction applies. Rediscretization (the default,
and the reference's implicit choice — it reuses the analytic stencil at
every level, reference solvers/multigrid.py:135-182) approximates A_c well
for smooth coefficients, but for strong coefficient jumps the injected
coarse coefficients misplace the interface and the coarse correction stops
matching the fine operator; Galerkin coarsening fixes that by construction.

Matrix-free implementation: instead of assembling sparse matrices, the nine
coarse stencil coefficient *fields* are recovered from nine applications of
the composed grid-operator ``R M A M P`` to mod-3 comb fields — combs of
unit impulses spaced 3 coarse cells apart. The composed operator has coarse
support radius <= 1 (Chebyshev), so within any 3x3 coarse neighborhood each
comb phase isolates exactly one matrix entry:

    (A_c)_{J, J+d} = (R M A M P chi_p)[J]   with  p = (J+d) mod 3.

Each application is pure fine-grid work (prolong/apply/restrict — the same
jitted ops the cycle uses), so setup is 9 transfer passes per level, runs
entirely on device, and needs no scatter/gather or sparse formats.

The coarse operator of a 5-point stencil under full-weighting + bilinear is
9-point (Stencil9), and 9-point is closed under further RAP, so the whole
hierarchy below the fine level is Stencil9.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from ..core import bc as bc_mod
from ..core.bc import BCKind
from ..core.grid import Grid
from . import stencil as st_mod
from . import transfer
from .stencil import _S9_FIELDS, Stencil, Stencil9


def _unknown(grid: Grid, spec, domain):
    mask = bc_mod.unknown_mask(grid.nx, grid.ny, grid.shape_padded, spec)
    if domain is not None:
        mask = mask & domain.interior_mask(grid)
    return mask


@lru_cache(maxsize=128)
def _rap_program(grid_f: Grid, grid_c: Grid, spec, domain, dtype_str: str,
                 restriction: str, prolongation: str, nine: bool):
    """One jitted program per (level shapes, config): takes the fine stencil
    leaves, runs all nine comb phases as a single vmapped batch (combs built
    in-jit from iota — no host traffic), and extracts the nine coarse
    coefficient planes. Per level this is ONE compile and ONE device
    execution (not a fresh jit, nine dispatches and an eager extraction)."""
    dtype = jnp.dtype(dtype_str)
    pc = grid_c.shape_padded
    unk_f = _unknown(grid_f, spec, domain)
    unk_c = _unknown(grid_c, spec, domain)
    boundary = ("zero" if spec.all_dirichlet
                else "reflect")  # mirrors solvers/multigrid.py
    zero = jnp.zeros((), dtype)

    @jax.jit
    def run(*leaves):
        st_hi = (Stencil9(*leaves) if nine else Stencil(*leaves))
        Ic = jax.lax.broadcasted_iota(jnp.int32, pc, 0)
        Jc = jax.lax.broadcasted_iota(jnp.int32, pc, 1)
        phase = jnp.arange(9, dtype=jnp.int32)
        chis = ((Ic[None] % 3 == phase[:, None, None] // 3)
                & (Jc[None] % 3 == phase[:, None, None] % 3)
                & unk_c[None]).astype(dtype)

        def rap_phase(chi):
            ef = transfer.prolong(
                chi, grid_c.nx, grid_c.ny, grid_f.nx, grid_f.ny,
                grid_f.shape_padded, method=prolongation, dtype=dtype,
            )
            ef = jnp.where(unk_f, ef, zero)
            ae = jnp.where(unk_f, st_mod.apply(st_hi, ef), zero)
            y = transfer.restrict(
                ae, grid_c.nx, grid_c.ny, pc,
                method=restriction, boundary=boundary, dtype=dtype,
            )
            return jnp.where(unk_c, y, zero)

        # (9, pcx, pcy): Y[3*px+py] = R M A M P chi_{(px,py)}
        Y = jax.vmap(rap_phase)(chis)

        def coef(dx: int, dy: int):
            # (A_c)_{J, J+d}: pick the phase isolating offset d at each J
            idx = ((Ic + dx) % 3) * 3 + (Jc + dy) % 3
            return jnp.take_along_axis(Y, idx[None], axis=0)[0]

        def off(dx: int, dy: int):
            return jnp.where(unk_c, -coef(dx, dy), zero)

        c = jnp.where(unk_c, coef(0, 0), jnp.ones((), dtype))
        return (c, off(-1, 0), off(1, 0), off(0, -1), off(0, 1),
                off(-1, -1), off(1, -1), off(-1, 1), off(1, 1))

    return run


def galerkin_coarse_stencil(
    st_f,
    grid_f: Grid,
    grid_c: Grid,
    spec,
    *,
    domain=None,
    dtype=jnp.float64,
    restriction: str = "full_weighting",
    prolongation: str = "bilinear",
) -> Stencil9:
    """Coarse Stencil9 = RAP of ``st_f`` (Stencil or Stencil9).

    ``restriction``/``prolongation`` must match the cycle's transfer config
    so the coarse equation ``A_c e_c = R r`` uses one consistent R.
    Computed at ``dtype`` (float64 default; float32 via
    MultigridConfig.galerkin_dtype, validated to leave the jump-problem
    cycle factor unchanged), cast by the caller to the level's working
    dtype.
    """
    if spec.any_periodic:
        # the mod-3 comb phases alias across a periodic seam whenever the
        # unique extent is not divisible by 3 (always, for 2^k+1 grids)
        raise NotImplementedError(
            "Galerkin coarsening does not support periodic BCs; "
            "use coarsening='rediscretize'"
        )
    nine = isinstance(st_f, Stencil9)
    run = _rap_program(grid_f, grid_c, spec, domain,
                       jnp.dtype(dtype).name, restriction, prolongation,
                       nine)
    st_hi = st_f.astype(dtype)
    leaves = tuple(getattr(st_hi, k)
                   for k in (_S9_FIELDS if nine else ("c", "w", "e", "s", "n")))
    out = run(*leaves)
    return Stencil9(*out)


@lru_cache(maxsize=64)
def _rap_program3d(grid_f, grid_c, spec, dtype_str: str, n27: bool):
    """3D analogue of _rap_program: 27 comb phases as one vmapped batch in
    one jitted program per level."""
    from . import stencil3d as st3, transfer3d
    from .stencil3d import OFFSETS27, Stencil27
    from .stencil3d import Stencil3D

    dtype = jnp.dtype(dtype_str)
    pc = grid_c.shape_padded
    unk_f = st3.unknown_mask3d(grid_f, spec)
    unk_c = st3.unknown_mask3d(grid_c, spec)
    boundary = ("zero" if spec.all_dirichlet
                else "reflect")  # mirrors solvers/multigrid3d
    zero = jnp.zeros((), dtype)

    @jax.jit
    def run(*leaves):
        st_hi = Stencil27(*leaves) if n27 else Stencil3D(*leaves)
        Ic = jax.lax.broadcasted_iota(jnp.int32, pc, 0)
        Jc = jax.lax.broadcasted_iota(jnp.int32, pc, 1)
        Kc = jax.lax.broadcasted_iota(jnp.int32, pc, 2)
        phase = jnp.arange(27, dtype=jnp.int32)[:, None, None, None]
        chis = ((Ic[None] % 3 == phase // 9)
                & (Jc[None] % 3 == (phase // 3) % 3)
                & (Kc[None] % 3 == phase % 3)
                & unk_c[None]).astype(dtype)

        def rap_phase(chi):
            ef = transfer3d.prolong3d(
                chi, grid_c.nx, grid_c.ny, grid_c.nz,
                grid_f.nx, grid_f.ny, grid_f.nz, grid_f.shape_padded,
                dtype=dtype,
            )
            ef = jnp.where(unk_f, ef, zero)
            ae = jnp.where(unk_f, st3.apply(st_hi, ef), zero)
            y = transfer3d.restrict3d(
                ae, grid_c.nx, grid_c.ny, grid_c.nz, pc,
                method="full_weighting", boundary=boundary, dtype=dtype,
            )
            return jnp.where(unk_c, y, zero)

        Y = jax.vmap(rap_phase)(chis)  # (27, pcx, pcy, pcz)

        def coef(dx: int, dy: int, dz: int):
            idx = (((Ic + dx) % 3) * 9 + ((Jc + dy) % 3) * 3 + (Kc + dz) % 3)
            return jnp.take_along_axis(Y, idx[None], axis=0)[0]

        c = jnp.where(unk_c, coef(0, 0, 0), jnp.ones((), dtype))
        off = jnp.stack([
            jnp.where(unk_c, -coef(*d), zero) for d in OFFSETS27
        ])
        return c, off

    return run


def galerkin_coarse_stencil3d(
    st_f,
    grid_f,
    grid_c,
    spec,
    *,
    dtype=jnp.float64,
):
    """3D RAP: coarse Stencil27 of ``st_f`` (Stencil3D or Stencil27) under
    full-weighting restriction + trilinear prolongation.

    Same mod-3 comb construction as the 2D version, with 27 phases: the
    composed ``R M A M P`` operator has coarse support radius <= 1
    (Chebyshev) for both 7-point and 27-point fine operators, so each phase
    isolates one matrix entry per 3x3x3 coarse neighborhood.
    """
    from .stencil3d import Stencil27

    if spec.any_periodic:
        raise NotImplementedError(
            "Galerkin coarsening does not support periodic BCs; "
            "use coarsening='rediscretize'"
        )
    n27 = isinstance(st_f, Stencil27)
    run = _rap_program3d(grid_f, grid_c, spec, jnp.dtype(dtype).name, n27)
    st_hi = st_f.astype(dtype)
    leaves = ((st_hi.c, st_hi.off) if n27
              else tuple(getattr(st_hi, k)
                         for k in ("c", "w", "e", "s", "n", "b", "t")))
    c, off = run(*leaves)
    return Stencil27(c=c, off=off)
