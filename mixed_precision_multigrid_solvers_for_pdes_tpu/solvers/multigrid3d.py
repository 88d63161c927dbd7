"""3D geometric multigrid (V/W cycles), jit-first.

3D sibling of solvers/multigrid.py — capability the reference stubbed out
(reference applications/poisson_solver.py:483-557). Shares MultigridConfig;
smoothers are inlined here (weighted Jacobi + red-black GS with 3D parity).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bc3d as bc3
from ..core.bc import BCKind
from ..core.bc3d import BoundarySpec3D
from ..core.grid3d import Grid3D
from ..core.precision import as_dtype
from ..ops import stencil3d as st3, transfer3d
from ..ops.stencil3d import Stencil3D
from .multigrid import MultigridConfig, convergence_factor


@dataclasses.dataclass(frozen=True)
class Level3D:
    stencil: Stencil3D
    grid: Grid3D
    dtype: Any
    spec: BoundarySpec3D = BoundarySpec3D()

    @property
    def unknown(self):
        return st3.unknown_mask3d(self.grid, self.spec)

    @property
    def sync(self):
        return bc3.periodic_sync3d(self.grid, self.spec)


jax.tree_util.register_dataclass(
    Level3D, data_fields=("stencil",), meta_fields=("grid", "dtype", "spec")
)


def _sample_coarse3(field, fine: Grid3D, coarse: Grid3D):
    if field is None or jnp.ndim(field) == 0:
        return field
    c = field[0 : fine.nx : 2, 0 : fine.ny : 2, 0 : fine.nz : 2]
    out = jnp.zeros(coarse.shape_padded, field.dtype)
    return out.at[: coarse.nx, : coarse.ny, : coarse.nz].set(
        c[: coarse.nx, : coarse.ny, : coarse.nz]
    )


def build_hierarchy3d(
    grid: Grid3D,
    spec: BoundarySpec3D = BoundarySpec3D(),
    *,
    a=None,
    lam=0.0,
    dtype=None,
    policy=None,
    cfg: MultigridConfig = MultigridConfig(),
) -> Tuple[Level3D, ...]:
    """Build the 3D level tuple. ``policy`` (a PrecisionPolicy) assigns
    per-level dtypes (fine fp32 / coarse bf16 under 'mixed') exactly like the
    2D build_hierarchy; ``dtype`` sets a uniform one."""
    grids = [grid]
    while grids[-1].can_coarsen() and len(grids) < cfg.max_levels:
        grids.append(grids[-1].coarsen())
    if policy is not None:
        dtypes = policy.level_dtypes(len(grids))
    else:
        dtypes = (as_dtype(dtype if dtype is not None else jnp.float32),
                  ) * len(grids)
    if cfg.coarsening not in ("rediscretize", "galerkin"):
        raise ValueError(f"unknown coarsening {cfg.coarsening!r}")
    levels = []
    a_l, lam_l = a, lam
    st_hi = None  # float64 operator chain for Galerkin RAP
    for i, (g, dt) in enumerate(zip(grids, dtypes)):
        if i == 0 or cfg.coarsening == "rediscretize":
            st = st3.make_stencil3d(g, spec, a=a_l, lam=lam_l, dtype=dt)
            if i == 0 and cfg.coarsening == "galerkin":
                st_hi = st3.make_stencil3d(g, spec, a=a_l, lam=lam_l,
                                           dtype=jnp.float64)
        else:
            # Galerkin: A_c = R A P of the previous level's float64
            # operator (ops/galerkin.py); coarse levels become 27-point
            from ..ops import galerkin as galerkin_mod

            st_hi = galerkin_mod.galerkin_coarse_stencil3d(
                st_hi, grids[i - 1], g, spec)
            st = st_hi.astype(dt)
        levels.append(Level3D(stencil=st, grid=g, dtype=np.dtype(dt),
                              spec=spec))
        if g.can_coarsen():
            gc = g.coarsen()
            a_l = _sample_coarse3(a_l, g, gc)
            lam_l = _sample_coarse3(lam_l, g, gc)
    return tuple(levels)


# --------------------------------------------------------------------------
# smoothing
# --------------------------------------------------------------------------

def _parity3(pshape):
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, pshape, 2)
    return ((i + j + k) & 1) == 0


def smooth3d(st: Stencil3D, u, f, unknown, *, method: str = "rbgs",
             sweeps: int = 2, omega: float = 1.0, sync=None,
             reverse: bool = False):
    om = jnp.asarray(omega, u.dtype)
    if method == "jacobi":

        def body(_, u):
            if sync is not None:
                u = sync(u)
            r = f - st3.apply(st, u)
            return jnp.where(unknown, u + om * r / st.c, u)

    elif method in ("rbgs", "gauss_seidel", "red_black", "sor", "rbgs_rev"):
        red = _parity3(u.shape)
        rev = reverse or method == "rbgs_rev"
        first, second = (~red, red) if rev else (red, ~red)

        def color(u, mask):
            if sync is not None:
                u = sync(u)
            u_gs = (f + st3.neighbor_sum(st, u)) / st.c
            return jnp.where(mask & unknown, u + om * (u_gs - u), u)

        def body(_, u):
            u = color(u, first)
            return color(u, second)

    elif method in ("line_z", "zebra_z"):
        # zebra line relaxation along z (the lane axis): exact batched
        # tridiagonal solves via PCR; x/y couplings lagged. The 3D analogue
        # of the 2D ADI/zebra smoothers (ops/smooth.py:86-161) — essential
        # for z-anisotropic problems and stretched grids.
        from ..ops.tridiag import tridiagonal_solve

        ij = (jax.lax.broadcasted_iota(jnp.int32, u.shape, 0)
              + jax.lax.broadcasted_iota(jnp.int32, u.shape, 1))
        even_lines = (ij & 1) == 0
        dtype = u.dtype
        ones = jnp.ones(u.shape, dtype)
        zero = jnp.zeros((), dtype)

        st_b = st3.coupling(st, (0, 0, -1))
        st_t = st3.coupling(st, (0, 0, 1))

        def line_update(u, mask):
            if sync is not None:
                u = sync(u)
            # keep b/t in the tridiagonal, lag everything else (x/y faces,
            # plus edges/corners for 27-point Galerkin stencils)
            rhs = (f + st3.neighbor_sum(st, u)
                   - st_b * jnp.roll(u, 1, 2) - st_t * jnp.roll(u, -1, 2))
            lo_unknown = jnp.roll(unknown, 1, 2)
            hi_unknown = jnp.roll(unknown, -1, 2)
            lo_c = st_b * ones
            hi_c = st_t * ones
            rhs = rhs + jnp.where(lo_unknown, zero,
                                  lo_c * jnp.roll(u, 1, 2))
            rhs = rhs + jnp.where(hi_unknown, zero,
                                  hi_c * jnp.roll(u, -1, 2))
            dl = jnp.where(unknown & lo_unknown, -lo_c, zero)
            du = jnp.where(unknown & hi_unknown, -hi_c, zero)
            rhs = jnp.where(unknown, rhs, zero)
            d = jnp.where(unknown, st.c * ones, jnp.ones((), dtype))
            z = tridiagonal_solve(dl, d, du, rhs, axis=2)
            return jnp.where(mask & unknown, z, u)

        def body(_, u):
            u = line_update(u, even_lines)
            return line_update(u, ~even_lines)

    else:
        raise ValueError(f"unknown 3D smoother {method!r}")

    if sweeps <= 2:
        for k in range(sweeps):
            u = body(k, u)
        return u
    return jax.lax.fori_loop(0, sweeps, body, u)


# --------------------------------------------------------------------------
# cycles + solve
# --------------------------------------------------------------------------

def _cycle3(levels, u, f, lvl: int, cfg: MultigridConfig, cycle_type: str,
            constrain=None):
    lev = levels[lvl]
    unknown = lev.unknown
    sync = lev.sync
    if lvl == len(levels) - 1:
        return smooth3d(lev.stencil, u, f, unknown, method="rbgs",
                        sweeps=cfg.coarse_sweeps, omega=1.0, sync=sync)

    u = smooth3d(lev.stencil, u, f, unknown, method=cfg.smoother,
                 sweeps=cfg.pre_sweeps, omega=cfg.omega, sync=sync)
    nxt = levels[lvl + 1]
    plain = all(
        lev.spec.side(s).kind in (BCKind.DIRICHLET, BCKind.PERIODIC)
        for s in bc3.SIDES3D
    )
    wrap = tuple(
        lev.spec.side(s).kind == BCKind.PERIODIC
        for s in ("west", "south", "bottom")
    )
    r = st3.residual(lev.stencil, u, f, unknown, sync)
    if any(wrap):
        r = sync(r)
    fc = transfer3d.restrict3d(
        r, nxt.grid.nx, nxt.grid.ny, nxt.grid.nz, nxt.grid.shape_padded,
        method="full_weighting", boundary="zero" if plain else "reflect",
        dtype=nxt.dtype, wrap=wrap,
    )
    if constrain is not None:
        fc = constrain(fc, nxt)
    if not plain:
        fc = jnp.where(nxt.unknown, fc, jnp.zeros((), fc.dtype))
    ec = jnp.zeros(nxt.grid.shape_padded, nxt.dtype)
    branch = cycle_type if lvl + 1 < cfg.w_depth else "V"
    ec = _cycle3(levels, ec, fc, lvl + 1, cfg, branch, constrain)
    if cycle_type == "W" and branch == "W":
        ec = _cycle3(levels, ec, fc, lvl + 1, cfg, "W", constrain)
    if any(wrap):
        ec = nxt.sync(ec)
    e = transfer3d.prolong3d(
        ec, nxt.grid.nx, nxt.grid.ny, nxt.grid.nz,
        lev.grid.nx, lev.grid.ny, lev.grid.nz, lev.grid.shape_padded,
        dtype=lev.dtype,
    )
    if constrain is not None:
        e = constrain(e, lev)
    u = jnp.where(unknown, u + e, u)
    u = smooth3d(lev.stencil, u, f, unknown, method=cfg.smoother,
                 sweeps=cfg.post_sweeps, omega=cfg.omega, sync=sync,
                 reverse=cfg.symmetric and cfg.smoother in
                 ("rbgs", "gauss_seidel", "red_black", "sor"))
    return u


def mg_cycle3d(levels, u, f, cfg: MultigridConfig = MultigridConfig(),
               constrain=None):
    return _cycle3(levels, u, f, 0, cfg, cfg.cycle, constrain)


def _norm3(r, g: Grid3D):
    r64 = r.astype(jnp.float64)
    return jnp.sqrt(g.hx * g.hy * g.hz * jnp.sum(r64 * r64))


@partial(jax.jit, static_argnames=("cfg", "constrain"))
def _solve3_jit(levels, f, u0, cfg: MultigridConfig, constrain=None):
    lev0 = levels[0]
    unknown = lev0.unknown
    sync0 = lev0.sync
    g = lev0.grid
    f = f.astype(lev0.dtype)
    u = u0.astype(lev0.dtype)
    fnorm = _norm3(jnp.where(unknown, f, jnp.zeros((), f.dtype)), g)
    r0 = st3.residual(lev0.stencil, u, f, unknown, sync0)
    rnorm0 = _norm3(r0, g)
    tol_eff = jnp.where(
        jnp.asarray(cfg.rtol),
        cfg.tol * jnp.maximum(jnp.maximum(fnorm, rnorm0), 1e-300), cfg.tol)
    hist = jnp.full((cfg.max_iterations + 1,), jnp.nan, jnp.float64)
    hist = hist.at[0].set(rnorm0)

    def cond(c):
        _, k, rnorm, _ = c
        return (rnorm > tol_eff) & (k < cfg.max_iterations)

    def body(c):
        u, k, rnorm, hist = c
        u = mg_cycle3d(levels, u, f, cfg, constrain)
        r = st3.residual(lev0.stencil, u, f, unknown, sync0)
        rnorm = _norm3(r, g)
        hist = hist.at[k + 1].set(rnorm)
        return (u, k + 1, rnorm, hist)

    u, k, rnorm, hist = jax.lax.while_loop(
        cond, body, (u, jnp.asarray(0, jnp.int32), rnorm0, hist)
    )
    if sync0 is not None:
        u = sync0(u)
    # single packed stats buffer -> single host readback (see multigrid.py)
    stats = jnp.stack([
        k.astype(jnp.float64), rnorm, rnorm0, fnorm,
        (rnorm <= tol_eff).astype(jnp.float64),
    ])
    return u, jnp.concatenate([stats, hist])


@partial(jax.jit, static_argnames=("cfg", "inner_cycles", "max_outer",
                                   "constrain"))
def _ir3_jit(levels, st_hi, f, u0, cfg: MultigridConfig, inner_cycles: int,
             max_outer: int, constrain=None):
    lev0 = levels[0]
    unknown = lev0.unknown
    sync0 = lev0.sync
    g = lev0.grid
    lo = lev0.dtype
    _pin = (lambda v: constrain(v, lev0)) if constrain is not None \
        else (lambda v: v)
    f = f.astype(jnp.float64)
    u = _pin(u0.astype(jnp.float64))
    fnorm = _norm3(jnp.where(unknown, f, jnp.zeros((), f.dtype)), g)
    rnorm0 = _norm3(st3.residual(st_hi, u, f, unknown, sync0), g)
    tol_eff = jnp.where(
        jnp.asarray(cfg.rtol),
        cfg.tol * jnp.maximum(jnp.maximum(fnorm, rnorm0), 1e-300), cfg.tol)
    hist = jnp.full((max_outer + 1,), jnp.nan, jnp.float64)
    hist = hist.at[0].set(rnorm0)

    def cond(c):
        _, k, rnorm, _ = c
        return (rnorm > tol_eff) & (k < max_outer)

    def body(c):
        u, k, rnorm, hist = c
        r = st3.residual(st_hi, u, f, unknown, sync0)
        e = jnp.zeros(g.shape_padded, lo)
        r_lo = r.astype(lo)
        for _ in range(inner_cycles):
            e = mg_cycle3d(levels, e, r_lo, cfg, constrain)
        u = _pin(jnp.where(unknown, u + e.astype(jnp.float64), u))
        rnorm = _norm3(st3.residual(st_hi, u, f, unknown, sync0), g)
        hist = hist.at[k + 1].set(rnorm)
        return (u, k + 1, rnorm, hist)

    u, k, rnorm, hist = jax.lax.while_loop(
        cond, body, (u, jnp.asarray(0, jnp.int32), rnorm0, hist))
    stats = jnp.stack([
        k.astype(jnp.float64), rnorm, rnorm0, fnorm,
        (rnorm <= tol_eff).astype(jnp.float64),
    ])
    return u, jnp.concatenate([stats, hist])


def ir_solve3d(
    levels: Tuple[Level3D, ...],
    f,
    u0=None,
    cfg: MultigridConfig = MultigridConfig(),
    *,
    inner_cycles: int = 2,
    max_outer: int = 100,
    constrain=None,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    """3D mixed-precision solve: fp64 outer residuals over low-precision
    cycles (3D sibling of solvers.refinement.ir_solve). ``constrain``
    threads 3D sharding constraints through the inner cycles and the fp64
    outer state (parallel.distributed.make_constrainer3d)."""
    lev0 = levels[0]
    if u0 is None:
        u0 = jnp.zeros(lev0.grid.shape_padded, jnp.float64)
    st_hi = lev0.stencil.astype(jnp.float64)
    u, packed = _ir3_jit(levels, st_hi, f, u0, cfg, inner_cycles, max_outer,
                         constrain)
    from .multigrid import _unpack_info

    out = _unpack_info(np.asarray(packed))
    out["method"] = "iterative_refinement_3d"
    return u, out


def mg_solve3d(
    levels: Tuple[Level3D, ...],
    f,
    u0=None,
    cfg: MultigridConfig = MultigridConfig(),
    *,
    constrain=None,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    if u0 is None:
        u0 = jnp.zeros(levels[0].grid.shape_padded, levels[0].dtype)
    from .multigrid import _unpack_info

    u, packed = _solve3_jit(levels, f, u0, cfg, constrain)
    return u, _unpack_info(np.asarray(packed))
