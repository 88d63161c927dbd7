"""Smoothers as whole-array XLA operations.

Re-design of the reference smoother zoo
(reference solvers/smoothers.py:16-285, iterative.py:72-362,
gpu/cuda_kernels.py:87-275):

- weighted Jacobi (default omega=4/5, the reference's WeightedJacobiSmoother
  choice, reference smoothers.py:210)
- red-black Gauss-Seidel (color-masked, matches the CUDA
  red_black_gauss_seidel_kernel semantics, reference cuda_kernels.py:147-177)
- SOR = red-black GS with over-relaxation (reference cuda_kernels.py:180-211),
  with the optimal omega* = 2/(1+sin(pi*h)) helper
  (reference iterative.py:285-300)

All smoothers are pure functions ``(stencil, u, f, unknown, ...) -> u`` with a
static sweep count, so the whole smoothing stage stays inside one jitted
computation (the reference GPU path synchronized per kernel launch,
reference cuda_kernels.py:346 — the #1 perf bug this design removes).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from . import stencil as st_mod
from .stencil import Stencil, shift_e, shift_n, shift_s, shift_w


def optimal_sor_omega(nx: int, ny: int) -> float:
    """omega* = 2/(1+sin(pi*h)) for the 5-point Laplacian
    (reference iterative.py:285-300)."""
    h = 1.0 / (max(nx, ny) - 1)
    return 2.0 / (1.0 + math.sin(math.pi * h))


def optimal_jacobi_omega() -> float:
    """Damped-Jacobi smoothing optimum for the 2D 5-point Laplacian (4/5)."""
    return 0.8


def _parity(pshape):
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    return (i + j) % 2 == 0


def jacobi_sweep(st: Stencil, u, f, unknown, omega, sync=None):
    """One weighted-Jacobi sweep: u += omega * (f - A u) / diag, masked."""
    if sync is not None:
        u = sync(u)
    r = f - st_mod.apply(st, u)
    u_new = u + jnp.asarray(omega, u.dtype) * r / st.c
    return jnp.where(unknown, u_new, u)


def rb_color_update(st: Stencil, u, f, unknown, color_mask, omega, sync=None):
    """Gauss-Seidel update of one color: u = (f + neighbor_sum)/c, relaxed."""
    if sync is not None:
        u = sync(u)
    u_gs = (f + st_mod.neighbor_sum(st, u)) / st.c
    omega = jnp.asarray(omega, u.dtype)
    u_new = u + omega * (u_gs - u)
    return jnp.where(color_mask & unknown, u_new, u)


def rbgs_sweep(st: Stencil, u, f, unknown, omega=1.0, sync=None,
               reverse: bool = False):
    """One red-black Gauss-Seidel sweep (red then black; black then red with
    ``reverse`` — the adjoint ordering that makes pre+post smoothing a
    symmetric operator for CG preconditioning).

    Black updates see the freshly-updated red values — true GS ordering, same
    as reference cuda_kernels.py:147-177 launched per color.

    NOTE on periodic axes: the unique extent n-1 is ODD for 2^k+1 grids, so
    the red/black parity pattern has a color seam at the wrap — updates there
    are Jacobi-like across the seam, which only perturbs the smoothing factor
    marginally (the seam is a measure-zero line).
    """
    red = _parity(u.shape)
    first, second = (~red, red) if reverse else (red, ~red)
    u = rb_color_update(st, u, f, unknown, first, omega, sync)
    u = rb_color_update(st, u, f, unknown, second, omega, sync)
    return u


def _line_update(st: Stencil, u, f, unknown, axis: int, color_mask,
                 sync=None, cyclic_n: int = 0):
    """Zebra line relaxation: exact tridiagonal solve along ``axis`` for the
    lines selected by ``color_mask``, cross-direction couplings lagged.

    Anisotropic problems defeat point smoothers (measured rho 0.87 for
    hy/hx = 0.1 with RB-GS); lines along the strong coupling restore rho ~ 0.1
    (the reference had no line smoother — its anisotropic numbers came from
    the simulated path, reference benchmarks/validation_suite.py:256-300).
    Batched ``tridiagonal_solve`` maps every line onto one fused device op.

    ``sync`` refreshes periodic wrap ghosts before the lagged cross-direction
    reads. ``cyclic_n > 0`` marks the LINE axis itself periodic with
    ``cyclic_n`` unique nodes: the solve runs as a cyclic tridiagonal
    (Sherman-Morrison over PCR) on the sliced core.
    """
    from .tridiag import cyclic_tridiagonal_solve, tridiagonal_solve

    if sync is not None:
        u = sync(u)
    dtype = u.dtype
    ones = jnp.ones(u.shape, dtype)
    c = st.c * ones
    zero = jnp.zeros((), dtype)
    if axis == 1:
        # solve along y: keep s/n in the tridiagonal, lag everything else
        # (w/e, plus corners for 9-point Galerkin stencils)
        lo_val, hi_val = shift_s(u), shift_n(u)
        rhs = f + st_mod.neighbor_sum(st, u) - st.s * lo_val - st.n * hi_val
        lo_unknown = jnp.roll(unknown, 1, 1)   # is (i, j-1) an unknown?
        hi_unknown = jnp.roll(unknown, -1, 1)
        lo_c, hi_c = st.s * ones, st.n * ones
    else:
        # solve along x: keep w/e, lag everything else
        lo_val, hi_val = shift_w(u), shift_e(u)
        rhs = f + st_mod.neighbor_sum(st, u) - st.w * lo_val - st.e * hi_val
        lo_unknown = jnp.roll(unknown, 1, 0)
        hi_unknown = jnp.roll(unknown, -1, 0)
        lo_c, hi_c = st.w * ones, st.e * ones

    if cyclic_n:
        # periodic line axis: the cyclic system lives on the unique nodes
        # 0..cyclic_n-1 (all unknowns along the line); corners wrap
        sl = [slice(None)] * u.ndim
        sl[axis] = slice(0, cyclic_n)
        sl = tuple(sl)
        z_core = cyclic_tridiagonal_solve(
            (-lo_c)[sl], c[sl], (-hi_c)[sl], rhs[sl], axis=axis)
        pad = [(0, 0)] * u.ndim
        pad[axis] = (0, u.shape[axis] - cyclic_n)
        z = jnp.pad(z_core, pad)
        return jnp.where(color_mask & unknown, z, u)

    # couplings to FIXED line neighbors (Dirichlet ring values) move to the
    # rhs; couplings to unknown neighbors stay in the tridiagonal
    rhs = rhs + jnp.where(lo_unknown, zero, lo_c * lo_val)
    rhs = rhs + jnp.where(hi_unknown, zero, hi_c * hi_val)
    dl = jnp.where(lo_unknown, -lo_c, zero)
    du = jnp.where(hi_unknown, -hi_c, zero)
    # identity rows off the unknown set keep fixed/padding nodes untouched
    rhs = jnp.where(unknown, rhs, zero)
    dl = jnp.where(unknown, dl, zero)
    du = jnp.where(unknown, du, zero)
    d = jnp.where(unknown, c, jnp.ones((), dtype))
    z = tridiagonal_solve(dl, d, du, rhs, axis=axis)
    return jnp.where(color_mask & unknown, z, u)


def line_sweep(st: Stencil, u, f, unknown, axis: int, sync=None,
               cyclic_n: int = 0):
    """One zebra line-GS sweep along ``axis`` (even lines, then odd)."""
    perp = 1 - axis
    idx = jax.lax.broadcasted_iota(jnp.int32, u.shape, perp)
    even = (idx & 1) == 0
    u = _line_update(st, u, f, unknown, axis, even, sync, cyclic_n)
    u = _line_update(st, u, f, unknown, axis, ~even, sync, cyclic_n)
    return u


def chebyshev_smooth(st: Stencil, u, f, unknown, *, degree: int = 3,
                     sync=None, spectrum_fraction: float = 0.25):
    """Degree-``degree`` Chebyshev polynomial smoother on the Jacobi-scaled
    operator, targeting the upper spectrum [fraction*lmax, lmax].

    Colorless (one global polynomial instead of red/black masks), so it has
    no periodic-seam caveat and maps cleanly onto SPMD meshes — the "optimal
    polynomial smoother" construction from the parallel-AMG literature
    (Optimal Polynomial Smoothers for Parallel AMG, arXiv:2407.09848).
    lmax = 2 is a Gershgorin bound for D^-1 A whenever c >= sum of couplings
    (true for every SPD operator this framework builds).
    """
    dtype = u.dtype
    lmax = 2.0
    lmin = spectrum_fraction * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def dinv_a(x):
        if sync is not None:
            x = sync(x)
        ax = st_mod.apply(st, x) / st.c
        return jnp.where(unknown, ax, jnp.zeros((), dtype))

    if sync is not None:
        u = sync(u)
    r = jnp.where(unknown, f - st_mod.apply(st, u), jnp.zeros((), dtype))
    dinv_r = r / st.c
    rho_old = 1.0 / sigma
    z = (1.0 / theta) * dinv_r
    d = z
    for _ in range(degree - 1):
        rho = 1.0 / (2.0 * sigma - rho_old)
        d = (rho * rho_old) * d + (2.0 * rho / delta) * (dinv_r - dinv_a(z))
        z = z + d
        rho_old = rho
    return jnp.where(unknown, u + z, u)


def smooth(st: Stencil, u, f, unknown, *, method: str = "jacobi",
           sweeps: int = 2, omega: float = 0.8, sync=None,
           cyclic_axes=None):
    """Run ``sweeps`` smoothing sweeps (static count -> unrolled/fori_loop).

    ``cyclic_axes``: (nx_unique_or_0, ny_unique_or_0) — per-axis periodic
    unique-node counts for the line smoothers (0 = not periodic)."""
    if method == "chebyshev":
        # the sweep count is the polynomial degree: one pass, degree=2*sweeps
        # costs the same stencil applies as `sweeps` RB-GS sweeps
        return chebyshev_smooth(st, u, f, unknown, degree=2 * sweeps,
                                sync=sync)
    if method == "jacobi":
        body = lambda _, u: jacobi_sweep(st, u, f, unknown, omega, sync)
    elif method in ("rbgs", "gauss_seidel", "red_black", "sor"):
        body = lambda _, u: rbgs_sweep(st, u, f, unknown, omega, sync)
    elif method == "rbgs_rev":  # adjoint color order (symmetric cycles)
        body = lambda _, u: rbgs_sweep(st, u, f, unknown, omega, sync,
                                       reverse=True)
    elif method in ("line_x", "line_y", "adi"):
        # periodic axes: the line axis solves a cyclic tridiagonal system
        # (Sherman-Morrison over PCR); cross-axis wraps come via sync
        cyc_x = cyclic_axes[0] if cyclic_axes else 0
        cyc_y = cyclic_axes[1] if cyclic_axes else 0
        if method == "line_x":
            body = lambda _, u: line_sweep(st, u, f, unknown, 0, sync, cyc_x)
        elif method == "line_y":
            body = lambda _, u: line_sweep(st, u, f, unknown, 1, sync, cyc_y)
        else:
            body = lambda _, u: line_sweep(
                st, line_sweep(st, u, f, unknown, 1, sync, cyc_y),
                f, unknown, 0, sync, cyc_x)
    else:
        raise ValueError(f"unknown smoother {method!r}")
    if sweeps <= 2:
        for k in range(sweeps):
            u = body(k, u)
        return u
    return jax.lax.fori_loop(0, sweeps, body, u)
