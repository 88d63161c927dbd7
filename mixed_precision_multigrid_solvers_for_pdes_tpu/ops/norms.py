"""Grid norms with high-precision accumulation.

Matches reference core/grid.py:174 (scaled L2: sqrt(hx*hy*sum(f^2))) and the
max norm, but always accumulates in float64 — the
algorithmic replacement for the reference's fp32-state/fp64-accumulate CUDA
residual kernel (reference cuda_kernels.py:843-883). Inputs are padded arrays
whose padding/fixed cells are zero, so whole-array reductions are exact.
"""

from __future__ import annotations

import jax.numpy as jnp


def scaled_l2(r, hx: float, hy: float, *, accum_dtype=jnp.float64):
    r64 = r.astype(accum_dtype)
    return jnp.sqrt(hx * hy * jnp.sum(r64 * r64))


def l2(r, *, accum_dtype=jnp.float64):
    r64 = r.astype(accum_dtype)
    return jnp.sqrt(jnp.sum(r64 * r64))


def max_norm(r):
    return jnp.max(jnp.abs(r))


def masked_scaled_l2(r, mask, hx: float, hy: float, *, accum_dtype=jnp.float64):
    r64 = jnp.where(mask, r, jnp.zeros((), r.dtype)).astype(accum_dtype)
    return jnp.sqrt(hx * hy * jnp.sum(r64 * r64))


def h1_seminorm(e, mask, hx: float, hy: float, *, accum_dtype=jnp.float64):
    """Discrete H1 seminorm sqrt(hx*hy * sum |grad_h e|^2) by forward
    differences, counting only edges whose BOTH endpoints are valid nodes
    (reference poisson_solver.py:281-313 computes an H1-semi error the same
    finite-difference way, without the masking — masking makes it correct on
    padded arrays and irregular domains)."""
    e64 = jnp.where(mask, e, jnp.zeros((), e.dtype)).astype(accum_dtype)
    ex = (e64[1:, :] - e64[:-1, :]) / hx
    ey = (e64[:, 1:] - e64[:, :-1]) / hy
    mx = mask[1:, :] & mask[:-1, :]
    my = mask[:, 1:] & mask[:, :-1]
    sx = jnp.sum(jnp.where(mx, ex * ex, 0.0))
    sy = jnp.sum(jnp.where(my, ey * ey, 0.0))
    return jnp.sqrt(hx * hy * (sx + sy))


def h1_seminorm3d(e, mask, hx: float, hy: float, hz: float, *,
                  accum_dtype=jnp.float64):
    """3D analogue of :func:`h1_seminorm` (forward differences per axis,
    both-endpoint-valid edges only)."""
    e64 = jnp.where(mask, e, jnp.zeros((), e.dtype)).astype(accum_dtype)
    s = jnp.zeros((), accum_dtype)
    for ax, h in ((0, hx), (1, hy), (2, hz)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(None, -1)
        hi[ax] = slice(1, None)
        d = (e64[tuple(hi)] - e64[tuple(lo)]) / h
        m = mask[tuple(hi)] & mask[tuple(lo)]
        s = s + jnp.sum(jnp.where(m, d * d, 0.0))
    return jnp.sqrt(hx * hy * hz * s)
