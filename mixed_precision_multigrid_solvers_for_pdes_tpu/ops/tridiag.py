"""Batched tridiagonal solves.

``tridiagonal_solve`` wraps ``jax.lax.linalg.tridiagonal_solve`` (cuSPARSE
on the GPU, LAPACK on the CPU). The cyclic (periodic) solve uses
**parallel cyclic reduction** (PCR): ceil(log2(n)) rounds of whole-array
elementwise ops, no sequential scan. Used by the line/ADI smoothers
(ops/smooth.py) and the line preconditioner (preconditioning/diagonal.py).

Solves (dl_i x_{i-1} + d_i x_i + du_i x_{i+1} = b_i) along ``axis``; rows are
independent across the other axes (batched). dl[0]/du[n-1] are ignored.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def _zshift(x, k: int, axis: int):
    """Shift by k along axis with zero fill (no wraparound)."""
    if k == 0:
        return x
    rolled = jnp.roll(x, k, axis)
    idx = jax.lax.broadcasted_iota(jnp.int32, x.shape, axis)
    n = x.shape[axis]
    valid = (idx >= k) if k > 0 else (idx < n + k)
    return jnp.where(valid, rolled, jnp.zeros((), x.dtype))


def pcr_solve(dl, d, du, b, axis: int = -1):
    """Parallel-cyclic-reduction tridiagonal solve (batched, pure jnp)."""
    axis = axis % b.ndim
    n = b.shape[axis]
    dtype = b.dtype
    a = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, b.shape, axis) == 0,
        jnp.zeros((), dtype), jnp.broadcast_to(dl, b.shape).astype(dtype))
    c = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, b.shape, axis) == n - 1,
        jnp.zeros((), dtype), jnp.broadcast_to(du, b.shape).astype(dtype))
    bb = jnp.broadcast_to(d, b.shape).astype(dtype)
    rhs = b

    steps = max(1, math.ceil(math.log2(max(n, 2))))
    for s in range(steps):
        k = 1 << s
        b_up = _zshift(bb, k, axis)      # b_{i-k}
        b_dn = _zshift(bb, -k, axis)     # b_{i+k}
        a_up = _zshift(a, k, axis)
        c_up = _zshift(c, k, axis)
        a_dn = _zshift(a, -k, axis)
        c_dn = _zshift(c, -k, axis)
        r_up = _zshift(rhs, k, axis)
        r_dn = _zshift(rhs, -k, axis)
        # alpha eliminates x_{i-k}; gamma eliminates x_{i+k}. Out-of-range
        # rows have zero-filled b: guard the division (their a/c are zero,
        # so the term vanishes regardless of the quotient).
        alpha = -a / jnp.where(b_up != 0, b_up, jnp.ones((), dtype))
        gamma = -c / jnp.where(b_dn != 0, b_dn, jnp.ones((), dtype))
        bb = bb + alpha * c_up + gamma * a_dn
        rhs = rhs + alpha * r_up + gamma * r_dn
        a = alpha * a_up
        c = gamma * c_dn
    return rhs / bb


def cyclic_tridiagonal_solve(dl, d, du, b, axis: int = -1):
    """Cyclic (periodic) batched tridiagonal solve via Sherman-Morrison.

    System: dl_i x_{i-1} + d_i x_i + du_i x_{i+1} = b_i with indices mod n —
    dl[0] couples x_0 to x_{n-1} and du[n-1] couples x_{n-1} to x_0. The
    cyclic matrix is a tridiagonal plus a rank-1 update, so two PCR solves
    and two line reductions give the exact answer (Sherman-Morrison; the
    classic cyclic-tridiagonal recipe). Enables zebra line smoothing across
    periodic axes.
    """
    axis = axis % b.ndim
    n = b.shape[axis]
    dtype = b.dtype
    dl = jnp.broadcast_to(dl, b.shape).astype(dtype)
    d = jnp.broadcast_to(d, b.shape).astype(dtype)
    du = jnp.broadcast_to(du, b.shape).astype(dtype)

    def line_first(x):
        return jax.lax.index_in_dim(x, 0, axis, keepdims=True)

    def line_last(x):
        return jax.lax.index_in_dim(x, n - 1, axis, keepdims=True)

    idx = jax.lax.broadcasted_iota(jnp.int32, b.shape, axis)
    first = idx == 0
    last = idx == n - 1

    alpha = line_first(dl)      # x_0 <- x_{n-1} coupling
    beta = line_last(du)        # x_{n-1} <- x_0 coupling
    # gamma: any nonzero shift; -d_0 is the standard robust choice
    gamma = -line_first(d)
    gamma = jnp.where(jnp.abs(gamma) < 1e-30, jnp.full_like(gamma, 1.0), gamma)

    d_mod = jnp.where(first, d - gamma, d)
    d_mod = jnp.where(last, d_mod - alpha * beta / gamma, d_mod)
    # u-vector of the rank-1 update: gamma at 0, beta at n-1
    uvec = jnp.where(first, gamma, jnp.zeros((), dtype))
    uvec = jnp.where(last, uvec + beta, uvec)

    y = pcr_solve(dl, d_mod, du, b, axis)
    z = pcr_solve(dl, d_mod, du, uvec, axis)
    # v-vector: 1 at 0, alpha/gamma at n-1
    vy = line_first(y) + (alpha / gamma) * line_last(y)
    vz = line_first(z) + (alpha / gamma) * line_last(z)
    factor = vy / (1.0 + vz)
    return y - factor * z


def tridiagonal_solve(dl, d, du, b, axis: int = -1):
    """Batched solve along ``axis`` with ``jax.lax.linalg.tridiagonal_solve``.

    ``b`` has the same shape as the diagonals (single RHS per system).
    Neither cuSPARSE nor LAPACK takes bf16, so bf16 systems are solved in
    float32 and the result is cast back."""
    dtype = b.dtype
    if dtype == jnp.bfloat16:
        dl, d, du, b = (x.astype(jnp.float32) for x in (dl, d, du, b))
    axis = axis % b.ndim
    if axis != b.ndim - 1:
        dl, d, du, b = (jnp.moveaxis(x, axis, -1) for x in (dl, d, du, b))
    out = jax.lax.linalg.tridiagonal_solve(dl, d, du, b[..., None])[..., 0]
    if axis != b.ndim - 1:
        out = jnp.moveaxis(out, -1, axis)
    return out.astype(dtype)
