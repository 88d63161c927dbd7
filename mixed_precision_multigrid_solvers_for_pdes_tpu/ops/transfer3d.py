"""3D intergrid transfers: 27-point full-weighting and trilinear prolongation.

3D siblings of ops/transfer.py, sharing its rules:
- restriction is a parity-plane decomposition (one reshape into eight
  planes, then unit rolls of whole planes); prolongation interleaves axis
  by axis;
- no chained ring scatters (the GSPMD partitioner miscompiled them in 2D):
  one `.at[].set` per produced array + iota-mask `where` merges;
- Neumann 'reflect' restriction installs reflected values into the padding
  (where + rolls), so ring values fall out of the standard interior sum.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp


def _restrict_full_parity3(rf, dtype):
    """27-point full weighting via parity-plane decomposition, returning the
    FULL coarse-indexed array (px//2, py//2, pz//2) — ring rows included
    (valid when reflection values were installed)."""
    px, py, pz = rf.shape
    v = rf.astype(dtype).reshape(px // 2, 2, py // 2, 2, pz // 2, 2)
    planes = {
        (p0, p1, p2): v[:, p0, :, p1, :, p2]
        for p0 in (0, 1) for p1 in (0, 1) for p2 in (0, 1)
    }
    acc = 8.0 * planes[(0, 0, 0)]
    for par in planes:
        odd_axes = [ax for ax, p in enumerate(par) if p == 1]
        if not odd_axes:
            continue
        w = {1: 4.0, 2: 2.0, 3: 1.0}[len(odd_axes)]
        base = planes[par]
        for shifts in itertools.product((0, 1), repeat=len(odd_axes)):
            t = base
            for ax, s in zip(odd_axes, shifts):
                if s:
                    t = jnp.roll(t, 1, ax)
            acc = acc + w * t
    return acc / 64.0


def _injection_full3(rf, dtype):
    px, py, pz = rf.shape
    v = rf.astype(dtype).reshape(px // 2, 2, py // 2, 2, pz // 2, 2)
    return v[:, 0, :, 0, :, 0]


def restrict3d(rf, ncx: int, ncy: int, ncz: int, pshape_coarse, *,
               method: str = "full_weighting", boundary: str = "zero",
               dtype=None, wrap=(False, False, False)):
    """Fine -> coarse. ``boundary``: 'zero' (Dirichlet residual rings) or
    'reflect' (Neumann/Robin fold, cf. ops/transfer.py)."""
    dtype = dtype or rf.dtype
    px, py, pz = rf.shape
    if boundary == "reflect":
        nfs = (2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1, 2 * (ncz - 1) + 1)
        for ax in range(3):
            if wrap[ax]:
                continue
            if rf.shape[ax] - 1 == nfs[ax]:
                # x is padded to nx + 1 only: the wrapped low-side ghost
                # (last row) and the high-side ghost (row nf) would be one
                # row. Two spare rows separate them; the parity planes of
                # the extra rows land past the coarse grid and are dropped.
                pad = [(0, 0)] * 3
                pad[ax] = (0, 2)
                rf = jnp.pad(rf, pad)
            idx = jax.lax.broadcasted_iota(jnp.int32, rf.shape, ax)
            rf = jnp.where(idx == rf.shape[ax] - 1, jnp.roll(rf, -2, ax), rf)
            rf = jnp.where(idx == nfs[ax], jnp.roll(rf, 2, ax), rf)

    if method == "injection":
        c = _injection_full3(rf, dtype)
    elif method == "full_weighting":
        c = _restrict_full_parity3(rf, dtype)
    else:
        raise ValueError(f"unknown restriction {method!r}")

    pxc, pyc, pzc = pshape_coarse
    out = jnp.zeros(pshape_coarse, dtype)
    mx = min(c.shape[0], pxc)
    my = min(c.shape[1], pyc)
    mz = min(c.shape[2], pzc)
    cpad = out.at[:mx, :my, :mz].set(c[:mx, :my, :mz].astype(dtype))
    ci = jax.lax.broadcasted_iota(jnp.int32, pshape_coarse, 0)
    cj = jax.lax.broadcasted_iota(jnp.int32, pshape_coarse, 1)
    ck = jax.lax.broadcasted_iota(jnp.int32, pshape_coarse, 2)
    i0 = 0 if wrap[0] else 1
    j0 = 0 if wrap[1] else 1
    k0 = 0 if wrap[2] else 1
    core = ((ci >= i0) & (ci < ncx - 1) & (cj >= j0) & (cj < ncy - 1)
            & (ck >= k0) & (ck < ncz - 1))
    zero = jnp.zeros((), dtype)
    res = jnp.where(core, cpad, zero)
    if boundary == "reflect":
        ring = (ci < ncx) & (cj < ncy) & (ck < ncz) & ~core
        res = jnp.where(ring, cpad, res)
    return res


def prolong3d(ec, ncx: int, ncy: int, ncz: int, nfx: int, nfy: int, nfz: int,
              pshape_fine, *, dtype=None):
    """Coarse -> fine trilinear interpolation."""
    dtype = dtype or ec.dtype
    c = ec[:ncx, :ncy, :ncz].astype(dtype)
    half = jnp.asarray(0.5, dtype)

    def mid(a, axis):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[axis] = slice(0, -1)
        sl_hi[axis] = slice(1, None)
        return half * (a[tuple(sl_lo)] + a[tuple(sl_hi)])

    def interleave(a_even, a_odd, axis):
        """Merge (n, ...) even samples with (n-1, ...) odd midpoints along
        ``axis`` -> size 2n-1."""
        pad = [(0, 0)] * 3
        pad[axis] = (0, 1)
        a_odd_p = jnp.pad(a_odd, pad)  # pad to n for stacking
        stacked = jnp.stack([a_even, a_odd_p], axis=axis + 1)
        shp = list(a_even.shape)
        shp[axis] = 2 * a_even.shape[axis]
        merged = stacked.reshape(shp)
        sl = [slice(None)] * 3
        sl[axis] = slice(0, 2 * a_even.shape[axis] - 1)
        return merged[tuple(sl)]

    # interpolate axis by axis: z, then y, then x
    u = interleave(c, mid(c, 2), 2)                  # (ncx, ncy, nfz)
    u = interleave(u, mid(u, 1), 1)                  # (ncx, nfy, nfz)
    u = interleave(u, mid(u, 0), 0)                  # (nfx, nfy, nfz)
    out = jnp.zeros(pshape_fine, dtype)
    return out.at[:nfx, :nfy, :nfz].set(u)