"""Intergrid transfers: restriction and prolongation.

Replaces the reference's Python-loop ``RestrictionOperator`` /
``ProlongationOperator`` (reference operators/transfer.py:15,151) and the CUDA
restriction/prolongation kernels (reference cuda_kernels.py:451-541) with
whole-array parity-plane (restriction) and repeat + parity-select
(prolongation) formulations: elementwise arithmetic and reshapes that XLA
fuses, at the working precision, with no matrix products.

Grids are padded; slicing operates on the logical region, and padding cells of
outputs stay zero by construction. Coarse (ncx, ncy) relates to fine as
nf = 2*(nc-1)+1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _restrict_interior_parity(rf, dtype, *, full: bool):
    """Interior of the 9/5-point restriction via parity-plane decomposition:
    reshape the padded array into four parity planes (even/odd x even/odd),
    so the nine windows become unit rolls of whole planes.

    Coarse node (i, j) sits at fine (2i, 2j) = ee[i, j]; odd-index neighbors
    live on the oe/eo/oo planes at offsets {0, -1}.
    """
    px, py = rf.shape
    v = rf.astype(dtype).reshape(px // 2, 2, py // 2, 2)
    ee = v[:, 0, :, 0]
    eo = v[:, 0, :, 1]
    oe = v[:, 1, :, 0]
    oo = v[:, 1, :, 1]

    def up(a):  # a[i-1, j] (wrap touches only i=0, sliced away below)
        return jnp.roll(a, 1, 0)

    def lf(a):  # a[i, j-1]
        return jnp.roll(a, 1, 1)

    if full:
        c = (
            4.0 * ee
            + 2.0 * (oe + up(oe) + eo + lf(eo))
            + (oo + up(oo) + lf(oo) + up(lf(oo)))
        ) / 16.0
    else:  # half weighting: [0 1 0; 1 4 1; 0 1 0]/8
        c = (4.0 * ee + oe + up(oe) + eo + lf(eo)) / 8.0
    return c


def _decimate_ee(rf, dtype):
    """Even-even plane ee[i, j] = rf[2i, 2j]."""
    px, py = rf.shape
    return rf.astype(dtype).reshape(px // 2, 2, py // 2, 2)[:, 0, :, 0]


def restrict(
    rf,
    ncx: int,
    ncy: int,
    pshape_coarse,
    *,
    method: str = "full_weighting",
    boundary: str = "zero",
    dtype=None,
    wrap=(False, False),
):
    """Fine -> coarse transfer.

    ``wrap``: per-axis periodic flags. A wrapped axis includes the coarse ring
    node 0 in the output (node nc-1 is the duplicate/ghost, left for the
    level's periodic_sync); the caller must pass ``rf`` with its wrap ghosts
    synced — the parity-plane rolls then read the correct seam neighbors from
    the last padded line.

    methods (reference operators/transfer.py:53-148):
      full_weighting — 9-point [1 2 1; 2 4 2; 1 2 1]/16
      half_weighting — 5-point [0 1 0; 1 4 1; 0 1 0]/8
      injection      — coarse[i,j] = fine[2i,2j]

    boundary:
      'zero'    — ring nodes left at zero (residual transfers with Dirichlet
                  rings, which carry zero residual anyway).
      'inject'  — ring nodes copied from coincident fine nodes (FMG RHS).
      'reflect' — reflection-renormalized full weighting at ring nodes: the
                  out-of-domain window weights fold back onto the interior
                  ([1 2 1] -> [2 2] along the normal), preserving constants.
                  This is the correct residual transfer for Neumann/Robin
                  rings (reference cuda_kernels.py:451-494 renormalizes its
                  boundary weights for the same reason); with injection
                  instead, the two-grid factor degrades to ~0.4 and the
                  multilevel cycle diverges.
    """
    dtype = dtype or rf.dtype
    px, py = rf.shape
    pxc, pyc = pshape_coarse

    # SPMD-SAFETY NOTE: an earlier version wrote ring values with chained
    # row/column `.at[].set` scatters fed by stride-2 1D gathers. Under a
    # GSPMD sharding constraint the XLA:CPU partitioner MISCOMPILED that
    # program (interior coarse values off by O(1); measured rho 0.053 -> 0.39
    # on the Neumann MMS problem). This formulation keeps exactly one
    # `.at[].set` per produced array and merges with iota-mask `where`s,
    # which partitions correctly (verified against the single-device and
    # explicit-shard_map paths).
    if boundary == "reflect":
        # Install reflected values in the padding so the standard interior
        # machinery yields the fold at ring nodes: out-of-domain window
        # positions read gi = -1 -> row px-1 (set to row 1) and gi = nx
        # (set to row nx-2); x first, then y, composes to the 2x2-mean
        # corner rule. nx here is the finest row any window reads
        # (nfx_needed == nx for standard coarsening).
        nfx_n = 2 * (ncx - 1) + 1
        nfy_n = 2 * (ncy - 1) + 1
        gi = jax.lax.broadcasted_iota(jnp.int32, (px, py), 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, (px, py), 1)
        if not wrap[0]:
            rf = jnp.where(gi == px - 1, jnp.roll(rf, -2, 0), rf)
            rf = jnp.where(gi == nfx_n, jnp.roll(rf, 2, 0), rf)
        if not wrap[1]:
            rf = jnp.where(gj == py - 1, jnp.roll(rf, -2, 1), rf)
            rf = jnp.where(gj == nfy_n, jnp.roll(rf, 2, 1), rf)

    def place(arr2):
        """(px//2-ish, py//2-ish) coarse-indexed values -> pshape_coarse."""
        z = jnp.zeros(pshape_coarse, dtype)
        mx = min(arr2.shape[0], pxc)
        my = min(arr2.shape[1], pyc)
        return z.at[:mx, :my].set(arr2[:mx, :my].astype(dtype))

    if method == "injection":
        # Even-even parity plane IS injection (ee[i, j] = rf[2i, 2j]): avoids
        # lane-dim stride-2 slicing AND honors the periodic seam origin
        # (a plain [1:nc-1] window silently dropped the wrapped seam node 0).
        c = _decimate_ee(rf, dtype)
    elif method in ("half_weighting", "full_weighting"):
        c = _restrict_interior_parity(rf, dtype,
                                      full=method == "full_weighting")
    else:
        raise ValueError(f"unknown restriction {method!r}")
    cpad = place(c)

    i0 = 0 if wrap[0] else 1
    j0 = 0 if wrap[1] else 1
    ci = jax.lax.broadcasted_iota(jnp.int32, pshape_coarse, 0)
    cj = jax.lax.broadcasted_iota(jnp.int32, pshape_coarse, 1)
    core = (ci >= i0) & (ci < ncx - 1) & (cj >= j0) & (cj < ncy - 1)
    zero = jnp.zeros((), dtype)
    out = jnp.where(core, cpad, zero)
    if boundary in ("inject", "reflect"):
        ring = (ci < ncx) & (cj < ncy) & ~core
        if boundary == "inject":
            ring_vals = place(_decimate_ee(rf, dtype))
        else:  # reflect: c already carries the folded values at ring nodes
            ring_vals = cpad
        out = jnp.where(ring, ring_vals, out)
    return out


def prolong(
    ec,
    ncx: int,
    ncy: int,
    nfx: int,
    nfy: int,
    pshape_fine,
    *,
    method: str = "bilinear",
    dtype=None,
):
    """Coarse -> fine transfer (bilinear or injection),
    reference operators/transfer.py:234-266 and cuda_kernels.py:497-541.

    Coincident fine nodes copy the coarse value; odd-row/col nodes average 2
    coarse neighbors; odd-odd nodes average 4.
    """
    dtype = dtype or ec.dtype
    c = ec[:ncx, :ncy].astype(dtype)
    if method == "injection":
        out = jnp.zeros(pshape_fine, dtype)
        return out.at[0:nfx:2, 0:nfy:2].set(c)
    if method != "bilinear":
        raise ValueError(f"unknown prolongation {method!r}")
    # Repeat+parity-select formulation: nearest-repeat each of the four
    # averaged fields to fine resolution, then pick by fine-index parity
    # (jnp.repeat lowers to a broadcast). Rolls read one cell past
    # (ncx, ncy), which is padding or the synced periodic duplicate — those
    # fine nodes are >= nf and sliced away.
    rt = jnp.roll(ec, -1, 1)[:ncx, :ncy]                    # c[i, j+1]
    dn = jnp.roll(ec, -1, 0)[:ncx, :ncy]                    # c[i+1, j]
    drt = jnp.roll(jnp.roll(ec, -1, 0), -1, 1)[:ncx, :ncy]
    fine = bilinear_interleave(c, rt, dn, drt, dtype)
    out = jnp.zeros(pshape_fine, dtype)
    return out.at[:nfx, :nfy].set(fine[:nfx, :nfy])


def bilinear_interleave(c, rt, dn, drt, dtype):
    """Fine (2m, 2k) bilinear values from a coarse (m, k) array ``c`` and its
    +1 neighbours rt = c[i, j+1], dn = c[i+1, j], drt = c[i+1, j+1]: fine
    (2i, 2j) copies c, odd rows/cols average 2 parents, odd-odd averages 4."""
    c, rt, dn, drt = (a.astype(dtype) for a in (c, rt, dn, drt))
    half = jnp.asarray(0.5, dtype)
    quarter = jnp.asarray(0.25, dtype)

    def rep2(a):
        return jnp.repeat(jnp.repeat(a, 2, 0), 2, 1)

    base = rep2(c)                                 # fine (2i,   2j)
    right = rep2(half * (c + rt))                  # fine (2i,   2j+1)
    down = rep2(half * (c + dn))                   # fine (2i+1, 2j)
    diag = rep2(quarter * (c + dn + rt + drt))     # fine (2i+1, 2j+1)
    i = jax.lax.broadcasted_iota(jnp.int32, base.shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, base.shape, 1)
    oi = (i & 1) == 1
    oj = (j & 1) == 1
    return jnp.where(oi & oj, diag,
                     jnp.where(oi, down, jnp.where(oj, right, base)))
