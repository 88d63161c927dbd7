"""The unified 5-point stencil operator ``A u = -div(a grad u) + lam*u``.

One parameterized operator replaces the reference's zoo:
``LaplacianOperator`` (reference operators/laplacian.py:15), the ad-hoc
operator in ``CorrectedMultigridSolver`` (reference
corrected_multigrid.py:296-308), and the shifted-Laplacian/Helmholtz handling
buried in the heat solver (reference applications/heat_equation.py:209-220).
Instances cover:

- Poisson:            a=1,   lam=0
- Helmholtz:          a=1,   lam=-k^2   (definite only for small k; see note)
- variable coefficient: a(x,y) node field, face-averaged
- implicit heat step: lam = 1/(alpha*dt) (BE) or 2/(alpha*dt) (CN)

Representation: ``A u[i,j] = c*u - w*u[i-1,j] - e*u[i+1,j] - s*u[i,j-1]
- n*u[i,j+1]`` with 1/h^2 folded into the coefficients and the identity
``c = w + e + s + n + lam (+ Robin terms)`` by flux-form construction.
Coefficients are 0-d scalars on the constant-coefficient all-Dirichlet fast
path and padded 2-d arrays otherwise (variable a, or Neumann/Robin sides with
ghost-point elimination).

Neighbor access uses ``jnp.roll``, which XLA fuses into the consumer;
wrapped values only reach fixed or padding nodes (masked) or are
multiplied by zero edge coefficients, so no padding copies are ever needed.
The output of ``apply`` is only meaningful on unknown-mask nodes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.grid import Grid


@dataclasses.dataclass(frozen=True)
class Stencil:
    """5-point stencil coefficients (jax pytree; leaves are 0-d or 2-d)."""

    c: Any  # center (diagonal)
    w: Any  # coupling to u[i-1, j]
    e: Any  # coupling to u[i+1, j]
    s: Any  # coupling to u[i, j-1]
    n: Any  # coupling to u[i, j+1]

    def astype(self, dtype) -> "Stencil":
        return Stencil(*(jnp.asarray(x, dtype) for x in (self.c, self.w, self.e, self.s, self.n)))


jax.tree_util.register_dataclass(
    Stencil, data_fields=("c", "w", "e", "s", "n"), meta_fields=()
)


@dataclasses.dataclass(frozen=True)
class Stencil9:
    """9-point stencil (adds corner couplings; same sign convention:
    ``A u = c*u - sum(coef_d * u_{+d})``).

    Produced by Galerkin (RAP) coarsening (ops/galerkin.py) — the coarse
    operator of a 5-point stencil under full-weighting restriction and
    bilinear prolongation is 9-point, and 9-point is closed under further
    RAP. The reference has no Galerkin path (it rediscretizes implicitly by
    reusing the analytic stencil at every level, reference
    solvers/multigrid.py:135-182); this is an algorithmic extension for
    jump-coefficient robustness.
    """

    c: Any   # center (diagonal)
    w: Any   # coupling to u[i-1, j]
    e: Any   # coupling to u[i+1, j]
    s: Any   # coupling to u[i, j-1]
    n: Any   # coupling to u[i, j+1]
    sw: Any  # coupling to u[i-1, j-1]
    se: Any  # coupling to u[i+1, j-1]
    nw: Any  # coupling to u[i-1, j+1]
    ne: Any  # coupling to u[i+1, j+1]

    def astype(self, dtype) -> "Stencil9":
        return Stencil9(*(jnp.asarray(getattr(self, k), dtype)
                          for k in _S9_FIELDS))


_S9_FIELDS = ("c", "w", "e", "s", "n", "sw", "se", "nw", "ne")

jax.tree_util.register_dataclass(
    Stencil9, data_fields=_S9_FIELDS, meta_fields=()
)


def shift_w(u):  # value of u at (i-1, j)
    return jnp.roll(u, 1, axis=0)


def shift_e(u):  # value of u at (i+1, j)
    return jnp.roll(u, -1, axis=0)


def shift_s(u):  # value of u at (i, j-1)
    return jnp.roll(u, 1, axis=1)


def shift_n(u):  # value of u at (i, j+1)
    return jnp.roll(u, -1, axis=1)


def shift_sw(u):  # value of u at (i-1, j-1)
    return jnp.roll(u, (1, 1), axis=(0, 1))


def shift_se(u):  # value of u at (i+1, j-1)
    return jnp.roll(u, (-1, 1), axis=(0, 1))


def shift_nw(u):  # value of u at (i-1, j+1)
    return jnp.roll(u, (1, -1), axis=(0, 1))


def shift_ne(u):  # value of u at (i+1, j+1)
    return jnp.roll(u, (-1, -1), axis=(0, 1))


def neighbor_sum(st, u):
    """Sum of coef_d * u_{+d} over the off-diagonal couplings (negated part
    of A). Accepts Stencil (5-point) or Stencil9."""
    out = (
        st.w * shift_w(u)
        + st.e * shift_e(u)
        + st.s * shift_s(u)
        + st.n * shift_n(u)
    )
    if isinstance(st, Stencil9):
        out = out + (
            st.sw * shift_sw(u)
            + st.se * shift_se(u)
            + st.nw * shift_nw(u)
            + st.ne * shift_ne(u)
        )
    return out


def apply(st: Stencil, u):
    """A u. Valid on unknown nodes only (see module docstring)."""
    return st.c * u - neighbor_sum(st, u)


def residual(st: Stencil, u, f, unknown, sync=None):
    """r = f - A u, zeroed on fixed/padding nodes
    (reference corrected_multigrid.py:279-294 zeroes the boundary the same way).
    ``sync`` refreshes periodic wrap ghosts before the neighbor reads."""
    if sync is not None:
        u = sync(u)
    r = f - apply(st, u)
    return jnp.where(unknown, r, jnp.zeros((), r.dtype))


def make_stencil(
    grid: Grid,
    spec: BoundarySpec = BoundarySpec(),
    *,
    a: Optional[jnp.ndarray] = None,
    lam: Any = 0.0,
    dtype=jnp.float32,
) -> Stencil:
    """Build the stencil for ``-div(a grad u) + lam*u`` on ``grid``.

    ``a``: node-valued coefficient field (padded shape) or None for a=1.
    ``lam``: scalar (may be traced, e.g. 1/(alpha*dt)) or padded array.
    Neumann/Robin sides fold the eliminated ghost point into the edge
    coefficients: normal coupling -> 0, tangential-opposite coupling doubled,
    Robin adds 2*alpha/(beta*h) to the diagonal.
    """
    spec.validate()
    if spec.any_periodic and (grid.shape_padded[0] == grid.nx
                              or grid.shape_padded[1] == grid.ny):
        raise ValueError("periodic BCs need at least one padding line per "
                         "axis to carry the wrap ghost")
    pshape = grid.shape_padded
    nx, ny = grid.nx, grid.ny
    ihx2 = 1.0 / (grid.hx * grid.hx)
    ihy2 = 1.0 / (grid.hy * grid.hy)

    constant = a is None and spec.plain and jnp.ndim(lam) == 0
    if constant:
        w = e = jnp.asarray(ihx2, dtype)
        s = n = jnp.asarray(ihy2, dtype)
        c = w + e + s + n + jnp.asarray(lam, dtype)
        return Stencil(c=c, w=w, e=e, s=s, n=n)

    if a is None:
        aw = ae = jnp.asarray(1.0, dtype)
        as_ = an = jnp.asarray(1.0, dtype)
    else:
        a = jnp.asarray(a, dtype)

        # harmonic face means: exact flux continuity across coefficient
        # interfaces. With arithmetic means a 1e3:1 jump drives the V-cycle
        # factor to ~0.6; harmonic restores the textbook behavior.
        def face(an_):
            s = a + an_
            return jnp.where(s > 0, 2.0 * a * an_ / jnp.where(s > 0, s, 1.0),
                             jnp.zeros((), dtype))

        aw = face(shift_w(a))
        ae = face(shift_e(a))
        as_ = face(shift_s(a))
        an = face(shift_n(a))

    ones = jnp.ones(pshape, dtype)
    w = ones * (aw * ihx2)
    e = ones * (ae * ihx2)
    s = ones * (as_ * ihy2)
    n = ones * (an * ihy2)

    robin_diag = jnp.zeros(pshape, dtype)
    for name, h, normal_coef, opposite_coef in (
        ("west", grid.hx, "w", "e"),
        ("east", grid.hx, "e", "w"),
        ("south", grid.hy, "s", "n"),
        ("north", grid.hy, "n", "s"),
    ):
        # per-region (segment-aware) ghost elimination; unsegmented sides
        # yield a single region covering the whole side
        for eff, m in bc_mod.side_regions(name, nx, ny, pshape,
                                          spec.side(name)):
            if eff.kind not in (BCKind.NEUMANN, BCKind.ROBIN):
                continue
            coefs = {"w": w, "e": e, "s": s, "n": n}
            # ghost elimination: drop outward coupling, double the inward one
            coefs[opposite_coef] = jnp.where(
                m, 2.0 * coefs[opposite_coef], coefs[opposite_coef]
            )
            coefs[normal_coef] = jnp.where(m, jnp.zeros((), dtype),
                                           coefs[normal_coef])
            w, e, s, n = coefs["w"], coefs["e"], coefs["s"], coefs["n"]
            if eff.kind == BCKind.ROBIN:
                robin_diag = robin_diag + jnp.where(
                    m, jnp.asarray(2.0 * eff.alpha / (eff.beta * h), dtype),
                    0.0
                )

    c = w + e + s + n + jnp.asarray(lam, dtype) + robin_diag
    return Stencil(c=c, w=w, e=e, s=s, n=n)


def bc_rhs_correction(
    grid: Grid,
    spec: BoundarySpec,
    bc_values: Dict[str, Any],
    dtype=jnp.float32,
):
    """Additive RHS term from Neumann/Robin data g: 2*g/(beta*h) on each side.

    ``bc_values[side]`` is a scalar or a padded 2-d array holding g on that
    side's ring. Dirichlet sides contribute nothing here (their values live in
    the solution array; see models.problems.apply_dirichlet_values).
    """
    pshape = grid.shape_padded
    out = jnp.zeros(pshape, dtype)
    for name, h in (("west", grid.hx), ("east", grid.hx),
                    ("south", grid.hy), ("north", grid.hy)):
        g = jnp.asarray(bc_values.get(name, 0.0), dtype)
        for eff, m in bc_mod.side_regions(name, grid.nx, grid.ny, pshape,
                                          spec.side(name)):
            if eff.kind not in (BCKind.NEUMANN, BCKind.ROBIN):
                continue
            out = out + jnp.where(m, 2.0 * g / (eff.beta * h), 0.0)
    return out
