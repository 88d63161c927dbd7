"""Boundary-condition specification and masks.

Replaces both of the reference's BC frameworks (inline handling in
Grid/solvers, reference core/grid.py:92-139, and
boundary_conditions/advanced_bc.py:51-392) with a single static spec that the
stencil factory consumes:

- **Dirichlet** sides: boundary nodes are *fixed* — they hold the BC value,
  every solver update is masked off them, and residuals are zero there.
- **Neumann / Robin** sides (``alpha*u + beta*du/dn = g``, outward normal):
  boundary nodes are *unknowns*; the ghost point is eliminated into the edge
  equation, which shows up as modified stencil coefficients and an RHS term
  (see ops/stencil.py). Matches the one-sided-difference semantics of
  reference boundary_conditions/advanced_bc.py:139-180.
- **Periodic**: planned (wrap neighbors); tracked in ops/stencil.py.

Masks are generated from ``lax.broadcasted_iota`` inside jit, so they cost no
HBM traffic and no per-level storage.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import jax
import jax.numpy as jnp

SIDES = ("west", "east", "south", "north")  # i=0, i=nx-1, j=0, j=ny-1


class BCKind(enum.Enum):
    DIRICHLET = "dirichlet"
    NEUMANN = "neumann"
    ROBIN = "robin"
    PERIODIC = "periodic"


@dataclasses.dataclass(frozen=True)
class BCSegment:
    """One interval of a side carrying its own condition (mixed per-segment
    BCs, reference boundary_conditions/advanced_bc.py:219-334
    MixedBoundaryCondition). ``lo``/``hi`` are fractions of the side's arc
    length in [0, 1]; a boundary node at tangential fraction t belongs to the
    segment when lo <= t <= hi (first listed segment wins where two touch).
    Periodic segments are meaningless (wrap is a whole-axis property)."""

    lo: float
    hi: float
    kind: BCKind = BCKind.DIRICHLET
    alpha: float = 0.0
    beta: float = 1.0

    def __post_init__(self):
        if not (0.0 <= self.lo < self.hi <= 1.0):
            raise ValueError(
                f"segment interval must satisfy 0 <= lo < hi <= 1, "
                f"got [{self.lo}, {self.hi}]")
        if self.kind == BCKind.PERIODIC:
            raise ValueError("periodic BC cannot be assigned to a segment")
        if self.kind == BCKind.ROBIN and self.beta == 0.0:
            raise ValueError("Robin BC requires beta != 0")


@dataclasses.dataclass(frozen=True)
class BCSide:
    """One side's condition: alpha*u + beta*du/dn = g (g supplied separately).

    Dirichlet: u = g  (alpha=1, beta=0 conceptually).
    Neumann:   du/dn = g (alpha=0, beta=1).
    Robin:     alpha*u + beta*du/dn = g, beta != 0.

    ``segments`` optionally overrides intervals of the side with different
    conditions (mixed per-segment BCs, reference advanced_bc.py:219-334);
    ``kind``/``alpha``/``beta`` apply outside all segments.
    """

    kind: BCKind = BCKind.DIRICHLET
    alpha: float = 0.0
    beta: float = 1.0
    segments: Tuple[BCSegment, ...] = ()

    def __post_init__(self):
        if self.kind == BCKind.ROBIN and self.beta == 0.0:
            raise ValueError("Robin BC requires beta != 0")
        if self.segments:
            if self.kind == BCKind.PERIODIC:
                raise ValueError(
                    "a periodic side cannot carry BC segments")
            segs = sorted(self.segments, key=lambda s: s.lo)
            for a, b in zip(segs, segs[1:]):
                if b.lo < a.hi:
                    raise ValueError(
                        f"overlapping BC segments [{a.lo},{a.hi}] and "
                        f"[{b.lo},{b.hi}]")

    @property
    def kinds(self) -> frozenset:
        """Every condition kind present on this side (default + segments).
        The default kind is always included: proving the segments cover the
        whole closed interval is brittle under float endpoints, so gates stay
        conservative instead."""
        return frozenset({self.kind} | {s.kind for s in self.segments})


@dataclasses.dataclass(frozen=True)
class BoundarySpec:
    """Static, hashable BC description for all four sides."""

    west: BCSide = BCSide()
    east: BCSide = BCSide()
    south: BCSide = BCSide()
    north: BCSide = BCSide()

    def side(self, name: str) -> BCSide:
        return getattr(self, name)

    @property
    def all_dirichlet(self) -> bool:
        return all(self.side(s).kinds == {BCKind.DIRICHLET} for s in SIDES)

    @property
    def any_periodic(self) -> bool:
        return any(self.side(s).kind == BCKind.PERIODIC for s in SIDES)

    @property
    def plain(self) -> bool:
        """No side (or segment) introduces boundary unknowns — every
        condition is Dirichlet or periodic. Gates the constant-coefficient
        stencil fast path and 'zero' restriction boundary handling."""
        return all(
            k in (BCKind.DIRICHLET, BCKind.PERIODIC)
            for s in SIDES for k in self.side(s).kinds
        )

    @property
    def any_segments(self) -> bool:
        return any(self.side(s).segments for s in SIDES)

    def validate(self) -> None:
        # Periodic must pair up; pure-Neumann problems are singular
        # (reference advanced_bc.py:374-390 warns the same way).
        w, e = self.west.kind, self.east.kind
        s, n = self.south.kind, self.north.kind
        if (w == BCKind.PERIODIC) != (e == BCKind.PERIODIC):
            raise ValueError("periodic BC must be set on both west and east")
        if (s == BCKind.PERIODIC) != (n == BCKind.PERIODIC):
            raise ValueError("periodic BC must be set on both south and north")


def dirichlet() -> BoundarySpec:
    """Homogeneous-style all-Dirichlet spec (values supplied per problem)."""
    return BoundarySpec()


def neumann() -> BoundarySpec:
    side = BCSide(kind=BCKind.NEUMANN)
    return BoundarySpec(side, side, side, side)


def mixed(**kwargs) -> BoundarySpec:
    """Build a spec from per-side kinds, e.g. mixed(west='neumann')."""
    sides = {}
    for name in SIDES:
        val = kwargs.get(name, "dirichlet")
        if isinstance(val, BCSide):
            sides[name] = val
        else:
            sides[name] = BCSide(kind=BCKind(val))
    return BoundarySpec(**sides)


def _segment_claims(side: BCSide, t, n: int):
    """Yield (segment-or-default BCSide, claim mask over ``t``) pairs for a
    segmented side; ``t`` is the tangential node-index array, ``n`` the
    side's logical extent. First listed segment wins where two touch."""
    frac = t.astype(jnp.float32) / jnp.float32(max(n - 1, 1))
    claimed = jnp.zeros(t.shape, bool)
    for seg in side.segments:
        m = (frac >= seg.lo) & (frac <= seg.hi) & ~claimed
        claimed = claimed | m
        yield BCSide(kind=seg.kind, alpha=seg.alpha, beta=seg.beta), m
    yield BCSide(kind=side.kind, alpha=side.alpha, beta=side.beta), ~claimed


def _side_dirichlet_at(side: BCSide, t, n: int):
    """Bool mask over tangential index array ``t``: True where the side's
    effective condition (after segments) is Dirichlet."""
    if not side.segments:
        return jnp.full(t.shape, side.kind == BCKind.DIRICHLET)
    out = jnp.zeros(t.shape, bool)
    for eff, m in _segment_claims(side, t, n):
        if eff.kind == BCKind.DIRICHLET:
            out = out | m
    return out


def unknown_mask_at(spec: BoundarySpec, nx: int, ny: int, gi, gj):
    """``unknown_mask`` semantics evaluated at arbitrary global-index arrays
    (shared by the padded single-device mask and parallel.halo_solve's
    sharded blocks, which index with axis_index offsets): True where the
    solver owns the node. Dirichlet boundary nodes (side default or segment)
    are fixed; Neumann/Robin ones are unknowns; periodic axes own the unique
    nodes 0..n-2."""
    mask = (gi >= 0) & (gi < nx) & (gj >= 0) & (gj < ny)
    if spec.west.kind == BCKind.PERIODIC:
        mask &= gi < nx - 1
    else:
        mask &= ~((gi == 0) & _side_dirichlet_at(spec.west, gj, ny))
        mask &= ~((gi == nx - 1) & _side_dirichlet_at(spec.east, gj, ny))
    if spec.south.kind == BCKind.PERIODIC:
        mask &= gj < ny - 1
    else:
        mask &= ~((gj == 0) & _side_dirichlet_at(spec.south, gi, nx))
        mask &= ~((gj == ny - 1) & _side_dirichlet_at(spec.north, gi, nx))
    return mask


def unknown_mask(nx: int, ny: int, pshape: Tuple[int, int], spec: BoundarySpec):
    """Boolean (padded) mask: True where the solver owns the node.

    Padding cells and Dirichlet boundary nodes (side default or segment) are
    False; Neumann/Robin boundary nodes are True. Periodic axes own nodes
    0..n-2 (node n-1 is the duplicate of node 0, kept as a synced ghost).
    Built from iota so XLA fuses it into consumers.
    """
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    return unknown_mask_at(spec, nx, ny, i, j)


def side_regions(name: str, nx: int, ny: int, pshape: Tuple[int, int],
                 side: BCSide):
    """List of (effective BCSide, padded bool mask) covering one side's
    logical nodes — one entry per segment plus the default remainder (a
    single entry for unsegmented sides). Consumed by the stencil factory's
    ghost elimination and bc_rhs_correction."""
    base = side_mask(name, nx, ny, pshape)
    if not side.segments:
        return [(side, base)]
    tangential_axis = 1 if name in ("west", "east") else 0
    n = ny if tangential_axis == 1 else nx
    t = jax.lax.broadcasted_iota(jnp.int32, pshape, tangential_axis)
    return [(eff, base & m) for eff, m in _segment_claims(side, t, n)]


def periodic_sync(nx: int, ny: int, pshape: Tuple[int, int],
                  spec: BoundarySpec):
    """Ghost-refresh function for periodic axes, or None if none are periodic.

    Periodic storage convention: unique nodes 0..n-2; node n-1 duplicates
    node 0; the LAST padded line (index p-1) carries node n-2 so that a plain
    ``jnp.roll(+1)`` delivers the correct west/south wrap neighbor at index 0
    (and roll(-1) at n-2 reads the duplicate at n-1). Two writes per axis —
    the counterpart of the reference's periodic wrap copies
    (reference boundary_conditions/advanced_bc.py:182-217)."""
    px, py = pshape
    wrap_x = spec.west.kind == BCKind.PERIODIC
    wrap_y = spec.south.kind == BCKind.PERIODIC
    if not (wrap_x or wrap_y):
        return None

    def sync(u):
        if wrap_x:
            u = u.at[nx - 1, :].set(u[0, :])
            u = u.at[px - 1, :].set(u[nx - 2, :])
        if wrap_y:
            u = u.at[:, ny - 1].set(u[:, 0])
            u = u.at[:, py - 1].set(u[:, ny - 2])
        return u

    return sync


def side_mask(name: str, nx: int, ny: int, pshape: Tuple[int, int]):
    """Boolean (padded) mask selecting the logical nodes of one side."""
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    logical = (i < nx) & (j < ny)
    if name == "west":
        return logical & (i == 0)
    if name == "east":
        return logical & (i == nx - 1)
    if name == "south":
        return logical & (j == 0)
    if name == "north":
        return logical & (j == ny - 1)
    raise ValueError(name)


def interior_mask(nx: int, ny: int, pshape: Tuple[int, int]):
    """Strict interior of the logical region (all four rings excluded)."""
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    return (i > 0) & (i < nx - 1) & (j > 0) & (j < ny - 1)


def logical_mask(nx: int, ny: int, pshape: Tuple[int, int]):
    """All logical (non-padding) nodes."""
    i = jax.lax.broadcasted_iota(jnp.int32, pshape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, pshape, 1)
    return (i < nx) & (j < ny)
