"""Full multigrid solve inside ONE shard_map region (explicit distribution).

Round-1's explicit path (parallel/halo.py) covered smoothing + norms only;
this module runs the ENTIRE solve — outer while_loop, every smoothing sweep,
residual, restriction, prolongation, and the coarse-level agglomeration —
as a single SPMD program with explicitly scheduled ``ppermute`` halo
exchanges. It realizes what the reference scaffolded with CUDA streams and
never finished (reference gpu/multi_gpu_solver.py:76-88 compute/send/recv
streams; :244-643 the DD iteration whose "coarse
correction" was a damped-residual placeholder :574-593).

Design:

- **Sharded levels** (fine): every device owns a (bx, by) block of a
  "halo-repacked" global array of shape (mx*bx, my*by). Block sizes are
  chosen so fine blocks are exactly 2x their coarse child's blocks
  (bx_l = bx_0 / 2^l, multiples of 8), which makes blockwise 2:1 transfers
  local + a 1-ring halo. The standard tile-padded layout (Grid.shape_padded)
  can't guarantee that alignment, so arrays are repacked at entry/exit.
- **Replicated levels** (coarse): below ``min_points`` logical rows/cols per
  device the level is agglomerated by an ``all_gather`` and every device
  runs the identical single-device cycle code redundantly (the same
  agglomeration rule as the GSPMD path, parallel/mesh.py:61-72).
- **Interior-first overlap smoothing**: each color update is computed twice —
  once from purely local data (valid away from the block ring) while the
  ppermute halos are in flight, and once from the halo-extended block for the
  ring — then merged. The duplicated ring compute is O(perimeter); XLA's
  scheduler can overlap the collective with the interior update because they
  have no data dependence.
- **Variable coefficients and Neumann/Robin BCs** are first-class: stencil
  coefficient arrays are sharded like ``u`` (neighbor VALUES need halos;
  neighbor COEFFICIENTS do not), unknown masks are rebuilt from global
  indices per block, and the Neumann 'reflect' restriction is realized by
  installing reflected values on the halo-extended residual before the
  9-point sum (x-fold then y-fold composes to the correct corner rule).
- Norms are ``psum`` reductions of per-block f64 partial sums
  (reference multi_gpu_solver.py:546-572 did this on the host).
- **Periodic BCs are the torus case**: a periodic axis stores only its
  unique nodes (n-1 = 2^k of them for a 2^k+1 grid), which tile the device
  mesh EXACTLY (make_plan requires it, else the axis falls back to
  replication), halo ``ppermute``s become full cyclic permutations, and the
  single-device duplicate-node/ghost-sync machinery (core/bc.periodic_sync)
  vanishes inside the region — wrap neighbors ARE the halos. Replicated
  coarse levels keep the standard synced-ghost layout.

Line/Chebyshev smoothers stay on the GSPMD path (parallel/distributed.py);
this module raises for them.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import bc as bc_mod
from ..core.bc import BCKind
from ..ops import norms, transfer
from ..ops import stencil as st_ops
from ..ops.stencil import Stencil, Stencil9, _S9_FIELDS
from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import Level, MultigridConfig

_S5_FIELDS = ("c", "w", "e", "s", "n")


def _stencil_fields(is9: bool):
    return _S9_FIELDS if is9 else _S5_FIELDS


def _flatten_stencils(sten):
    return tuple(
        getattr(st, k)
        for st in sten
        for k in _stencil_fields(isinstance(st, Stencil9))
    )


def _rebuild_stencils(leaves, is9_flags):
    out, i = [], 0
    for is9 in is9_flags:
        names = _stencil_fields(is9)
        vals = leaves[i:i + len(names)]
        i += len(names)
        out.append(Stencil9(*vals) if is9 else Stencil(*vals))
    return tuple(out)

Pxy = P("x", "y")
Prep = P()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Static layout plan: which levels are sharded and their block shapes."""

    mx: int
    my: int
    n_sharded: int                       # levels [0, n_sharded) are sharded
    blocks: Tuple[Tuple[int, int], ...]  # (bx, by) per sharded level

    def hshape(self, lvl: int) -> Tuple[int, int]:
        bx, by = self.blocks[lvl]
        return (self.mx * bx, self.my * by)


def make_plan(levels: Tuple[Level, ...], mesh: Mesh,
              *, min_points: int = 16) -> HaloPlan:
    """Choose sharded depth + 2:1-aligned block shapes.

    A level stays sharded while every device keeps >= min_points logical
    rows AND cols; block sizes at the finest level are multiples of
    8 * 2^(S-1) so every sharded level's block is sublane-aligned and
    exactly half its parent's.

    Periodic axes must tile EXACTLY (the unique extent n-1 = 2^k divided by
    the mesh axis, a multiple of the quant) so cyclic halos wrap with zero
    padding; if no sharded depth satisfies that, the solve is replicated.
    """
    mx = mesh.shape["x"]
    my = mesh.shape["y"]
    spec0 = levels[0].spec
    wx = spec0.west.kind == BCKind.PERIODIC
    wy = spec0.south.kind == BCKind.PERIODIC
    S = 0
    for lev in levels:
        if lev.grid.nx // mx >= min_points and lev.grid.ny // my >= min_points:
            S += 1
        else:
            break
    if mx * my == 1:
        S = 0
    nx0, ny0 = levels[0].grid.nx, levels[0].grid.ny

    def axis_b0(n0: int, m: int, w: bool, S: int):
        """Finest-level block extent for one axis (None = infeasible)."""
        quant = 8 * (1 << (S - 1))
        if w:
            # periodic: unique nodes 0..n0-2 tile the axis exactly
            if (n0 - 1) % m:
                return None
            b0 = (n0 - 1) // m
            return b0 if b0 % quant == 0 else None
        # every sharded level's global halo extent must cover its logical
        # nodes plus one even row/col of slack for the 2:1 transfer reads
        b0 = _round_up(-(-n0 // m), quant)

        def ok(b0):
            for l in range(S):
                if (b0 >> l) * m < ((n0 - 1) >> l) + 2:
                    return False
            return True

        while not ok(b0):
            b0 += quant
        return b0

    while S > 0:
        bx0 = axis_b0(nx0, mx, wx, S)
        by0 = axis_b0(ny0, my, wy, S)
        if bx0 is not None and by0 is not None:
            break
        S -= 1
    if S == 0:
        return HaloPlan(mx, my, 0, ())
    blocks = tuple((bx0 >> l, by0 >> l) for l in range(S))
    return HaloPlan(mx, my, S, blocks)


# ---------------------------------------------------------------------------
# in-shard_map helpers (all run per-device on local blocks)
# ---------------------------------------------------------------------------

def _shift(x, axis_name: str, shift: int, size: int, wrap: bool = False):
    """ppermute by ``shift`` along a mesh axis.

    Off-mesh edges get zeros; with ``wrap`` (periodic axis) the permutation
    is cyclic — and for a single-device axis the sent slice IS the wrap
    neighbor (the block's own opposite edge), so it is returned as-is."""
    if size == 1:
        return x if wrap else jnp.zeros_like(x)
    if wrap:
        perm = [(i, (i + shift) % size) for i in range(size)]
    else:
        perm = [(i, i + shift) for i in range(size) if 0 <= i + shift < size]
    return jax.lax.ppermute(x, axis_name, perm)


def _with_halo(blk, mx: int, my: int, wx: bool = False, wy: bool = False):
    """(bx, by) -> (bx+2, by+2) with 1-ring neighbor halos (corners via the
    two-stage x-then-y assembly, which routes diagonal values correctly —
    including across periodic wraps, where the cyclic x-stage has already
    installed the wrap rows before the y-stage ships the corner cells)."""
    top = _shift(blk[-1:, :], "x", +1, mx, wx)
    bot = _shift(blk[:1, :], "x", -1, mx, wx)
    ext = jnp.concatenate([top, blk, bot], axis=0)
    left = _shift(ext[:, -1:], "y", +1, my, wy)
    right = _shift(ext[:, :1], "y", -1, my, wy)
    return jnp.concatenate([left, ext, right], axis=1)


def _gidx(bx: int, by: int, *, ext: bool = False):
    """Global (i, j) index arrays for the local (possibly halo-extended)
    block, built from iota + axis_index (no memory traffic)."""
    off = -1 if ext else 0
    sx = bx + 2 if ext else bx
    sy = by + 2 if ext else by
    gi = (jax.lax.axis_index("x") * bx + off
          + jax.lax.broadcasted_iota(jnp.int32, (sx, sy), 0))
    gj = (jax.lax.axis_index("y") * by + off
          + jax.lax.broadcasted_iota(jnp.int32, (sx, sy), 1))
    return gi, gj


def _block_unknown(spec, nx: int, ny: int, gi, gj, domain=None, grid=None):
    """bc_mod.unknown_mask semantics from global indices (Dirichlet sides
    exclude the ring; Neumann/Robin rings are unknowns; periodic axes own
    the unique nodes 0..n-2 — which is the whole halo-layout extent).
    ``domain`` restricts to an irregular DomainSpec's interior (cut nodes are
    Dirichlet-fixed, core/domain.py)."""
    mask = bc_mod.unknown_mask_at(spec, nx, ny, gi, gj)
    if domain is not None:
        mask &= domain.interior_mask_at(grid, gi, gj)
    return mask


def _nbsum_ext(stb, uh):
    """Off-diagonal coupling sum on the (bx, by) core of a haloed array
    (corners included for 9-point Galerkin stencils — _with_halo's two-stage
    assembly routes the diagonal values).

    ``stb``: stencil leaves (scalars or local (bx, by) blocks). Term order
    matches ops.stencil.neighbor_sum so sharded sweeps stay bit-identical
    to the single-device path."""
    out = (
        stb.w * uh[:-2, 1:-1]
        + stb.e * uh[2:, 1:-1]
        + stb.s * uh[1:-1, :-2]
        + stb.n * uh[1:-1, 2:]
    )
    if isinstance(stb, Stencil9):
        out = out + (
            stb.sw * uh[:-2, :-2]
            + stb.se * uh[2:, :-2]
            + stb.nw * uh[:-2, 2:]
            + stb.ne * uh[2:, 2:]
        )
    return out


def _nbsum_local(stb, u):
    """Same sum from local rolls only — valid away from the block ring."""
    return st_ops.neighbor_sum(stb, u)


def _ring_mask(bx: int, by: int):
    i = jax.lax.broadcasted_iota(jnp.int32, (bx, by), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (bx, by), 1)
    return (i == 0) | (i == bx - 1) | (j == 0) | (j == by - 1)


def _smooth_block(stb, u, f, unknown, mx, my, *, method, sweeps, omega,
                  overlap: bool = True, wx: bool = False, wy: bool = False):
    """``sweeps`` sweeps of Jacobi or RB-GS with per-color halo exchange.

    With ``overlap`` the interior update is computed from local data while
    the ppermute is in flight (interior-first smoothing — the thing the
    reference faked with CUDA streams, multi_gpu_solver.py:76-88)."""
    bx, by = u.shape
    ring = _ring_mask(bx, by)
    om = jnp.asarray(omega, u.dtype)
    gi, gj = _gidx(bx, by)
    red = ((gi + gj) & 1) == 0

    def merged_gs(u, mask):
        uh = _with_halo(u, mx, my, wx, wy)
        u_gs_h = (f + _nbsum_ext(stb, uh)) / stb.c
        if overlap:
            u_gs_l = (f + _nbsum_local(stb, u)) / stb.c
            u_gs = jnp.where(ring, u_gs_h, u_gs_l)
        else:
            u_gs = u_gs_h
        return jnp.where(mask & unknown, u + om * (u_gs - u), u)

    if method == "jacobi":

        def sweep(_, u):
            uh = _with_halo(u, mx, my, wx, wy)
            r_h = f - (stb.c * u - _nbsum_ext(stb, uh))
            if overlap:
                r_l = f - (stb.c * u - _nbsum_local(stb, u))
                r = jnp.where(ring, r_h, r_l)
            else:
                r = r_h
            return jnp.where(unknown, u + om * r / stb.c, u)

    elif method in ("rbgs", "gauss_seidel", "red_black", "sor"):

        def sweep(_, u):
            u = merged_gs(u, red)
            return merged_gs(u, ~red)

    else:
        raise NotImplementedError(
            f"halo_solve: smoother {method!r} not supported on the explicit "
            "path (line/chebyshev take the GSPMD path)")

    if sweeps <= 2:
        for k in range(sweeps):
            u = sweep(k, u)
        return u
    return jax.lax.fori_loop(0, sweeps, sweep, u)


def _residual_block(stb, u, f, unknown, mx, my, wx=False, wy=False):
    uh = _with_halo(u, mx, my, wx, wy)
    r = f - (stb.c * u - _nbsum_ext(stb, uh))
    return jnp.where(unknown, r, jnp.zeros((), u.dtype))


def _install_reflection(rh, spec, nx, ny, bx, by):
    """Install x/y-reflected values on the halo-extended residual at
    out-of-domain positions (gi = -1 reads gi = 1; gi = nx reads nx - 2),
    realizing the Neumann/Robin 'reflect' restriction blockwise. Applying
    x first and y second composes to the correct corner (2x2-mean) rule."""
    gih, gjh = _gidx(bx, by, ext=True)
    no_refl = (BCKind.DIRICHLET, BCKind.PERIODIC)  # periodic halos wrap

    def _refl(side):
        # any Neumann/Robin presence (side default or segment) needs the
        # reflected halo; on Dirichlet portions the coarse ring is masked
        # afterwards so over-reflecting there is harmless (and matches the
        # single-device 'reflect' path, which reflects uniformly)
        return any(k not in no_refl for k in side.kinds)

    refl_w = _refl(spec.west)
    refl_e = _refl(spec.east)
    refl_s = _refl(spec.south)
    refl_n = _refl(spec.north)
    if refl_w:
        rh = jnp.where(gih == -1, jnp.roll(rh, -2, 0), rh)
    if refl_e:
        rh = jnp.where(gih == nx, jnp.roll(rh, 2, 0), rh)
    if refl_s:
        rh = jnp.where(gjh == -1, jnp.roll(rh, -2, 1), rh)
    if refl_n:
        rh = jnp.where(gjh == ny, jnp.roll(rh, 2, 1), rh)
    return rh


def _restrict_block(r, lev_f: Level, lev_c: Level, mx, my, unknown_c,
                    bxc: int, byc: int, wx=False, wy=False):
    """Blockwise full-weighting restriction: 9-point sum on the halo-extended
    residual, then 2:1 decimation (the even-even parity plane)."""
    bx, by = r.shape
    rh = _with_halo(r, mx, my, wx, wy)
    if not lev_f.spec.plain:
        rh = _install_reflection(rh, lev_f.spec, lev_f.grid.nx, lev_f.grid.ny,
                                 bx, by)
    row = 2.0 * rh + jnp.roll(rh, 1, 0) + jnp.roll(rh, -1, 0)
    W = (2.0 * row + jnp.roll(row, 1, 1) + jnp.roll(row, -1, 1)) / 16.0
    W = W[1:-1, 1:-1]                       # back to the (bx, by) core
    c = W.reshape(bx // 2, 2, by // 2, 2)[:, 0, :, 0].astype(lev_c.dtype)
    return jnp.where(unknown_c, c, jnp.zeros((), lev_c.dtype))


def _prolong_block(ec, lev_f: Level, mx, my, bx: int, by: int,
                   wx=False, wy=False):
    """Blockwise bilinear prolongation: coarse block + 1-ring east/north halo,
    then the parity interleave of ops/transfer.py. On periodic axes the last
    block's east/north halo wraps to block 0 — the +1 parent of the final
    odd fine node is coarse node 0's duplicate."""
    # east/north halo only (parents of odd fine rows/cols at the block end)
    bot = _shift(ec[:1, :], "x", -1, mx, wx)
    extx = jnp.concatenate([ec, bot], axis=0)           # (bxc+1, byc)
    right = _shift(extx[:, :1], "y", -1, my, wy)
    ext = jnp.concatenate([extx, right], axis=1)        # (bxc+1, byc+1)
    return _interp_ext(ext, bx, by, lev_f.dtype)


def _interp_ext(ext, bx: int, by: int, dtype):
    """(bxc+1, byc+1) coarse window with its east/north ring -> (bx, by)
    bilinear fine block."""
    fine = transfer.bilinear_interleave(
        ext[:-1, :-1], ext[:-1, 1:], ext[1:, :-1], ext[1:, 1:], dtype)
    return fine[:bx, :by]


# ---------------------------------------------------------------------------
# repacking between standard tile-padded and halo layouts (outside shard_map)
# ---------------------------------------------------------------------------

def _repack(field, grid, hshape):
    """standard padded -> halo layout (logical region at the origin)."""
    hx, hy = hshape
    nx = min(grid.nx, hx)
    ny = min(grid.ny, hy)
    out = jnp.zeros(hshape, field.dtype)
    return out.at[:nx, :ny].set(field[:nx, :ny])


def _unpack(field_h, grid):
    """halo layout -> standard padded (periodic axes' halo extent is the
    n-1 unique nodes, hence the min; the caller re-syncs duplicates)."""
    px, py = grid.shape_padded
    nx = min(grid.nx, field_h.shape[0])
    ny = min(grid.ny, field_h.shape[1])
    out = jnp.zeros((px, py), field_h.dtype)
    return out.at[:nx, :ny].set(field_h[:nx, :ny])


def _repack_stencil(st, grid, hshape):
    def leaf(x):
        if jnp.ndim(x) == 0:
            return x
        return _repack(x, grid, hshape)

    names = _stencil_fields(isinstance(st, Stencil9))
    vals = tuple(leaf(getattr(st, k)) for k in names)
    return Stencil9(*vals) if isinstance(st, Stencil9) else Stencil(*vals)


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def halo_solve(
    mesh: Mesh,
    levels: Tuple[Level, ...],
    f,
    u0=None,
    cfg: MultigridConfig = MultigridConfig(),
    *,
    min_points: int = 16,
    overlap: bool = True,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    """mg_solve with the whole solve inside one shard_map region.

    Accepts/returns standard padded arrays (repacked internally). Matches
    ``mg_solve``'s info dict. Raises for line smoothers (GSPMD path covers
    those). Periodic axes run as a torus — cyclic halo ppermutes over an
    exactly-tiled unique-node region (see module docstring).
    """
    lev0 = levels[0]
    if cfg.smoother not in ("jacobi", "rbgs", "gauss_seidel", "red_black",
                            "sor"):
        raise NotImplementedError(
            f"halo_solve: smoother {cfg.smoother!r} takes the GSPMD path")
    if cfg.restriction != "full_weighting" or cfg.prolongation != "bilinear":
        raise NotImplementedError(
            "halo_solve: blockwise transfers implement full_weighting + "
            "bilinear only (the GSPMD path covers the rest)")
    if u0 is None:
        u0 = jnp.zeros(lev0.grid.shape_padded, lev0.dtype)

    plan = make_plan(levels, mesh, min_points=min_points)
    out_u, packed = _halo_solve_jit(mesh, tuple(levels), plan, f, u0, cfg,
                                    overlap)
    return out_u, mg_mod._unpack_info(np.asarray(packed))


def _halo_solve_jit(mesh, levels, plan, f, u0, cfg, overlap):
    S = plan.n_sharded
    lev0 = levels[0]
    # repack fine arrays into halo layout (or standard layout if S == 0)
    if S:
        f_h = _repack(f.astype(lev0.dtype), lev0.grid, plan.hshape(0))
        u_h = _repack(u0.astype(lev0.dtype), lev0.grid, plan.hshape(0))
    else:
        f_h = f.astype(lev0.dtype)
        u_h = u0.astype(lev0.dtype)
    # repack sharded levels' stencils; replicated levels keep standard layout
    sten = []
    for l, lev in enumerate(levels):
        if l < S:
            sten.append(_repack_stencil(lev.stencil, lev.grid, plan.hshape(l)))
        else:
            sten.append(lev.stencil)
    # flatten: each stencil contributes its 5 (or 9, Galerkin) field leaves
    sten_leaves = _flatten_stencils(sten)
    meta = tuple(
        (lev.grid, lev.spec, np.dtype(lev.dtype),
         isinstance(lev.stencil, Stencil9), lev.domain)
        for lev in levels
    )
    u_out_h, packed = _halo_solve_core(
        f_h, u_h, sten_leaves, mesh=mesh, plan=plan, cfg=cfg,
        overlap=overlap, meta=meta)
    if S:
        u_out = _unpack(u_out_h, lev0.grid)
    else:
        u_out = u_out_h
    sync0 = lev0.sync
    if sync0 is not None:
        u_out = sync0(u_out)  # restore periodic duplicates (mg_solve parity)
    return u_out, packed


@partial(jax.jit, static_argnames=("mesh", "plan", "cfg", "overlap", "meta"))
def _halo_solve_core(f_h, u_h, sten_leaves, *, mesh, plan, cfg, overlap,
                     meta):
    S = plan.n_sharded
    mx, my = plan.mx, plan.my
    n_lev = len(meta)
    is9_flags = tuple(m[3] for m in meta)
    sten_traced = _rebuild_stencils(sten_leaves, is9_flags)
    levels = tuple(
        Level(stencil=sten_traced[l], grid=meta[l][0], spec=meta[l][1],
              dtype=meta[l][2], domain=meta[l][4])
        for l in range(n_lev))

    # per-leaf specs: sharded-level array leaves P('x','y'), rest replicated
    leaf_specs = []
    for l in range(n_lev):
        st = sten_traced[l]
        for k in _stencil_fields(is9_flags[l]):
            sharded = l < S and jnp.ndim(getattr(st, k)) != 0
            leaf_specs.append(Pxy if sharded else Prep)
    in_specs = ((Pxy if S else Prep), (Pxy if S else Prep),
                tuple(leaf_specs))
    out_specs = ((Pxy if S else Prep), Prep)

    @partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
             out_specs=out_specs, check_vma=False)
    def run(u_blk, f_blk, leaves):
        sten = _rebuild_stencils(leaves, is9_flags)
        spec0 = levels[0].spec
        wx = spec0.west.kind == BCKind.PERIODIC
        wy = spec0.south.kind == BCKind.PERIODIC

        def level_ctx(l):
            lev = levels[l]
            if l < S:
                bx, by = plan.blocks[l]
                gi, gj = _gidx(bx, by)
                unknown = _block_unknown(lev.spec, lev.grid.nx, lev.grid.ny,
                                         gi, gj, lev.domain, lev.grid)
            else:
                unknown = lev.unknown
            return lev, sten[l], unknown

        def smooth(l, u, f, sweeps, method=None, omega=None):
            lev, stb, unknown = level_ctx(l)
            method = method or cfg.smoother
            omega = cfg.omega if omega is None else omega
            if sweeps <= 0:
                return u
            if l < S:
                return _smooth_block(stb, u, f, unknown, mx, my,
                                     method=method, sweeps=sweeps,
                                     omega=omega, overlap=overlap,
                                     wx=wx, wy=wy)
            from ..ops import smooth as smooth_mod

            return smooth_mod.smooth(stb, u, f, unknown, method=method,
                                     sweeps=sweeps, omega=omega,
                                     sync=lev.sync)

        def residual(l, u, f):
            lev, stb, unknown = level_ctx(l)
            if l < S:
                return _residual_block(stb, u, f, unknown, mx, my, wx, wy)
            from ..ops import stencil as st_mod

            return st_mod.residual(stb, u, f, unknown, lev.sync)

        def to_coarse(l, r):
            """restrict level-l residual -> level-(l+1) rhs."""
            lev_f = levels[l]
            lev_c = levels[l + 1]
            if l + 1 < S:       # sharded -> sharded
                bxc, byc = plan.blocks[l + 1]
                gi, gj = _gidx(bxc, byc)
                unknown_c = _block_unknown(lev_c.spec, lev_c.grid.nx,
                                           lev_c.grid.ny, gi, gj,
                                           lev_c.domain, lev_c.grid)
                return _restrict_block(r, lev_f, lev_c, mx, my, unknown_c,
                                       bxc, byc, wx, wy)
            if l < S:           # sharded -> replicated (agglomeration)
                bx, by = plan.blocks[l]
                virt = _restrict_block(
                    r, lev_f, lev_c, mx, my,
                    jnp.ones((bx // 2, by // 2), bool), bx // 2, by // 2,
                    wx, wy)
                full = jax.lax.all_gather(virt, "x", axis=0, tiled=True)
                full = jax.lax.all_gather(full, "y", axis=1, tiled=True)
                pxc, pyc = lev_c.grid.shape_padded
                out = jnp.zeros((pxc, pyc), lev_c.dtype)
                nx = min(lev_c.grid.nx, full.shape[0])
                ny = min(lev_c.grid.ny, full.shape[1])
                out = out.at[:nx, :ny].set(full[:nx, :ny])
                return jnp.where(lev_c.unknown, out,
                                 jnp.zeros((), lev_c.dtype))
            # replicated -> replicated: single-device path (multigrid._cycle)
            wrapf = (lev_f.spec.west.kind == BCKind.PERIODIC,
                     lev_f.spec.south.kind == BCKind.PERIODIC)
            if any(wrapf):
                r = lev_f.sync(r)  # wrap ghosts feed the seam windows
            fc = transfer.restrict(
                r, lev_c.grid.nx, lev_c.grid.ny, lev_c.grid.shape_padded,
                method=cfg.restriction,
                boundary="zero" if lev_f.spec.plain else "reflect",
                dtype=lev_c.dtype,
                wrap=wrapf,
            )
            return jnp.where(lev_c.unknown, fc, jnp.zeros((), lev_c.dtype))

        def to_fine(l, ec):
            """prolong level-(l+1) correction -> level-l correction."""
            lev_f = levels[l]
            lev_c = levels[l + 1]
            if l + 1 < S:       # sharded -> sharded
                bx, by = plan.blocks[l]
                return _prolong_block(ec, lev_f, mx, my, bx, by, wx, wy)
            if l < S:           # replicated -> sharded (de-agglomeration)
                if lev_c.sync is not None:
                    # last block's +1 window column/row reads the coarse
                    # duplicate node — mirror it from node 0 first
                    ec = lev_c.sync(ec)
                bx, by = plan.blocks[l]
                bxc, byc = bx // 2, by // 2
                pxc, pyc = ec.shape
                need_x = plan.mx * bxc + 1
                need_y = plan.my * byc + 1
                pad_x = max(0, need_x - pxc)
                pad_y = max(0, need_y - pyc)
                ec_p = jnp.pad(ec, ((0, pad_x), (0, pad_y)))
                start = (jax.lax.axis_index("x") * bxc,
                         jax.lax.axis_index("y") * byc)
                win = jax.lax.dynamic_slice(ec_p, start, (bxc + 1, byc + 1))
                return _interp_ext(win, bx, by, lev_f.dtype)
            # replicated -> replicated
            if lev_c.sync is not None:
                ec = lev_c.sync(ec)  # coarse dup mirrors node 0 (mg _cycle)
            return transfer.prolong(
                ec, lev_c.grid.nx, lev_c.grid.ny, lev_f.grid.nx,
                lev_f.grid.ny, lev_f.grid.shape_padded,
                method=cfg.prolongation, dtype=lev_f.dtype,
            )

        def cycle(l, u, f, cycle_type):
            lev, stb, unknown = level_ctx(l)
            if l == len(levels) - 1:
                return smooth(l, u, f, cfg.coarse_sweeps, method="rbgs",
                              omega=1.0)
            u = smooth(l, u, f, cfg.pre_sweeps)
            r = residual(l, u, f)
            fc = to_coarse(l, r)
            lev_c = levels[l + 1]
            if l + 1 < S:
                ec = jnp.zeros(plan.blocks[l + 1], lev_c.dtype)
            else:
                ec = jnp.zeros(lev_c.grid.shape_padded, lev_c.dtype)
            branch = cycle_type if l + 1 < cfg.w_depth else "V"
            if cycle_type == "V" or branch == "V":
                ec = cycle(l + 1, ec, fc, "V")
            elif cycle_type == "W":
                ec = cycle(l + 1, ec, fc, "W")
                ec = cycle(l + 1, ec, fc, "W")
            elif cycle_type == "F":
                ec = cycle(l + 1, ec, fc, "F")
                ec = cycle(l + 1, ec, fc, "V")
            else:
                raise ValueError(f"unknown cycle {cycle_type!r}")
            e = to_fine(l, ec)
            u = jnp.where(unknown, u + e.astype(u.dtype), u)
            return smooth(l, u, f, cfg.post_sweeps)

        def res_norm(u, f):
            lev, stb, unknown = level_ctx(0)
            r = residual(0, u, f)
            local = jnp.sum(r.astype(jnp.float64) ** 2)
            if S:
                local = jax.lax.psum(jax.lax.psum(local, "x"), "y")
            return jnp.sqrt(lev.grid.hx * lev.grid.hy * local)

        lev0 = levels[0]
        fnorm_loc = jnp.sum(
            jnp.where(level_ctx(0)[2], f_blk, 0).astype(jnp.float64) ** 2)
        if S:
            fnorm_loc = jax.lax.psum(jax.lax.psum(fnorm_loc, "x"), "y")
        fnorm = jnp.sqrt(lev0.grid.hx * lev0.grid.hy * fnorm_loc)
        rnorm0 = res_norm(u_blk, f_blk)
        # relative scale max(||f||, ||r0||) — matches mg_solve (f = 0 case)
        tol_eff = jnp.where(
            jnp.asarray(cfg.rtol),
            cfg.tol * jnp.maximum(jnp.maximum(fnorm, rnorm0), 1e-300),
            cfg.tol)
        hist = jnp.full((cfg.max_iterations + 1,), jnp.nan, jnp.float64)
        hist = hist.at[0].set(rnorm0)

        def cond(c):
            u, k, rn, h = c
            return (rn > tol_eff) & (k < cfg.max_iterations)

        def body(c):
            u, k, rn, h = c
            u = cycle(0, u, f_blk, cfg.cycle)
            rn = res_norm(u, f_blk)
            h = h.at[k + 1].set(rn)
            return (u, k + 1, rn, h)

        u, k, rnorm, hist = jax.lax.while_loop(
            cond, body, (u_blk, jnp.asarray(0, jnp.int32), rnorm0, hist))
        stats = jnp.stack([
            k.astype(jnp.float64), rnorm, rnorm0, fnorm,
            (rnorm <= tol_eff).astype(jnp.float64),
        ])
        return u, jnp.concatenate([stats, hist])

    return run(u_h, f_h, sten_leaves)


# ---------------------------------------------------------------------------
# standalone explicit-path utilities (consolidated from round-1's
# parallel/halo.py — the full solve above subsumes that module; these thin
# wrappers keep the public smoothing/norm API on the same block machinery)
# ---------------------------------------------------------------------------

def _standard_blocks(mesh: Mesh, lev: Level):
    mx, my = mesh.shape["x"], mesh.shape["y"]
    px, py = lev.grid.shape_padded
    if px % mx or py % my:
        raise ValueError(f"padded shape {(px, py)} not divisible by mesh "
                         f"{(mx, my)}")
    if lev.spec.any_periodic:
        raise NotImplementedError(
            "explicit halo utilities: periodic BCs take halo_solve's torus "
            "layout or the GSPMD path")
    if jnp.ndim(lev.stencil.c) != 0:
        raise NotImplementedError(
            "explicit halo utilities: constant stencil only (variable "
            "coefficients take halo_solve or the GSPMD path)")
    return mx, my, px // mx, py // my


def shard_smooth(
    mesh: Mesh,
    lev: Level,
    u,
    f,
    *,
    method: str = "rbgs",
    sweeps: int = 2,
    omega: float = 1.0,
    overlap: bool = True,
):
    """``sweeps`` smoothing sweeps with explicit ppermute halo exchange.

    ``u``/``f`` are standard global padded arrays (sharded or not —
    shard_map splits them). RB-GS exchanges halos once per color: true
    Gauss-Seidel ordering across device boundaries, which the reference's
    halo scheme only refreshed once per sweep pair
    (reference multi_gpu_solver.py:486-518). Bit-identical to the
    single-device XLA smoother."""
    mx, my, bx, by = _standard_blocks(mesh, lev)
    st = lev.stencil

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("x", "y"), P("x", "y")),
             out_specs=P("x", "y"))
    def run(u_blk, f_blk):
        gi, gj = _gidx(bx, by)
        unknown = _block_unknown(lev.spec, lev.grid.nx, lev.grid.ny, gi, gj,
                                 lev.domain, lev.grid)
        return _smooth_block(st, u_blk, f_blk, unknown, mx, my,
                             method=method, sweeps=sweeps, omega=omega,
                             overlap=overlap)

    return run(u, f)


def global_residual_norm(mesh: Mesh, lev: Level, u, f):
    """Scaled L2 of the residual via per-block f64 partial sums + psum
    (replaces the reference's host-side reduction,
    reference multi_gpu_solver.py:546-572)."""
    mx, my, bx, by = _standard_blocks(mesh, lev)
    st = lev.stencil
    hx, hy = lev.grid.hx, lev.grid.hy

    @partial(jax.shard_map, mesh=mesh, in_specs=(P("x", "y"), P("x", "y")),
             out_specs=P())
    def run(u_blk, f_blk):
        gi, gj = _gidx(bx, by)
        unknown = _block_unknown(lev.spec, lev.grid.nx, lev.grid.ny, gi, gj,
                                 lev.domain, lev.grid)
        r = _residual_block(st, u_blk, f_blk, unknown, mx, my)
        local = jnp.sum(r.astype(jnp.float64) ** 2)
        total = jax.lax.psum(jax.lax.psum(local, "x"), "y")
        return jnp.sqrt(hx * hy * total)

    return run(u, f)
