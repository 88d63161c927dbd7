"""3D XLA smoother and transfers (solvers/multigrid3d.smooth3d,
ops/transfer3d.py) against plain loop references at <= 17^3."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid3d import Grid3D
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (
    stencil3d as st3,
    transfer3d as t3,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid3d import (
    smooth3d,
)

SHAPES = [(9, 9, 9), (9, 17, 9), (17, 9, 17)]
NEIGHBOURS = (("w", (-1, 0, 0)), ("e", (1, 0, 0)), ("s", (0, -1, 0)),
              ("n", (0, 1, 0)), ("b", (0, 0, -1)), ("t", (0, 0, 1)))


def _fields(shape, seed):
    g = Grid3D(*shape)
    st = st3.make_stencil3d(g, dtype=jnp.float64)
    unknown = np.asarray(st3.unknown_mask3d(g))
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(g.shape_padded) * unknown
    u0 = rng.standard_normal(g.shape_padded) * unknown
    return g, st, unknown, f, u0


def _smooth_loop(st, u, f, unknown, method, sweeps, omega, reverse):
    coef = {k: float(getattr(st, k)) for k in ("c", "w", "e", "s", "n", "b",
                                                "t")}
    pts = np.argwhere(unknown)
    u = u.copy()

    def gs(v, i, j, k):
        nb = sum(coef[name] * v[i + di, j + dj, k + dk]
                 for name, (di, dj, dk) in NEIGHBOURS)
        return (f[i, j, k] + nb) / coef["c"]

    for _ in range(sweeps):
        if method == "jacobi":
            old = u.copy()
            for i, j, k in pts:
                u[i, j, k] = old[i, j, k] + omega * (
                    gs(old, i, j, k) - old[i, j, k])
            continue
        for colour in ((1, 0) if reverse else (0, 1)):
            for i, j, k in pts:
                if (i + j + k) % 2 == colour:
                    u[i, j, k] += omega * (gs(u, i, j, k) - u[i, j, k])
    return u


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method,sweeps,omega,reverse", [
    ("rbgs", 1, 1.0, False), ("rbgs", 2, 1.0, True),
    ("sor", 1, 1.3, False), ("jacobi", 2, 0.8, False),
])
def test_smooth3d_matches_loop_reference(shape, method, sweeps, omega,
                                         reverse):
    g, st, unknown, f, u0 = _fields(shape, 7)
    got = np.asarray(smooth3d(st, jnp.asarray(u0), jnp.asarray(f),
                              jnp.asarray(unknown), method=method,
                              sweeps=sweeps, omega=omega, reverse=reverse))
    ref = _smooth_loop(st, u0, f, unknown, method, sweeps, omega, reverse)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_smooth3d_preserves_boundary_and_padding():
    g, st, unknown, f, u0 = _fields((17, 17, 17), 9)
    got = np.asarray(smooth3d(st, jnp.asarray(u0), jnp.asarray(f),
                              jnp.asarray(unknown), method="rbgs", sweeps=2))
    assert np.all(got[~unknown] == 0)


def _restrict_loop(rf, nc, pshape, boundary):
    nf = tuple(2 * (c - 1) + 1 for c in nc)
    tri = {-1: 1.0, 0: 2.0, 1: 1.0}

    def fine(idx):
        if boundary == "reflect":
            idx = tuple(1 if x == -1 else (n - 2 if x == n else x)
                        for x, n in zip(idx, nf))
        return rf[idx]

    out = np.zeros(pshape)
    for ci in itertools.product(*(range(c) for c in nc)):
        ring = any(x in (0, c - 1) for x, c in zip(ci, nc))
        if ring and boundary == "zero":
            continue
        out[ci] = sum(
            tri[a] * tri[b] * tri[d]
            * fine((2 * ci[0] + a, 2 * ci[1] + b, 2 * ci[2] + d))
            for a in (-1, 0, 1) for b in (-1, 0, 1) for d in (-1, 0, 1)
        ) / 64.0
    return out


def _prolong_loop(ec, nf, pshape):
    out = np.zeros(pshape)
    for i in itertools.product(*(range(n) for n in nf)):
        base = tuple(x // 2 for x in i)
        odd = [x % 2 for x in i]
        parents = [tuple(b + o for b, o in zip(base, off))
                   for off in itertools.product(*(range(p + 1)
                                                  for p in odd))]
        out[i] = np.mean([ec[p] for p in parents])
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("boundary", ["zero", "reflect"])
def test_restrict3d_matches_loop_reference(shape, boundary):
    g = Grid3D(*shape)
    gc = g.coarsen()
    rng = np.random.default_rng(sum(shape))
    rf = g.pad_field(rng.standard_normal(g.shape))
    got = np.asarray(t3.restrict3d(jnp.asarray(rf), gc.nx, gc.ny, gc.nz,
                                   gc.shape_padded, boundary=boundary))
    ref = _restrict_loop(rf, (gc.nx, gc.ny, gc.nz), gc.shape_padded,
                         boundary)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES)
def test_prolong3d_matches_loop_reference(shape):
    g = Grid3D(*shape)
    gc = g.coarsen()
    rng = np.random.default_rng(sum(shape) + 1)
    ec = gc.pad_field(rng.standard_normal(gc.shape))
    got = np.asarray(t3.prolong3d(jnp.asarray(ec), gc.nx, gc.ny, gc.nz,
                                  g.nx, g.ny, g.nz, g.shape_padded))
    ref = _prolong_loop(ec, (g.nx, g.ny, g.nz), g.shape_padded)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
