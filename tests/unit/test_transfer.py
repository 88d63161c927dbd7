"""Transfer-operator invariants (reference tests/unit/test_operators.py:200-328)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import transfer


def _grids(nf):
    gf = Grid(nf, nf)
    gc = gf.coarsen()
    return gf, gc


def test_restrict_preserves_constant_interior():
    gf, gc = _grids(17)
    rf = jnp.asarray(gf.pad_field(np.ones((17, 17))))
    for method in ("full_weighting", "half_weighting", "injection"):
        rc = transfer.restrict(rf, gc.nx, gc.ny, gc.shape_padded, method=method)
        np.testing.assert_allclose(
            np.asarray(rc)[1 : gc.nx - 1, 1 : gc.ny - 1], 1.0, rtol=1e-6
        )


def test_restrict_reflect_preserves_constant_everywhere():
    gf, gc = _grids(17)
    rf = jnp.asarray(gf.pad_field(np.ones((17, 17))))
    rc = transfer.restrict(
        rf, gc.nx, gc.ny, gc.shape_padded, boundary="reflect"
    )
    np.testing.assert_allclose(np.asarray(rc)[: gc.nx, : gc.ny], 1.0, rtol=1e-6)


def test_restrict_injection_samples():
    gf, gc = _grids(17)
    X, Y = gf.coordinates()
    rf = jnp.asarray(gf.pad_field(X + 10 * Y))
    rc = transfer.restrict(rf, gc.nx, gc.ny, gc.shape_padded, method="injection")
    Xc, Yc = gc.coordinates()
    np.testing.assert_allclose(
        np.asarray(rc)[1 : gc.nx - 1, 1 : gc.ny - 1],
        (Xc + 10 * Yc)[1:-1, 1:-1],
        rtol=1e-6,
    )


def test_prolong_constant_and_linear_exact():
    gf, gc = _grids(17)
    Xc, Yc = gc.coordinates()
    for field, exact in (
        (np.ones((gc.nx, gc.ny)), lambda X, Y: np.ones_like(X)),
        (Xc + 2 * Yc, lambda X, Y: X + 2 * Y),
    ):
        ec = jnp.asarray(gc.pad_field(field))
        ef = transfer.prolong(
            ec, gc.nx, gc.ny, gf.nx, gf.ny, gf.shape_padded
        )
        Xf, Yf = gf.coordinates()
        np.testing.assert_allclose(
            np.asarray(ef)[: gf.nx, : gf.ny], exact(Xf, Yf), atol=1e-6
        )


def test_prolong_injection_zero_fill():
    gf, gc = _grids(9)
    ec = jnp.asarray(gc.pad_field(np.ones((gc.nx, gc.ny))))
    ef = np.asarray(
        transfer.prolong(ec, gc.nx, gc.ny, gf.nx, gf.ny, gf.shape_padded,
                         method="injection")
    )
    assert np.all(ef[0 : gf.nx : 2, 0 : gf.ny : 2] == 1.0)
    assert np.all(ef[1 : gf.nx : 2, :] == 0.0)


def test_transfer_adjointness_interior():
    # <R r, e>_c == <r, P e>_f / 4 for fields vanishing on the rings
    # (full weighting = bilinear^T / 4 in 2D)
    rng = np.random.default_rng(0)
    gf, gc = _grids(33)
    r = np.zeros((gf.nx, gf.ny))
    r[1:-1, 1:-1] = rng.standard_normal((gf.nx - 2, gf.ny - 2))
    e = np.zeros((gc.nx, gc.ny))
    e[1:-1, 1:-1] = rng.standard_normal((gc.nx - 2, gc.ny - 2))
    rf = jnp.asarray(gf.pad_field(r))
    ec = jnp.asarray(gc.pad_field(e))
    Rr = np.asarray(transfer.restrict(rf, gc.nx, gc.ny, gc.shape_padded))
    Pe = np.asarray(
        transfer.prolong(ec, gc.nx, gc.ny, gf.nx, gf.ny, gf.shape_padded)
    )
    lhs = np.sum(Rr[: gc.nx, : gc.ny] * e)
    rhs = np.sum(np.asarray(rf)[: gf.nx, : gf.ny] * Pe[: gf.nx, : gf.ny]) / 4.0
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_padding_stays_zero():
    gf, gc = _grids(17)
    rf = jnp.asarray(gf.pad_field(np.ones((17, 17))))
    rc = np.asarray(transfer.restrict(rf, gc.nx, gc.ny, gc.shape_padded))
    assert np.all(rc[gc.nx :, :] == 0) and np.all(rc[:, gc.ny :] == 0)
    ec = jnp.asarray(gc.pad_field(np.ones((gc.nx, gc.ny))))
    ef = np.asarray(
        transfer.prolong(ec, gc.nx, gc.ny, gf.nx, gf.ny, gf.shape_padded)
    )
    assert np.all(ef[gf.nx :, :] == 0) and np.all(ef[:, gf.ny :] == 0)


# ---------------------------------------------------------------------------
# against plain loop references (independent of the parity-plane and
# repeat/select formulations)
# ---------------------------------------------------------------------------

def _restrict_loop(rf, ncx, ncy, pshape, method, boundary):
    nfx, nfy = 2 * (ncx - 1) + 1, 2 * (ncy - 1) + 1
    tri = {-1: 1.0, 0: 2.0, 1: 1.0}

    def fine(i, j):
        if boundary == "reflect":
            i = 1 if i == -1 else (nfx - 2 if i == nfx else i)
            j = 1 if j == -1 else (nfy - 2 if j == nfy else j)
        return rf[i, j]

    out = np.zeros(pshape)
    for ci in range(ncx):
        for cj in range(ncy):
            i, j = 2 * ci, 2 * cj
            ring = ci in (0, ncx - 1) or cj in (0, ncy - 1)
            if ring and boundary == "zero":
                continue
            if (ring and boundary == "inject") or method == "injection":
                out[ci, cj] = fine(i, j)
            elif method == "full_weighting":
                out[ci, cj] = sum(tri[a] * tri[b] * fine(i + a, j + b)
                                  for a in (-1, 0, 1)
                                  for b in (-1, 0, 1)) / 16.0
            else:
                out[ci, cj] = (4.0 * fine(i, j) + fine(i - 1, j)
                               + fine(i + 1, j) + fine(i, j - 1)
                               + fine(i, j + 1)) / 8.0
    return out


def _prolong_loop(ec, nfx, nfy, pshape, method):
    out = np.zeros(pshape)
    for i in range(nfx):
        for j in range(nfy):
            ci, cj, a, b = i // 2, j // 2, i % 2, j % 2
            if method == "injection":
                out[i, j] = ec[ci, cj] if a == b == 0 else 0.0
            else:
                out[i, j] = np.mean([ec[ci + da, cj + db]
                                     for da in range(a + 1)
                                     for db in range(b + 1)])
    return out


def _random_logical(g, seed):
    rng = np.random.default_rng(seed)
    return g.pad_field(rng.standard_normal((g.nx, g.ny)))


@pytest.mark.parametrize("n,method,boundary", [
    (17, m, b) for m in ("full_weighting", "half_weighting", "injection")
    for b in ("zero", "inject", "reflect")
] + [(65, "full_weighting", "reflect")])
def test_restrict_matches_loop_reference(n, method, boundary):
    gf, gc = _grids(n)
    rf = _random_logical(gf, n)
    got = np.asarray(transfer.restrict(
        jnp.asarray(rf), gc.nx, gc.ny, gc.shape_padded, method=method,
        boundary=boundary))
    ref = _restrict_loop(rf, gc.nx, gc.ny, gc.shape_padded, method, boundary)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,method", [(17, "bilinear"), (33, "bilinear"),
                                      (65, "bilinear"), (17, "injection")])
def test_prolong_matches_loop_reference(n, method):
    gf, gc = _grids(n)
    ec = _random_logical(gc, n + 1)
    got = np.asarray(transfer.prolong(
        jnp.asarray(ec), gc.nx, gc.ny, gf.nx, gf.ny, gf.shape_padded,
        method=method))
    ref = _prolong_loop(ec, gf.nx, gf.ny, gf.shape_padded, method)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_bilinear_interleave_matches_loop_reference():
    """The shared interleave (ops/transfer.py, parallel/halo_solve.py) on a
    window with its east/north ring: fine (2m, 2k) values."""
    rng = np.random.default_rng(5)
    ext = rng.standard_normal((9, 6))
    got = np.asarray(transfer.bilinear_interleave(
        ext[:-1, :-1], ext[:-1, 1:], ext[1:, :-1], ext[1:, 1:], jnp.float64))
    ref = _prolong_loop(ext, 16, 10, (16, 10), "bilinear")
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("method", ["full_weighting", "injection"])
def test_restrict_bf16_output(method):
    """dtype= casts the result: bf16 values within bf16 rounding of the
    fp64 loop reference."""
    gf, gc = _grids(33)
    rf = _random_logical(gf, 7)
    got = transfer.restrict(jnp.asarray(rf), gc.nx, gc.ny, gc.shape_padded,
                            method=method, dtype=jnp.bfloat16)
    assert got.dtype == jnp.bfloat16
    ref = _restrict_loop(rf, gc.nx, gc.ny, gc.shape_padded, method, "zero")
    np.testing.assert_allclose(np.asarray(got.astype(jnp.float32)), ref,
                               rtol=1e-2, atol=1e-2)
