"""Smoother tests incl. exact equivalence with a loop-based reference
implementation (reference tests/unit/test_iterative_solvers.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from mixed_precision_multigrid_solvers_for_pdes_tpu.core import bc as bc_mod
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (
    norms,
    smooth as sm,
    stencil as st_mod,
)


def _setup(n=17):
    g = Grid(n, n)
    st = st_mod.make_stencil(g, dtype=jnp.float64)
    unknown = bc_mod.unknown_mask(g.nx, g.ny, g.shape_padded, bc_mod.dirichlet())
    rng = np.random.default_rng(7)
    f = np.zeros((n, n))
    f[1:-1, 1:-1] = rng.standard_normal((n - 2, n - 2))
    f = jnp.asarray(g.pad_field(f))
    u0 = jnp.zeros(g.shape_padded, jnp.float64)
    return g, st, unknown, f, u0


def _numpy_rbgs_sweep(u, f, n, h2, omega=1.0):
    """Loop-based red-black GS on the logical grid (ground truth)."""
    u = u.copy()
    for color in (0, 1):
        for i in range(1, n - 1):
            for j in range(1, n - 1):
                if (i + j) % 2 == color:
                    u_gs = (
                        u[i - 1, j] + u[i + 1, j] + u[i, j - 1] + u[i, j + 1]
                        + h2 * f[i, j]
                    ) / 4.0
                    u[i, j] = u[i, j] + omega * (u_gs - u[i, j])
    return u


def test_rbgs_matches_loop_reference():
    g, st, unknown, f, u0 = _setup(9)
    u1 = np.asarray(sm.rbgs_sweep(st, u0, f, unknown, 1.0))
    ref = _numpy_rbgs_sweep(
        np.zeros((9, 9)), np.asarray(f)[:9, :9], 9, g.hx**2
    )
    np.testing.assert_allclose(u1[:9, :9], ref, rtol=1e-12, atol=1e-14)


def test_jacobi_reduces_residual():
    g, st, unknown, f, u = _setup()
    r0 = norms.scaled_l2(st_mod.residual(st, u, f, unknown), g.hx, g.hy)
    for _ in range(10):
        u = sm.jacobi_sweep(st, u, f, unknown, 0.8)
    r1 = norms.scaled_l2(st_mod.residual(st, u, f, unknown), g.hx, g.hy)
    assert float(r1) < 0.7 * float(r0)


def test_rbgs_faster_than_jacobi():
    # asymptotically GS halves the Jacobi rate; needs enough sweeps to show
    g, st, unknown, f, u0 = _setup()
    uj, ug = u0, u0
    for _ in range(30):
        uj = sm.jacobi_sweep(st, uj, f, unknown, 0.8)
        ug = sm.rbgs_sweep(st, ug, f, unknown, 1.0)
    rj = float(norms.scaled_l2(st_mod.residual(st, uj, f, unknown), g.hx, g.hy))
    rg = float(norms.scaled_l2(st_mod.residual(st, ug, f, unknown), g.hx, g.hy))
    assert rg < rj


def test_smoothers_fix_boundary_and_padding():
    g, st, unknown, f, u0 = _setup()
    u = sm.smooth(st, u0, f, unknown, method="rbgs", sweeps=3, omega=1.0)
    u = np.asarray(u)
    assert np.all(u[0, :] == 0) and np.all(u[g.nx - 1, :] == 0)
    assert np.all(u[g.nx :, :] == 0) and np.all(u[:, g.ny :] == 0)


def test_sor_omega_helper():
    w = sm.optimal_sor_omega(65, 65)
    assert 1.8 < w < 2.0


def test_pcr_tridiagonal_solve_exact():
    from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.tridiag import (
        pcr_solve,
    )

    rng = np.random.default_rng(0)
    n = 37
    dl = rng.standard_normal((5, n))
    du = rng.standard_normal((5, n))
    d = 4.0 + np.abs(dl) + np.abs(du)
    b = rng.standard_normal((5, n))
    x = np.asarray(pcr_solve(jnp.asarray(dl), jnp.asarray(d),
                             jnp.asarray(du), jnp.asarray(b), axis=-1))
    for k in range(5):
        A = np.diag(d[k]) + np.diag(dl[k][1:], -1) + np.diag(du[k][:-1], 1)
        assert np.linalg.norm(A @ x[k] - b[k]) < 1e-10 * np.linalg.norm(b[k])


def test_line_smoother_solves_lines_exactly():
    """A y-line smoother applied to a problem with NO x-coupling must solve
    in one zebra sweep (both colors decouple)."""
    g = Grid(9, 9)
    # anisotropic limit: pure y-coupling stencil built by hand
    base = st_mod.make_stencil(g, dtype=jnp.float64)
    st = st_mod.Stencil(
        c=2.0 * base.s, w=jnp.asarray(0.0, jnp.float64),
        e=jnp.asarray(0.0, jnp.float64), s=base.s, n=base.n,
    )
    unknown = bc_mod.unknown_mask(g.nx, g.ny, g.shape_padded, bc_mod.dirichlet())
    rng = np.random.default_rng(3)
    f = np.zeros((9, 9))
    f[1:-1, 1:-1] = rng.standard_normal((7, 7))
    f = jnp.asarray(g.pad_field(f))
    u = sm.line_sweep(st, jnp.zeros(g.shape_padded, jnp.float64), f, unknown, 1)
    r = norms.scaled_l2(st_mod.residual(st, u, f, unknown), g.hx, g.hy)
    assert float(r) < 1e-10


def test_line_smoother_inhomogeneous_dirichlet():
    """Line update must honor nonzero Dirichlet ring values (coupling moved
    to the rhs)."""
    g = Grid(9, 9)
    st = st_mod.make_stencil(g, dtype=jnp.float64)
    unknown = bc_mod.unknown_mask(g.nx, g.ny, g.shape_padded, bc_mod.dirichlet())
    X, Y = g.coordinates(padded=True)
    exact = jnp.asarray(X**2 + Y**2)  # A u = -4, exact for 5-point
    f = jnp.where(unknown, -4.0, 0.0)
    u = jnp.where(unknown, jnp.zeros(()), exact)  # exact values on the ring
    for _ in range(200):
        u = sm.line_sweep(st, u, f, unknown, 1)
    logical = bc_mod.logical_mask(g.nx, g.ny, g.shape_padded)
    err = jnp.where(logical, u - exact, 0.0)
    assert float(jnp.max(jnp.abs(err))) < 1e-8


def test_adi_beats_rbgs_on_anisotropic():
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.validation.theory import (
        measure_two_grid_factor,
    )

    prob = P.poisson_mms_anisotropic(33)
    rhos = {}
    for smoother in ("rbgs", "adi"):
        cfg = MultigridConfig(smoother=smoother, omega=1.0)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=cfg)
        rhos[smoother] = measure_two_grid_factor(levels, cfg, n_cycles=8)["rho"]
    assert rhos["adi"] < 0.2
    assert rhos["adi"] < 0.5 * rhos["rbgs"]


def test_harmonic_faces_jump_coefficient_w_cycle():
    import jax.numpy as jnp

    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.validation.theory import (
        measure_two_grid_factor,
    )

    prob = P.jump_coefficient_problem(33, ratio=1e3)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, cycle="W")
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=jnp.asarray(prob.a),
                                dtype="float64", cfg=cfg)
    rho = measure_two_grid_factor(levels, cfg, n_cycles=8)["rho"]
    assert rho < 0.3, rho


def test_chebyshev_smoother_in_multigrid():
    """Colorless polynomial smoother: rho < 0.15 on Poisson (vs RB-GS 0.06;
    the trade is no parity masks / no periodic seam / pure stencil applies)."""
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.validation.theory import (
        measure_two_grid_factor,
    )

    cfg = MultigridConfig(smoother="chebyshev", omega=1.0)
    prob = P.poisson_mms_sinsin(33)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64", cfg=cfg)
    rho = measure_two_grid_factor(levels, cfg, n_cycles=8)["rho"]
    assert rho < 0.15, rho


def test_smooth_many_sweeps_fori_loop_path():
    g, st, unknown, f, u0 = _setup(9)
    u_loop = sm.smooth(st, u0, f, unknown, method="jacobi", sweeps=8, omega=0.8)
    u_unrolled = u0
    for _ in range(8):
        u_unrolled = sm.jacobi_sweep(st, u_unrolled, f, unknown, 0.8)
    np.testing.assert_allclose(np.asarray(u_loop), np.asarray(u_unrolled), rtol=1e-12)


def test_laplacian_spectrum_helpers():
    """Exact 1D eigenvalues match dense eig; condition number ~ (2/(pi h))^2."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.iterative import (
        laplacian_condition_number,
        laplacian_eigenvalues_1d,
    )

    n, h = 17, 1.0 / 16
    ev = laplacian_eigenvalues_1d(n, h)
    m = n - 2
    A = (np.diag(2 * np.ones(m)) - np.diag(np.ones(m - 1), 1)
         - np.diag(np.ones(m - 1), -1)) / h**2
    dense = np.sort(np.linalg.eigvalsh(A))
    np.testing.assert_allclose(np.sort(ev), dense, rtol=1e-12)

    kappa = laplacian_condition_number(n, n, h, h)
    # kappa = cot^2(pi h / 2) -> (2/(pi h))^2 as h -> 0
    approx = (2.0 / (np.pi * h)) ** 2
    assert 0.8 * approx < kappa < 1.05 * approx


def test_h1_seminorm_masks_padding():
    """h1_seminorm counts only edges with both endpoints valid."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import norms

    n = 17
    h = 1.0 / (n - 1)
    x = np.linspace(0.0, 1.0, n)
    X, Y = np.meshgrid(x, x, indexing="ij")
    e = np.sin(np.pi * X) * np.sin(np.pi * Y)
    # pad with garbage; mask marks the logical region only
    ep = np.full((n + 7, n + 7), 1e6)
    ep[:n, :n] = e
    mask = np.zeros_like(ep, bool)
    mask[:n, :n] = True
    v = float(norms.h1_seminorm(jnp.asarray(ep), jnp.asarray(mask), h, h))
    # analytic |e|_H1 = pi/sqrt(2); FD value converges from below
    assert abs(v - np.pi / np.sqrt(2)) < 0.05


# ---------------------------------------------------------------------------
# the XLA smoother against a general loop reference: every point method,
# constant and variable coefficients, several sweeps
# ---------------------------------------------------------------------------

OMEGA = {"jacobi": 0.8, "rbgs": 1.0, "sor": 1.3, "rbgs_rev": 1.0}


def _fields(n, seed, var):
    """Stencil (constant, or smooth + 10:1 jump coefficient), unknown mask
    and random u, f vanishing off the unknowns."""
    g = Grid(n, n)
    a = None
    if var:
        X, Y = np.meshgrid(np.linspace(0, 1, g.shape_padded[0]),
                           np.linspace(0, 1, g.shape_padded[1]),
                           indexing="ij")
        a = 1.0 + 0.5 * np.sin(2 * np.pi * X) * np.cos(np.pi * Y)
        a = jnp.asarray(np.where(X > 0.5, 10.0 * a, a))
    st = st_mod.make_stencil(g, a=a, dtype=jnp.float64)
    unknown = np.asarray(bc_mod.unknown_mask(g.nx, g.ny, g.shape_padded,
                                             bc_mod.dirichlet()))
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(g.shape_padded) * unknown
    u0 = rng.standard_normal(g.shape_padded) * unknown
    return g, st, unknown, f, u0


def _smooth_loop(st, u, f, unknown, method, sweeps, omega):
    """Point Jacobi / red-black GS with per-point coefficients."""
    shape = u.shape
    coef = {k: np.broadcast_to(np.asarray(getattr(st, k)), shape)
            for k in ("c", "w", "e", "s", "n")}
    pts = np.argwhere(unknown)
    u = u.copy()

    def gs(v, i, j):
        nb = (coef["w"][i, j] * v[i - 1, j] + coef["e"][i, j] * v[i + 1, j]
              + coef["s"][i, j] * v[i, j - 1] + coef["n"][i, j] * v[i, j + 1])
        return (f[i, j] + nb) / coef["c"][i, j]

    for _ in range(sweeps):
        if method == "jacobi":
            old = u.copy()
            for i, j in pts:
                u[i, j] = old[i, j] + omega * (gs(old, i, j) - old[i, j])
            continue
        for colour in ((1, 0) if method == "rbgs_rev" else (0, 1)):
            for i, j in pts:
                if (i + j) % 2 == colour:
                    u[i, j] += omega * (gs(u, i, j) - u[i, j])
    return u


@pytest.mark.parametrize("method", ["jacobi", "rbgs", "sor", "rbgs_rev"])
@pytest.mark.parametrize("var", [False, True], ids=["scalar", "var"])
@pytest.mark.parametrize("sweeps", [1, 3])
def test_point_smoothers_match_loop_reference(method, var, sweeps):
    g, st, unknown, f, u0 = _fields(17, 11, var)
    omega = OMEGA[method]
    got = np.asarray(sm.smooth(st, jnp.asarray(u0), jnp.asarray(f),
                               jnp.asarray(unknown), method=method,
                               sweeps=sweeps, omega=omega))
    ref = _smooth_loop(st, u0, f, unknown, method, sweeps, omega)
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_point_smoothers_keep_fixed_and_padding_nodes():
    g, st, unknown, f, u0 = _fields(33, 13, True)
    for method in OMEGA:
        got = np.asarray(sm.smooth(st, jnp.asarray(u0), jnp.asarray(f),
                                   jnp.asarray(unknown), method=method,
                                   sweeps=2, omega=OMEGA[method]))
        assert np.all(got[~unknown] == 0)


@pytest.mark.parametrize("axis", [0, 1])
def test_tridiagonal_solve_bf16(axis):
    """Neither cuSPARSE nor LAPACK takes bf16: the solve runs in fp32 and
    returns bf16, within bf16 rounding of the fp64 solution."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.tridiag import (
        tridiagonal_solve,
    )

    rng = np.random.default_rng(axis)
    shape = (24, 16)
    dl = -rng.random(shape)
    du = -rng.random(shape)
    d = 2.5 + rng.random(shape)
    b = rng.standard_normal(shape)
    x64 = np.asarray(tridiagonal_solve(*(jnp.asarray(a)
                                         for a in (dl, d, du, b)), axis=axis))
    x16 = tridiagonal_solve(*(jnp.asarray(a, jnp.bfloat16)
                              for a in (dl, d, du, b)), axis=axis)
    assert x16.dtype == jnp.bfloat16 and x16.shape == shape
    err = np.abs(np.asarray(x16.astype(jnp.float32), np.float64) - x64)
    assert err.max() <= 0.05 * np.abs(x64).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("axis", [0, 1])
def test_tridiagonal_solve_matches_dense(dtype, axis):
    """lax.linalg.tridiagonal_solve through the axis move, against dense
    numpy solves of each line (dl[0] and du[n-1] ignored)."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.tridiag import (
        tridiagonal_solve,
    )

    rng = np.random.default_rng(3 + axis)
    shape = (12, 9)
    dl, du = rng.standard_normal(shape), rng.standard_normal(shape)
    d = 4.0 + np.abs(dl) + np.abs(du)
    b = rng.standard_normal(shape)
    x = np.asarray(tridiagonal_solve(*(jnp.asarray(a, dtype)
                                       for a in (dl, d, du, b)), axis=axis))
    mv = lambda a: np.moveaxis(a, axis, -1)  # noqa: E731
    for k in range(mv(b).shape[0]):
        n = mv(b).shape[-1]
        A = (np.diag(mv(d)[k]) + np.diag(mv(dl)[k][1:], -1)
             + np.diag(mv(du)[k][:-1], 1))
        ref = np.linalg.solve(A, mv(b)[k])
        tol = 1e-5 if dtype == jnp.float32 else 1e-12
        np.testing.assert_allclose(mv(x)[k], ref, rtol=tol, atol=tol)
        assert ref.shape == (n,)


@pytest.mark.parametrize("smoother", ["adi", "line_x"])
def test_line_smoothers_in_mixed_precision_cycles(smoother):
    """Line smoothers on bf16 coarse levels (mixed policy) solve their
    tridiagonal systems in fp32 — LAPACK and cuSPARSE both refuse bf16."""
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.core.precision import (
        policy,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (
        ir_solve,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )

    prob = P.poisson_mms_anisotropic(65)
    cfg = MultigridConfig(smoother=smoother, omega=1.0, tol=1e-9)
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                                policy=policy("mixed"), cfg=cfg)
    assert any(lev.dtype == jnp.bfloat16 for lev in levels)
    u, info = ir_solve(levels, prob.rhs(jnp.float64),
                       prob.initial_guess(jnp.float64), cfg, inner_cycles=2)
    assert info["converged"]
    assert prob.error_norms(u)["l2"] < 1e-3
