"""3D Galerkin (RAP) coarse operators — 27-point Stencil27 hierarchy.

3D analogue of tests/unit/test_galerkin.py; the reference had no working 3D
solver at all (reference applications/poisson_solver.py:483-557 stub), so
every row here is beyond-parity.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mixed_precision_multigrid_solvers_for_pdes_tpu.core.bc3d import BoundarySpec3D
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems3d as P3
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (
    galerkin as gk,
    stencil3d as st3,
    transfer3d,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops.stencil3d import Stencil27
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import multigrid3d as mg3
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)


def _cfg(**kw):
    base = dict(smoother="rbgs", omega=1.0, tol=1e-10,
                coarsening="galerkin")
    base.update(kw)
    return MultigridConfig(**base)


def _solve(prob, cfg, dtype="float64"):
    levels = mg3.build_hierarchy3d(prob.grid, prob.spec, a=prob.a,
                                   lam=prob.lam, dtype=dtype, cfg=cfg)
    return levels, *mg3.mg_solve3d(
        levels, prob.rhs(jnp.float64), prob.initial_guess(jnp.float64), cfg
    )


def test_matches_explicit_rap_composition():
    """A_c e == R M A M P e for random coarse vectors (17^3, var-coef)."""
    prob = P3.varcoef3d_mms(17)
    grid_f = prob.grid
    grid_c = grid_f.coarsen()
    st_f = st3.make_stencil3d(grid_f, prob.spec, a=prob.a,
                              dtype=jnp.float64)
    st_c = gk.galerkin_coarse_stencil3d(st_f, grid_f, grid_c, prob.spec)
    assert isinstance(st_c, Stencil27)

    unk_f = st3.unknown_mask3d(grid_f, prob.spec)
    unk_c = st3.unknown_mask3d(grid_c, prob.spec)
    rng = np.random.default_rng(0)
    for _ in range(2):
        ec = jnp.asarray(rng.standard_normal(grid_c.shape_padded))
        ec = jnp.where(unk_c, ec, 0.0)
        direct = jnp.where(unk_c, st3.apply(st_c, ec), 0.0)
        ef = transfer3d.prolong3d(ec, grid_c.nx, grid_c.ny, grid_c.nz,
                                  grid_f.nx, grid_f.ny, grid_f.nz,
                                  grid_f.shape_padded, dtype=jnp.float64)
        ef = jnp.where(unk_f, ef, 0.0)
        ae = jnp.where(unk_f, st3.apply(st_f, ef), 0.0)
        comp = transfer3d.restrict3d(ae, grid_c.nx, grid_c.ny, grid_c.nz,
                                     grid_c.shape_padded,
                                     method="full_weighting",
                                     boundary="zero", dtype=jnp.float64)
        comp = jnp.where(unk_c, comp, 0.0)
        np.testing.assert_allclose(np.asarray(direct), np.asarray(comp),
                                   rtol=1e-12, atol=1e-12)


def test_constant_coefficient_poisson():
    """Galerkin beats rediscretization even for Poisson (rho 0.12 -> 0.04)
    and keeps O(h^2)."""
    prob = P3.poisson3d_mms_sinsinsin(33)
    _, u, info = _solve(prob, _cfg())
    assert info["converged"]
    assert info["convergence_factor"] < 0.08
    assert prob.error_norms(u)["l2"] < 2e-3


@pytest.mark.slow
def test_jump_coefficient3d():
    prob = P3.jump_coefficient3d(33)
    _, _, info_g = _solve(prob, _cfg())
    _, _, info_r = _solve(prob, _cfg(coarsening="rediscretize", cycle="W"))
    assert info_g["converged"]
    assert info_g["convergence_factor"] < 0.11
    assert info_g["convergence_factor"] < info_r["convergence_factor"]


def test_line_z_on_stencil27():
    """zebra_z lags the 27-point edge/corner couplings."""
    prob = P3.jump_coefficient3d(17)
    _, _, info = _solve(prob, _cfg(smoother="line_z"))
    assert info["converged"]


def test_neumann3d():
    prob = P3.neumann3d_test(17)
    _, u, info = _solve(prob, _cfg())
    assert info["converged"]


def test_periodic_rejected():
    prob = P3.periodic3d_helmholtz(17)
    with pytest.raises(NotImplementedError):
        mg3.build_hierarchy3d(prob.grid, prob.spec, lam=prob.lam,
                              dtype="float64", cfg=_cfg())


@pytest.mark.slow
def test_ir_solve3d_galerkin_fp32():
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid3d import (
        ir_solve3d,
    )

    prob = P3.jump_coefficient3d(17)
    cfg = _cfg(tol=1e-9)
    levels = mg3.build_hierarchy3d(prob.grid, prob.spec, a=prob.a,
                                   dtype="float32", cfg=cfg)
    u, info = ir_solve3d(levels, prob.rhs(jnp.float64),
                         prob.initial_guess(jnp.float64), cfg)
    assert info["converged"]


@pytest.mark.slow
def test_galerkin3d_mg_preconditioned_krylov():
    """27-point Galerkin coarse hierarchy as a CG/GMRES preconditioner in 3D:
    symmetric cycles keep PCG safe on the 1e3:1 jump problem; flexible GMRES
    converges with the same operator (Stencil27 matvec throughout)."""
    import jax.numpy as jnp

    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems3d as P3,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.preconditioning import (
        multigrid_preconditioner3d,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (
        krylov,
        multigrid3d as mg3,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )

    prob = P3.jump_coefficient3d(33)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-10,
                          coarsening="galerkin", symmetric=True)
    levels = mg3.build_hierarchy3d(prob.grid, prob.spec, a=prob.a,
                                   lam=prob.lam, dtype="float64", cfg=cfg)
    lev0 = levels[0]
    mv = krylov.stencil_matvec3d(lev0.stencil, lev0.unknown)
    M = multigrid_preconditioner3d(levels, cfg)
    f = jnp.where(lev0.unknown, prob.rhs(jnp.float64), 0.0)

    u, info = krylov.pcg(mv, f, precond=M, tol=1e-10, maxiter=60)
    assert info["converged"] and info["iterations"] <= 12

    ug, infog = krylov.gmres(mv, f, precond=M, tol=1e-10, maxiter=60)
    assert infog["converged"]
    assert len(infog["history"]) == infog["iterations"] + 1
    import numpy as np
    np.testing.assert_allclose(np.asarray(ug), np.asarray(u),
                               rtol=0, atol=1e-8)
