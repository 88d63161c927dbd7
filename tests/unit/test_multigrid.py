"""End-to-end multigrid solves against manufactured solutions.

Real solves, no mocks — replacing the reference's fabricated integration layer
(reference tests/integration/test_end_to_end.py:22-56 used a MockSolver).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)

CFG_RBGS = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-10)
CFG_JAC = MultigridConfig(smoother="jacobi", omega=0.8, tol=1e-10)


def _solve(prob, cfg, dtype="float64", **kw):
    levels = mg.build_hierarchy(
        prob.grid, prob.spec, a=prob.a, lam=prob.lam, dtype=dtype, cfg=cfg
    )
    f = prob.rhs(jnp.dtype(dtype) if dtype != "float64" else jnp.float64)
    return mg.mg_solve(levels, f, prob.initial_guess(jnp.float64), cfg, **kw)


def test_baseline_config1_jacobi_v22():
    """BASELINE config 1: 129^2 Poisson, fp64 V(2,2) Jacobi -> 1e-10, rho~0.2."""
    prob = P.poisson_mms_sinsin(129)
    u, info = _solve(prob, CFG_JAC)
    assert info["converged"]
    assert info["convergence_factor"] < 0.25
    assert prob.error_norms(u)["l2"] < 5e-5


def test_rbgs_convergence_factor():
    prob = P.poisson_mms_sinsin(65)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"] and info["iterations"] <= 12
    assert info["convergence_factor"] < 0.12


def test_grid_convergence_order_two():
    errors = {}
    h1 = {}
    for n in (17, 33, 65):
        prob = P.poisson_mms_sinsin(n)
        u, info = _solve(prob, CFG_RBGS)
        assert info["converged"]
        e = prob.error_norms(u)
        errors[n] = e["l2"]
        h1[n] = e["h1"]
    order1 = np.log2(errors[17] / errors[33])
    order2 = np.log2(errors[33] / errors[65])
    assert 1.8 < order1 < 2.2 and 1.8 < order2 < 2.2
    # Discrete H1-seminorm of the nodal error also superconverges at O(h^2)
    # for the 5-point scheme on smooth solutions (the nodal error is
    # h^2*phi(x,y) with smooth phi).
    h1_order = np.log2(h1[33] / h1[65])
    assert 1.7 < h1_order < 2.3
    assert h1[65] > 0.0


def test_h_independent_iterations():
    iters = []
    for n in (33, 65, 129):
        prob = P.poisson_mms_sinsin(n)
        _, info = _solve(prob, CFG_RBGS)
        iters.append(info["iterations"])
    assert max(iters) - min(iters) <= 2


@pytest.mark.parametrize("cycle", ["W", "F"])
def test_w_and_f_cycles(cycle):
    prob = P.poisson_mms_sinsin(33)
    cfg = CFG_RBGS.replace(cycle=cycle)
    u, info = _solve(prob, cfg)
    assert info["converged"]
    assert info["iterations"] <= 8


def test_fmg_initialization_saves_cycles():
    prob = P.poisson_mms_sinsin(65)
    _, info_plain = _solve(prob, CFG_RBGS)
    _, info_fmg = _solve(prob, CFG_RBGS, use_fmg=True)
    assert info_fmg["converged"]
    assert info_fmg["iterations"] < info_plain["iterations"]


def test_helmholtz_real_solve():
    prob = P.helmholtz_mms(65, k=2.0)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"]
    assert prob.error_norms(u)["l2"] < 2e-4


def test_variable_coefficient_real_solve():
    prob = P.variable_coefficient_mms(65)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"]
    assert info["convergence_factor"] < 0.2
    assert prob.error_norms(u)["l2"] < 2e-4


def test_jump_coefficient_converges():
    prob = P.jump_coefficient_problem(65, ratio=1e3)
    u, info = _solve(prob, CFG_RBGS.replace(max_iterations=60))
    assert info["converged"]


def test_neumann_mixed_bc():
    prob = P.neumann_test_problem(65)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"]
    assert info["convergence_factor"] < 0.15
    # x^2+y^2 is exactly represented by the discretization
    assert prob.error_norms(u)["l2"] < 1e-9


def test_robin_bc():
    """Robin (alpha*u + beta*du/dn = g) on the east side: the centered ghost
    elimination is exact for quadratics, so u = x^2+y^2 solves to round-off
    (reference advanced_bc.py:139-180 used one-sided differences — first
    order; ours is second order)."""
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg2
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P2,
    )

    for n in (17, 33):
        prob = P2.robin_test_problem(n)
        levels = mg2.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                     cfg=CFG_RBGS)
        u, info = mg2.mg_solve(levels, prob.rhs(jnp.float64),
                               prob.initial_guess(jnp.float64), CFG_RBGS)
        assert info["converged"]
        assert prob.error_norms(u)["l2"] < 1e-9


def test_inhomogeneous_dirichlet():
    prob = P.poisson_mms_inhomogeneous(33)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"]
    assert prob.error_norms(u)["l2"] < 1e-10  # exact discretization


def test_anisotropic_domain():
    prob = P.poisson_mms_anisotropic(65)
    u, info = _solve(prob, CFG_RBGS)
    assert info["converged"]


def test_history_monotone_and_rho():
    prob = P.poisson_mms_sinsin(65)
    _, info = _solve(prob, CFG_RBGS)
    h = info["history"]
    assert np.all(np.diff(h) < 0)
    assert 0 < info["convergence_factor"] < 1


CFG = CFG_RBGS


class TestIrregularDomains:
    """L-shaped / corner-singularity / boundary-layer problems
    (reference applications/test_problems.py:161-295; VERDICT.md missing #4)."""

    def test_boundary_layer_order2(self):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
            convergence_study)
        st = convergence_study(P.boundary_layer_problem, [33, 65, 129],
                               precision="fp64", cfg=CFG)
        assert st["converged"]
        assert st["order_l2"] > 1.85

    def test_corner_singularity_reduced_order(self):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
            convergence_study)
        st = convergence_study(P.corner_singularity_problem, [33, 65, 129],
                               precision="fp64", cfg=CFG)
        assert st["converged"]
        # H^(1+2/3) regularity: order between 4/3 and 2
        assert 1.2 < st["order_l2"] < 2.0
        # h-independent iterations despite the singularity
        assert max(st["iterations"]) - min(st["iterations"]) <= 2

    def test_l_shaped_domain_solve(self):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
            convergence_study)
        st = convergence_study(P.l_shaped_problem, [33, 65, 129],
                               precision="fp64", cfg=CFG)
        assert st["converged"]
        assert 1.1 < st["order_l2"] < 1.6  # ~4/3 for the 3pi/2 corner
        assert max(st["iterations"]) - min(st["iterations"]) <= 2

    def test_l_shaped_solution_zero_in_cut(self):
        """Nodes strictly inside the removed quadrant never change."""
        import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
        prob = P.l_shaped_problem(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    domain=prob.domain, cfg=CFG)
        f = prob.rhs(jnp.float64)
        u, info = mg.mg_solve(levels, f, prob.initial_guess(jnp.float64), CFG)
        assert info["converged"]
        un = np.asarray(u)
        g = prob.grid
        X, Y = g.coordinates(padded=True)
        cut_open = (X > 0.5 + 1e-9) & (Y > 0.5 + 1e-9) \
            & (X <= 1.0 + 1e-9) & (Y <= 1.0 + 1e-9)
        assert np.max(np.abs(un[cut_open])) == 0.0

    def test_boundary_driven_tolerance_scale(self):
        """f = 0 problems must still report converged (relative tolerance
        falls back to the initial-residual scale)."""
        import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
        prob = P.corner_singularity_problem(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        u, info = mg.mg_solve(levels, prob.rhs(jnp.float64),
                              prob.initial_guess(jnp.float64), CFG)
        assert info["converged"]
        assert info["iterations"] < 15


def test_rectangular_grid_and_domain_order2():
    """Non-square grid (33x65) on a non-square domain [0,1]x[0,2]
    (hx != hy): the whole stack — stencil, masks, parity transfers,
    smoothing — must stay second order."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid

    PI = np.pi
    errors = {}
    for k, (nx, ny) in enumerate(((17, 33), (33, 65), (65, 129))):
        g = Grid(nx, ny, (0.0, 1.0, 0.0, 2.0))
        prob = P.from_callables(
            f"rect_{nx}x{ny}", g,
            u_exact=lambda X, Y: np.sin(PI * X) * np.sin(PI * Y / 2.0),
            f=lambda X, Y: (PI**2 + PI**2 / 4.0)
            * np.sin(PI * X) * np.sin(PI * Y / 2.0),
        )
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG_RBGS)
        u, info = mg.mg_solve(levels, prob.rhs(jnp.float64),
                              prob.initial_guess(jnp.float64), CFG_RBGS)
        assert info["converged"], (nx, ny, info)
        errors[k] = prob.error_norms(u)["l2"]
    o1 = np.log2(errors[0] / errors[1])
    o2 = np.log2(errors[1] / errors[2])
    assert 1.8 < o1 < 2.2 and 1.8 < o2 < 2.2, (o1, o2, errors)


@pytest.mark.parametrize("n", [33, 65, 129])
@pytest.mark.parametrize("smoother,omega,bound", [("rbgs", 1.0, 0.08),
                                                  ("jacobi", 0.8, 0.2)])
def test_vcycle_contraction_from_entry_level(n, smoother, omega, bound):
    """Asymptotic V(2,2) contraction on A e = 0 from a random start, from
    the small entry levels the cycle's coarse tail runs through: h-
    independent (measured 0.045 RB-GS, 0.13 Jacobi at 33^2-129^2)."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid

    cfg = MultigridConfig(smoother=smoother, omega=omega, tol=0.0,
                          rtol=False, max_iterations=8, coarse_sweeps=8)
    levels = mg.build_hierarchy(Grid(n, n), dtype="float64", cfg=cfg)
    g = levels[0].grid
    rng = np.random.default_rng(n)
    u0 = np.zeros(g.shape_padded)
    u0[1:n - 1, 1:n - 1] = rng.standard_normal((n - 2, n - 2))
    _, info = mg.mg_solve(levels, jnp.zeros(g.shape_padded),
                          jnp.asarray(u0), cfg)
    assert info["iterations"] == 8
    assert 0.0 < info["convergence_factor"] < bound
