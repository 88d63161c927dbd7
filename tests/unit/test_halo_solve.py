"""Full-solve explicit-distribution path (parallel/halo_solve.py) vs the
GSPMD path, on the virtual 8-device CPU mesh.

The VERDICT-2 acceptance criterion: the entire mg_solve (transfers, coarse
agglomeration, norms, outer while_loop) runs inside one shard_map region with
ppermute halos and matches the GSPMD solve for Poisson, variable-coefficient,
and Neumann problems.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu import parallel
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import halo_solve
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)

CFG = MultigridConfig(smoother="rbgs", omega=1.0,
                      max_iterations=30)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh"
)


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(jax.devices()[:8], shape=(2, 4))


def _compare(mesh, prob, cfg=CFG, dtype="float64", atol=1e-11):
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                                dtype=dtype, cfg=cfg)
    f = prob.rhs(jnp.float64)
    u0 = prob.initial_guess(jnp.float64)
    u_ref, info_ref = parallel.sharded_solve(mesh, levels, f, u0, cfg=cfg)
    u_h, info_h = halo_solve.halo_solve(mesh, levels, f, u0, cfg=cfg)
    assert info_h["converged"]
    assert info_h["iterations"] == info_ref["iterations"]
    np.testing.assert_allclose(np.asarray(u_h), np.asarray(u_ref),
                               rtol=0, atol=atol)
    return u_h, info_h


class TestHaloSolveMatchesGSPMD:
    def test_poisson(self, mesh):
        prob = P.poisson_mms_sinsin(129)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-4

    def test_variable_coefficient(self, mesh):
        prob = P.variable_coefficient_mms(65)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-3

    def test_galerkin_9point(self, mesh):
        """Galerkin (9-point) hierarchy on the explicit path: corner halo
        values route through the two-stage x-then-y assembly; the jump-
        coefficient solve must match the GSPMD solve bit-for-bit."""
        prob = P.jump_coefficient_problem(65)
        u, info = _compare(mesh, prob, cfg=CFG.replace(coarsening="galerkin"))
        assert info["convergence_factor"] < 0.11

    def test_periodic(self, mesh):
        """Fully periodic Helmholtz: the torus case. Unique nodes tile the
        mesh exactly (128 = 2*64 = 4*32), halos are cyclic ppermutes, and
        the solve must match the GSPMD (sync-ghost) path."""
        prob = P.periodic_helmholtz_mms(129)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-3

    def test_periodic_mixed_dirichlet(self, mesh):
        """x periodic, y Dirichlet: one cyclic mesh axis, one open."""
        from mixed_precision_multigrid_solvers_for_pdes_tpu.core import bc as bc_mod
        from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid
        from mixed_precision_multigrid_solvers_for_pdes_tpu.models.problems import (
            from_callables,
        )

        pi = np.pi
        spec = bc_mod.BoundarySpec(
            west=bc_mod.BCSide(kind=bc_mod.BCKind.PERIODIC),
            east=bc_mod.BCSide(kind=bc_mod.BCKind.PERIODIC),
            south=bc_mod.BCSide(kind=bc_mod.BCKind.DIRICHLET),
            north=bc_mod.BCSide(kind=bc_mod.BCKind.DIRICHLET),
        )
        prob = from_callables(
            "periodic_x_dirichlet_y", Grid(129, 129),
            u_exact=lambda X, Y: np.sin(2 * pi * X) * np.sin(pi * Y),
            f=lambda X, Y: 5 * pi**2 * np.sin(2 * pi * X) * np.sin(pi * Y),
            spec=spec,
        )
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-3

    def test_neumann(self, mesh):
        prob = P.neumann_test_problem(65)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-3

    def test_mixed_segments(self, mesh):
        """Per-segment mixed BCs (Neumann segment inside a Dirichlet side,
        reference advanced_bc.py:219-334) on the explicit-halo path: the
        sharded unknown masks and reflected restriction halos must reproduce
        the GSPMD solve exactly."""
        prob = P.mixed_segment_mms(65)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-3

    def test_mixed_segments_robin(self, mesh):
        """Dirichlet|Robin split east + Neumann|Dirichlet split north:
        quadratic MMS is discretization-exact even sharded."""
        prob = P.mixed_segment_problem(65)
        u, info = _compare(mesh, prob)
        assert prob.error_norms(u)["l2"] < 1e-9

    def test_w_cycle(self, mesh):
        prob = P.poisson_mms_sinsin(65)
        _compare(mesh, prob, cfg=CFG.replace(cycle="W"))

    def test_fp32_mixed_hierarchy(self, mesh):
        prob = P.poisson_mms_sinsin(65)
        # fp32 residual-evaluation floor at 65^2 is ~2e-4 absolute (~1e-5
        # relative); 1e-4 relative is honestly reachable
        cfg = CFG.replace(tol=1e-4)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32",
                                    cfg=cfg)
        f = prob.rhs(jnp.float32)
        u_ref, info_ref = parallel.sharded_solve(mesh, levels, f, cfg=cfg)
        u_h, info_h = halo_solve.halo_solve(mesh, levels, f, cfg=cfg)
        assert info_h["converged"]
        assert abs(info_h["iterations"] - info_ref["iterations"]) <= 1
        np.testing.assert_allclose(np.asarray(u_h), np.asarray(u_ref),
                                   rtol=0, atol=1e-5)


    def test_l_shaped_domain(self, mesh):
        """Irregular (masked) domains on the explicit path: block-local
        unknown masks include the DomainSpec interior (cut nodes are
        Dirichlet-fixed); must match GSPMD."""
        prob = P.l_shaped_problem(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec,
                                    domain=prob.domain, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u0 = prob.initial_guess(jnp.float64)
        u_ref, info_ref = parallel.sharded_solve(mesh, levels, f, u0, cfg=CFG)
        u_h, info_h = halo_solve.halo_solve(mesh, levels, f, u0, cfg=CFG)
        assert info_h["converged"]
        assert info_h["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_h), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)
        assert prob.error_norms(u_h)["l2"] < 5e-3


class TestHaloSolveVariants:
    def test_overlap_off_matches_on(self, mesh):
        """Interior-first overlap changes scheduling, not numerics."""
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u_on, _ = halo_solve.halo_solve(mesh, levels, f, cfg=CFG,
                                        overlap=True)
        u_off, _ = halo_solve.halo_solve(mesh, levels, f, cfg=CFG,
                                         overlap=False)
        np.testing.assert_allclose(np.asarray(u_on), np.asarray(u_off),
                                   rtol=0, atol=1e-13)

    def test_strip_mesh(self):
        """1D strip decomposition (8, 1) — halos in x only."""
        m = parallel.make_mesh(jax.devices()[:8], shape=(8, 1))
        prob = P.poisson_mms_sinsin(129)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, CFG)
        u_h, info_h = halo_solve.halo_solve(m, levels, f, cfg=CFG)
        assert info_h["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_h), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)

    def test_single_device_mesh_replicated(self):
        """mesh (1,1): S = 0, the solve runs the plain single-device path."""
        m = parallel.make_mesh(jax.devices()[:1], shape=(1, 1))
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, CFG)
        u_h, info_h = halo_solve.halo_solve(m, levels, f, cfg=CFG)
        assert info_h["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_h), np.asarray(u_ref),
                                   rtol=0, atol=1e-12)

    def test_line_smoother_raises(self, mesh):
        prob = P.poisson_mms_sinsin(65)
        cfg = CFG.replace(smoother="adi")
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=cfg)
        with pytest.raises(NotImplementedError):
            halo_solve.halo_solve(mesh, levels, prob.rhs(jnp.float64),
                                  cfg=cfg)
