"""Multi-device tests on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — coverage the reference could not
have without >=2 physical GPUs (reference test_gpu_acceleration.py:476-517)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu import parallel
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import smooth as smooth_mod
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)

CFG = MultigridConfig(smoother="rbgs", omega=1.0)

pytestmark = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs the 8-device virtual mesh"
)


@pytest.fixture(scope="module")
def mesh():
    return parallel.make_mesh(jax.devices()[:8])


class TestMeshConstruction:
    def test_mesh_shape_near_square(self):
        assert parallel.choose_mesh_shape(8) in ((2, 4), (4, 2))
        assert parallel.choose_mesh_shape(4) == (2, 2)
        assert parallel.choose_mesh_shape(1) == (1, 1)

    def test_grid_sharding_agglomerates_coarse(self, mesh):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid

        fine = parallel.grid_sharding(mesh, Grid(129, 129))
        coarse = parallel.grid_sharding(mesh, Grid(5, 5))
        assert fine.spec != coarse.spec
        assert coarse.spec == jax.sharding.PartitionSpec(None, None)


class TestShardedSolve:
    def test_matches_single_device(self, mesh):
        """The sharded solve must produce the single-device solution."""
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, CFG)
        u_sh, info_sh = parallel.sharded_solve(mesh, levels, f, cfg=CFG)
        assert info_sh["converged"]
        assert info_sh["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)

    def test_galerkin_sharded_matches_single_device(self, mesh):
        """Galerkin (9-point) hierarchies under GSPMD: the diagonal
        couplings' rolls cross shard boundaries in both axes at once; XLA
        must insert the corner halo exchanges. Bit-match vs single device."""
        cfg = CFG.replace(coarsening="galerkin")
        prob = P.jump_coefficient_problem(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    dtype="float64", cfg=cfg)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, cfg)
        u_sh, info_sh = parallel.sharded_solve(mesh, levels, f, cfg=cfg)
        assert info_sh["converged"]
        assert info_sh["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)

    def test_neumann_sharded(self, mesh):
        prob = P.neumann_test_problem(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        u, info = parallel.sharded_solve(
            mesh, levels, prob.rhs(jnp.float64),
            prob.initial_guess(jnp.float64), cfg=CFG)
        assert info["converged"]
        assert prob.error_norms(u)["l2"] < 1e-3


class TestGradedAgglomeration:
    """Sub-mesh coarse agglomeration: mid levels shard over the outer mesh
    factors only (small replica groups) instead of jumping straight from
    fully-sharded to fully-replicated."""

    @pytest.fixture(scope="class")
    def gmesh(self):
        return parallel.make_graded_mesh(jax.devices()[:8])

    def test_three_tiers(self, gmesh):
        from jax.sharding import PartitionSpec
        from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid

        # 8 devices near-square -> (mx, my) = (2, 4) or (4, 2); inner factor
        # 2 on each even axis
        sizes = dict(zip(gmesh.axis_names,
                         (gmesh.shape[a] for a in gmesh.axis_names)))
        assert sizes["xo"] * sizes["xi"] * sizes["yo"] * sizes["yi"] == 8

        fine = parallel.graded_sharding(gmesh, Grid(257, 257)).spec
        mid = parallel.graded_sharding(gmesh, Grid(33, 33)).spec
        coarse = parallel.graded_sharding(gmesh, Grid(5, 5)).spec
        # 8 devices -> (mx, my) = (2, 4) -> factored (1, 2, 2, 2)
        assert fine == PartitionSpec(("xo", "xi"), ("yo", "yi"))
        # 33//4 < 16 <= 33//2: the 4-way y axis drops to its outer factor
        # (2-device sub-mesh, 2-way replica groups); x keeps the full tier
        assert mid == PartitionSpec(("xo", "xi"), "yo")
        assert coarse == PartitionSpec(None, None)

    def test_solve_matches_single_device(self, gmesh):
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, CFG)
        u_sh, info_sh = parallel.sharded_solve(gmesh, levels, f, cfg=CFG)
        assert info_sh["converged"]
        assert info_sh["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)


class TestExplicitHalo:
    def test_shard_smooth_matches_xla(self, mesh):
        """shard_map+ppermute smoothing == whole-array XLA smoothing, exactly."""
        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        lev = levels[0]
        key = jax.random.PRNGKey(0)
        u = jnp.where(lev.unknown,
                      jax.random.normal(key, lev.grid.shape_padded,
                                        jnp.float64), 0.0)
        f = prob.rhs(jnp.float64)
        for method in ("jacobi", "rbgs"):
            ref = smooth_mod.smooth(lev.stencil, u, f, lev.unknown,
                                    method=method, sweeps=3, omega=0.9)
            got = parallel.shard_smooth(mesh, lev, u, f, method=method,
                                        sweeps=3, omega=0.9)
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       rtol=0, atol=1e-13, err_msg=method)

    def test_global_residual_norm_matches(self, mesh):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.ops import (
            norms,
            stencil as st_mod,
        )

        prob = P.poisson_mms_sinsin(65)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=CFG)
        lev = levels[0]
        f = prob.rhs(jnp.float64)
        u = jnp.zeros(lev.grid.shape_padded, jnp.float64)
        ref = norms.scaled_l2(
            st_mod.residual(lev.stencil, u, f, lev.unknown),
            lev.grid.hx, lev.grid.hy)
        got = parallel.global_residual_norm(mesh, lev, u, f)
        assert float(got) == pytest.approx(float(ref), rel=1e-12)


class TestShardedHeat:
    """Sharded time stepping: the whole scan runs SPMD over the mesh and must
    reproduce the single-device trajectory (the reference's multi-GPU path
    was steady-state only, reference gpu/multi_gpu_solver.py:244)."""

    def _problem(self):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
            heat_problems as HP,
        )
        return HP.pure_diffusion(65)

    def _cfg(self, scheme):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.heat import (
            HeatConfig,
        )
        return HeatConfig(scheme=scheme, cycles_per_step=2, dtype="float64",
                          mg=CFG)

    @pytest.mark.parametrize("scheme", [
        "crank_nicolson",
        pytest.param("bdf2", marks=pytest.mark.slow),
        "explicit",
    ])
    def test_matches_single_device(self, mesh, scheme):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.heat import (
            solve_heat,
        )
        dt = 0.002 if scheme != "explicit" else None
        kw = dict(t_final=0.01, dt=dt)
        if scheme == "explicit":
            kw = dict(t_final=2e-4, n_steps=5)
        res_ref = solve_heat(self._problem(), cfg=self._cfg(scheme), **kw)
        res_sh = solve_heat(self._problem(), cfg=self._cfg(scheme),
                            mesh=mesh, **kw)
        assert res_sh.steps == res_ref.steps
        np.testing.assert_allclose(
            np.asarray(res_sh.u), np.asarray(res_ref.u), rtol=0, atol=1e-12)
        # and the trajectory is actually accurate, not just consistent
        assert res_sh.errors["l2"] < 5e-3

    def test_output_is_sharded(self, mesh):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.heat import (
            solve_heat,
        )
        res = solve_heat(self._problem(), t_final=0.004, dt=0.002,
                         cfg=self._cfg("crank_nicolson"), mesh=mesh)
        assert len(res.u.sharding.device_set) == 8


class TestShardedLineSmoothers:
    def test_adi_sharded_matches_single_device(self, mesh):
        """ADI/line smoothing uses PCR tridiagonal solves along full grid
        lines; under GSPMD a line crosses device boundaries, so XLA inserts
        the collectives. Must match the single-device solve."""
        prob = P.poisson_mms_anisotropic(65, ay=0.01)
        cfg = MultigridConfig(smoother="adi", tol=1e-10)
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    dtype="float64", cfg=cfg)
        f = prob.rhs(jnp.float64)
        u_ref, info_ref = mg.mg_solve(levels, f, None, cfg)
        u_sh, info_sh = parallel.sharded_solve(mesh, levels, f, cfg=cfg)
        assert info_sh["converged"]
        assert info_sh["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)


class TestShardedFrontend:
    """solve_poisson(mesh=...) must match the unsharded result in every
    precision mode (uniform / mixed-IR / adaptive)."""

    @pytest.mark.parametrize("precision", [
        "fp64",
        "mixed",
        pytest.param("adaptive", marks=pytest.mark.slow),
    ])
    def test_matches_single_device(self, mesh, precision):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
            solve_poisson,
        )
        cfg = CFG.replace(tol=1e-8)
        ref = solve_poisson(P.poisson_mms_sinsin(65), precision=precision,
                            cfg=cfg)
        sh = solve_poisson(P.poisson_mms_sinsin(65), precision=precision,
                           cfg=cfg, mesh=mesh)
        assert sh.converged and ref.converged
        assert sh.iterations == ref.iterations
        np.testing.assert_allclose(np.asarray(sh.u), np.asarray(ref.u),
                                   rtol=0, atol=1e-11)


class TestShardedKrylov:
    def test_mg_preconditioned_pcg_matches_single_device(self, mesh):
        """MG-preconditioned CG over sharded inputs: the Krylov loop's
        whole-array ops propagate the input sharding; the preconditioner
        cycles carry explicit per-level constraints."""
        from mixed_precision_multigrid_solvers_for_pdes_tpu.preconditioning import (
            multigrid_preconditioner,
        )
        from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import krylov

        prob = P.poisson_mms_sinsin(65)
        cfg = CFG.replace(cycle="V", pre_sweeps=2, post_sweeps=2,
                          symmetric=True)
        levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                    cfg=cfg)
        lev0 = levels[0]
        mv = krylov.stencil_matvec(lev0.stencil, lev0.unknown, lev0.sync)
        f = prob.rhs(jnp.float64)

        M_ref = multigrid_preconditioner(levels, cfg)
        u_ref, info_ref = krylov.pcg(mv, f, precond=M_ref, tol=1e-10,
                                     maxiter=30)

        con = parallel.make_constrainer(mesh)
        M_sh = multigrid_preconditioner(levels, cfg, constrain=con)
        f_sh = parallel.shard_inputs(mesh, levels, f)
        u_sh, info_sh = krylov.pcg(mv, f_sh, precond=M_sh, tol=1e-10,
                                   maxiter=30)
        assert info_sh["converged"]
        assert info_sh["iterations"] == info_ref["iterations"]
        np.testing.assert_allclose(np.asarray(u_sh), np.asarray(u_ref),
                                   rtol=0, atol=1e-11)


class TestDryrun:
    def test_graft_entry_dryrun(self):
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "graft_entry", "/root/repo/__graft_entry__.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.dryrun_multichip(8)


class TestConstrainerIdentity:
    def test_constrainers_compare_equal_per_mesh(self, mesh):
        from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import (
            distributed,
        )

        a = distributed.make_constrainer(mesh)
        b = distributed.make_constrainer(mesh)
        assert a == b and hash(a) == hash(b)
        assert a != distributed.make_constrainer(mesh, 32)
        assert a != distributed.make_constrainer3d(mesh)

    def test_sharded_solve_compiles_once(self, mesh):
        """Each solve_poisson(mesh=...) call builds a fresh hook; equal
        hooks must hit the jit cache instead of compiling the solve again."""
        from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
            solve_poisson,
        )
        from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import (
            refinement,
        )

        prob = P.poisson_mms_sinsin(33)
        cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
        before = refinement._ir_jit._cache_size()
        for _ in range(2):
            res = solve_poisson(prob, precision="mixed", cfg=cfg, mesh=mesh)
            assert res.converged
        assert refinement._ir_jit._cache_size() == before + 1
