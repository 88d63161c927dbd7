"""Per-segment mixed boundary conditions (reference
boundary_conditions/advanced_bc.py:219-334 MixedBoundaryCondition):
spec validation, segment-aware unknown masks, ghost elimination through the
whole solver stack and O(h^2) MMS convergence.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu.core import bc as bc_mod
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.bc import (
    BCKind, BCSegment, BCSide, BoundarySpec,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.grid import Grid
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)

CFG = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-10)


def _solve(prob, cfg=CFG, **kw):
    levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a, lam=prob.lam,
                                dtype="float64", cfg=cfg)
    return mg.mg_solve(levels, prob.rhs(jnp.float64),
                       prob.initial_guess(jnp.float64), cfg, **kw)


class TestSpecValidation:
    def test_bad_interval_rejected(self):
        with pytest.raises(ValueError, match="lo < hi"):
            BCSegment(0.7, 0.3, kind=BCKind.NEUMANN)
        with pytest.raises(ValueError, match="lo < hi"):
            BCSegment(-0.1, 0.5)

    def test_periodic_segment_rejected(self):
        with pytest.raises(ValueError, match="periodic"):
            BCSegment(0.0, 0.5, kind=BCKind.PERIODIC)

    def test_overlap_rejected(self):
        with pytest.raises(ValueError, match="overlapping"):
            BCSide(segments=(BCSegment(0.0, 0.6, kind=BCKind.NEUMANN),
                             BCSegment(0.5, 1.0, kind=BCKind.ROBIN,
                                       alpha=1.0, beta=1.0)))

    def test_segments_on_periodic_side_rejected(self):
        with pytest.raises(ValueError, match="periodic side"):
            BCSide(kind=BCKind.PERIODIC,
                   segments=(BCSegment(0.0, 0.5),))

    def test_kinds_and_gate_properties(self):
        side = BCSide(kind=BCKind.DIRICHLET,
                      segments=(BCSegment(0.5, 1.0, kind=BCKind.NEUMANN),))
        assert side.kinds == {BCKind.DIRICHLET, BCKind.NEUMANN}
        spec = BoundarySpec(west=side)
        assert not spec.all_dirichlet
        assert not spec.plain
        assert spec.any_segments
        # Dirichlet-only segments keep all_dirichlet True
        spec2 = BoundarySpec(west=BCSide(segments=(BCSegment(0.0, 0.5),)))
        assert spec2.all_dirichlet and spec2.plain


class TestSegmentMask:
    def test_unknown_mask_segment_nodes(self):
        """West side of a 9x9 grid: Neumann on y in [0.25, 0.75] -> boundary
        nodes j = 2..6 are unknowns, j = 0, 1, 7, 8 stay Dirichlet-fixed."""
        n = 9
        g = Grid(n, n)
        spec = BoundarySpec(west=BCSide(
            segments=(BCSegment(0.25, 0.75, kind=BCKind.NEUMANN),)))
        m = np.asarray(bc_mod.unknown_mask(n, n, g.shape_padded, spec))
        # interior unchanged
        assert m[1:n - 1, 1:n - 1].all()
        # west ring: Neumann segment nodes are unknowns
        expect = np.zeros(n, bool)
        expect[2:7] = True
        # corners shared with Dirichlet south/north stay fixed regardless
        np.testing.assert_array_equal(m[0, :n], expect)
        # other rings fully fixed
        assert not m[n - 1, :n].any()
        assert not m[:n, 0].any() and not m[:n, n - 1].any()

    def test_first_segment_wins_at_touching_endpoint(self):
        n = 9
        g = Grid(n, n)
        spec = BoundarySpec(west=BCSide(
            segments=(BCSegment(0.0, 0.5, kind=BCKind.NEUMANN),
                      BCSegment(0.5, 1.0, kind=BCKind.DIRICHLET))))
        regions = bc_mod.side_regions("west", n, n, g.shape_padded,
                                      spec.west)
        # the shared node at frac 0.5 (j = 4) belongs to the first segment
        neu_mask = np.asarray(regions[0][1])
        dir_mask = np.asarray(regions[1][1])
        assert neu_mask[0, 4] and not dir_mask[0, 4]
        # regions partition the side
        total = neu_mask | dir_mask | np.asarray(regions[2][1])
        base = np.asarray(bc_mod.side_mask("west", n, n, g.shape_padded))
        np.testing.assert_array_equal(total & base, base)
        assert not (neu_mask & dir_mask).any()

    def test_sharded_mask_matches_padded(self):
        """unknown_mask_at from block-global indices reproduces the padded
        mask (the halo_solve contract)."""
        n = 17
        g = Grid(n, n)
        spec = BoundarySpec(
            north=BCSide(segments=(
                BCSegment(0.25, 0.6, kind=BCKind.ROBIN, alpha=2.0, beta=1.0),
            )))
        import jax

        gi = jax.lax.broadcasted_iota(jnp.int32, g.shape_padded, 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, g.shape_padded, 1)
        m_at = np.asarray(bc_mod.unknown_mask_at(spec, n, n, gi, gj))
        m = np.asarray(bc_mod.unknown_mask(n, n, g.shape_padded, spec))
        np.testing.assert_array_equal(m_at, m)


class TestMixedSegmentSolve:
    def test_exact_quadratic(self):
        """Dirichlet|Robin split on east + Neumann|Dirichlet split on north:
        quadratic MMS solves to rounding (every elimination exact)."""
        prob = P.mixed_segment_problem(65)
        u, info = _solve(prob)
        assert info["converged"]
        assert prob.error_norms(u)["l2"] < 1e-9

    def test_convergence_factor_bounded(self):
        """Rediscretized coarse operators are locally inconsistent at the
        segment junction, which costs cycle speed (measured rho 0.23/0.31/
        0.39 at 33/65/129 — h-DEPENDENT, unlike whole-side Neumann's ~0.13);
        the cycle still converges robustly. Galerkin RAP coarsening restores
        junction consistency (see test_galerkin_restores_h_independence)."""
        prob = P.mixed_segment_problem(65)
        _, info = _solve(prob)
        assert info["converged"]
        assert info["convergence_factor"] < 0.45

    def test_galerkin_restores_h_independence(self):
        """Galerkin RAP coarse operators are consistent at the segment
        junction by construction: measured rho 0.054/0.065/0.074 at
        33/65/129 (h-independent) vs 0.23/0.31/0.39 rediscretized."""
        prob = P.mixed_segment_problem(65)
        _, info = _solve(prob, CFG.replace(coarsening="galerkin"))
        assert info["converged"]
        assert info["convergence_factor"] < 0.12

    def test_order_two_nonpolynomial(self):
        errs = {}
        for n in (17, 33, 65):
            prob = P.mixed_segment_mms(n)
            u, info = _solve(prob)
            assert info["converged"]
            errs[n] = prob.error_norms(u)["l2"]
        order1 = np.log2(errs[17] / errs[33])
        order2 = np.log2(errs[33] / errs[65])
        assert 1.8 < order1 < 2.2 and 1.8 < order2 < 2.2
