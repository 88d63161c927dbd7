"""Precision policy + mixed-precision solve tests
(reference tests/unit/test_precision.py:17-249)."""

import jax.numpy as jnp
import numpy as np
import pytest

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
from mixed_precision_multigrid_solvers_for_pdes_tpu.core.precision import (
    Precision,
    PrecisionPolicy,
    as_dtype,
    policy,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import ir_solve
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
    MultigridConfig,
)

CFG = MultigridConfig(smoother="rbgs", omega=1.0)


def test_dtype_parsing():
    assert as_dtype("fp32") == jnp.float32
    assert as_dtype("double") == jnp.float64
    assert as_dtype("bf16") == jnp.bfloat16
    assert as_dtype(Precision.FP64) == jnp.float64


def test_level_dtypes_uniform_and_mixed():
    assert policy("fp64").level_dtypes(4) == (jnp.float64,) * 4
    mixed = policy("mixed").level_dtypes(6)
    assert mixed[:3] == (jnp.float32,) * 3
    assert mixed[3:] == (jnp.bfloat16,) * 3


def test_should_promote_stagnation():
    pol = PrecisionPolicy()
    decreasing = [1.0 * 0.1**k for k in range(8)]
    assert not pol.should_promote(decreasing)
    stagnant = [1.0, 0.5, 0.49, 0.488, 0.4875, 0.4874, 0.4874]
    assert pol.should_promote(stagnant)
    diverging = [1.0, 0.5, 0.6, 0.7, 0.8, 0.9, 1.1]
    assert pol.should_promote(diverging)
    assert not pol.should_promote([1.0, 0.5])  # too short


def test_threshold_decisions():
    pol = PrecisionPolicy(convergence_threshold=1e-6)
    assert pol.should_downgrade(1e-2)
    assert not pol.should_downgrade(1e-5)
    assert pol.should_upgrade(5e-6)
    assert not pol.should_upgrade(1e-4)


def test_fp32_hierarchy_reaches_fp32_floor():
    # the fp32 residual floor at 65^2 is ~1e-4 relative (eps32*||A||*||u||);
    # anything deeper needs iterative refinement (next test)
    prob = P.poisson_mms_sinsin(65)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32", cfg=CFG)
    cfg = CFG.replace(tol=1e-4, max_iterations=30)
    u, info = mg.mg_solve(levels, prob.rhs(jnp.float32),
                          prob.initial_guess(jnp.float32), cfg)
    assert info["converged"]
    assert prob.error_norms(u)["l2"] < 1e-3


def test_iterative_refinement_fp32_to_1e10():
    """fp32 cycles + fp64 residual reach fp64-level accuracy (the
    mixed-precision headline, cf. reference docs/results.md:451-458)."""
    prob = P.poisson_mms_sinsin(65)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32", cfg=CFG)
    cfg = CFG.replace(tol=1e-10)
    u, info = ir_solve(levels, prob.rhs(jnp.float64),
                       prob.initial_guess(jnp.float64), cfg)
    assert info["converged"]
    rel = info["residual_norm"] / info["rhs_norm"]
    assert rel <= 1e-10
    # iteration count within ~2x of the all-fp64 solve (reference criterion)
    levels64 = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64", cfg=CFG)
    _, info64 = mg.mg_solve(levels64, prob.rhs(jnp.float64),
                            prob.initial_guess(jnp.float64), cfg)
    assert info["iterations"] <= 2 * info64["iterations"] + 2


def test_iterative_refinement_with_fmg_start():
    """FMG initialization must cut outer refinements without losing accuracy."""
    prob = P.poisson_mms_sinsin(65)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32", cfg=CFG)
    cfg = CFG.replace(tol=1e-10)
    u_plain, info_plain = ir_solve(levels, prob.rhs(jnp.float64),
                                   prob.initial_guess(jnp.float64), cfg,
                                   inner_cycles=2)
    u_fmg, info_fmg = ir_solve(levels, prob.rhs(jnp.float64),
                               prob.initial_guess(jnp.float64), cfg,
                               inner_cycles=2, use_fmg=True)
    assert info_fmg["converged"]
    assert info_fmg["iterations"] <= info_plain["iterations"]
    import numpy as np

    np.testing.assert_allclose(np.asarray(u_fmg), np.asarray(u_plain),
                               atol=1e-9)


def test_mixed_hierarchy_bf16_coarse():
    prob = P.poisson_mms_sinsin(65)
    levels = mg.build_hierarchy(
        prob.grid, prob.spec, policy=policy("mixed"), cfg=CFG
    )
    assert levels[0].dtype == np.dtype(jnp.float32)
    assert levels[-1].dtype == jnp.bfloat16
    cfg = CFG.replace(tol=1e-10)
    u, info = ir_solve(levels, prob.rhs(jnp.float64),
                       prob.initial_guess(jnp.float64), cfg, max_outer=60)
    assert info["converged"]


def test_adaptive_solve():
    prob = P.poisson_mms_sinsin(65)
    cfg = CFG.replace(tol=1e-10, max_iterations=60)
    u, info = mg.solvers.adaptive_solve(
        prob.grid, prob.spec, prob.rhs(jnp.float64),
        prob.initial_guess(jnp.float64), cfg=cfg
    )
    assert info["converged"]
    assert prob.error_norms(u)["l2"] < 1e-3


def test_autotune_measures_and_caches(monkeypatch):
    """precision_analysis.autotune (the measured counterpart of reference
    gpu/gpu_precision.py:421-547): picks an accuracy-admissible fastest
    candidate and caches the strategy per problem signature."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
        precision_analysis as pa,
    )

    prob = P.poisson_mms_sinsin(33)
    cfg = CFG.replace(tol=1e-8)
    pa._AUTOTUNE_CACHE.clear()
    choice = pa.autotune(prob, cfg=cfg, candidates=("fp32", "fp64"), runs=1)
    assert choice in ("fp32", "fp64")

    # cache hit: a second call must not re-measure
    def boom(*a, **k):
        raise AssertionError("autotune re-measured a cached strategy")

    monkeypatch.setattr(pa, "benchmark_function", boom)
    assert pa.autotune(prob, cfg=cfg,
                       candidates=("fp32", "fp64"), runs=1) == choice


def test_solve_poisson_auto_precision():
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
        solve_poisson,
    )

    prob = P.poisson_mms_sinsin(33)
    res = solve_poisson(prob, precision="auto",
                        cfg=CFG.replace(tol=1e-8))
    assert res.converged
    assert res.errors["l2"] < 1e-3


@pytest.mark.parametrize("n", [65, 129])
def test_mixed_solve_poisson_fmg_start(n):
    """solve_poisson(precision='mixed', use_fmg=True) starts the refinement
    from an FMG guess: no more outer iterations than from zero, and the
    starting residual is already far below ||f||."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
        solve_poisson,
    )

    prob = P.poisson_mms_sinsin(n)
    cfg = CFG.replace(tol=1e-9)
    cold = solve_poisson(prob, precision="mixed", cfg=cfg)
    warm = solve_poisson(prob, precision="mixed", cfg=cfg, use_fmg=True)
    assert cold.converged and warm.converged
    assert warm.iterations <= cold.iterations
    assert warm.info["initial_residual_norm"] < 0.1 * warm.info["rhs_norm"]
    assert (warm.info["initial_residual_norm"]
            < cold.info["initial_residual_norm"])
