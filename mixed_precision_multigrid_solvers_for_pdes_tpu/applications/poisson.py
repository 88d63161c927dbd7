"""High-level Poisson/elliptic frontend.

Counterpart of the reference's ``PoissonSolver2D`` facade
(reference applications/poisson_solver.py:35-460): solve a Problem with one
call, pick precision, measure errors, and run grid-convergence
studies with observed-order fits.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import Precision, PrecisionPolicy, as_dtype, policy as make_policy
from ..models.problems import Problem
from ..solvers import multigrid as mg_mod, refinement
from ..solvers.multigrid import MultigridConfig


@dataclasses.dataclass
class PoissonResult:
    """Solution + solve metadata (reference poisson_solver.py:118-189 returns
    a similar dict; a typed record is friendlier)."""

    u: Any
    info: Dict[str, Any]
    errors: Optional[Dict[str, float]] = None
    solve_time: float = 0.0

    @property
    def iterations(self) -> int:
        return self.info["iterations"]

    @property
    def converged(self) -> bool:
        return self.info["converged"]


def solve_poisson(
    problem: Problem,
    *,
    precision: Any = "fp32",
    cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
    use_fmg: bool = False,
    mesh=None,
) -> PoissonResult:
    """Solve ``A u = f`` for a models.problems.Problem.

    precision:
      'fp32'/'fp64'/'bf16' — uniform solve at that dtype.
      'mixed'              — per-level dtypes (fine fp32, coarse bf16) with a
                             float64 outer residual via iterative refinement.
      'adaptive'           — staged promotion (solvers.refinement.adaptive_solve).
      'auto'               — measured per-problem selection: micro-benchmarks
                             fp32/mixed/adaptive on THIS problem and picks the
                             fastest that holds accuracy, cached per problem
                             signature (precision_analysis.autotune — the
                             measured counterpart of reference
                             gpu/gpu_precision.py:421-547).
      a PrecisionPolicy    — used directly.

    ``mesh`` (jax.sharding.Mesh) runs the solve SPMD over the device mesh in
    EVERY precision mode — uniform, mixed/IR, and adaptive — with per-level
    block-partition constraints (coarse levels replicate below the tile
    threshold)."""
    if isinstance(precision, PrecisionPolicy):
        pol = precision
    elif precision == "auto":
        from .precision_analysis import autotune

        pol = make_policy(autotune(problem, cfg=cfg))
    else:
        pol = make_policy(precision) if isinstance(precision, str) else make_policy("fp32")

    constrain = None
    if mesh is not None:
        from ..parallel import distributed as dist_mod
        constrain = dist_mod.make_constrainer(mesh)

    def _shard(*arrays):
        if mesh is None:
            return arrays if len(arrays) > 1 else arrays[0]
        from ..parallel import distributed as dist_mod
        sh = dist_mod._sharding_fn(mesh)(mesh, problem.grid)
        out = tuple(jax.device_put(a, sh) for a in arrays)
        return out if len(out) > 1 else out[0]

    t0 = time.perf_counter()
    if pol.mode == Precision.ADAPTIVE:
        u, info = refinement.adaptive_solve(
            problem.grid, problem.spec, problem.rhs(jnp.float64),
            problem.initial_guess(jnp.float64),
            a=problem.a, lam=problem.lam, domain=problem.domain,
            policy=pol, cfg=cfg, mesh=mesh,
        )
    elif pol.mode == Precision.MIXED:
        levels = mg_mod.build_hierarchy(
            problem.grid, problem.spec, a=problem.a, lam=problem.lam,
            domain=problem.domain, policy=pol, cfg=cfg,
        )
        f64, u64 = _shard(problem.rhs(jnp.float64),
                          problem.initial_guess(jnp.float64))
        u, info = refinement.ir_solve(
            levels, f64, u64, cfg, inner_cycles=2, use_fmg=use_fmg,
            constrain=constrain,
        )
    else:
        dt = pol.mode.dtype
        levels = mg_mod.build_hierarchy(
            problem.grid, problem.spec, a=problem.a, lam=problem.lam,
            domain=problem.domain, dtype=dt, cfg=cfg,
        )
        if dt == jnp.float32 and cfg.tol < 1e-6:
            # fp32 cycles cannot reach below ~1e-7 relative; wrap in IR
            f64, u64 = _shard(problem.rhs(jnp.float64),
                              problem.initial_guess(jnp.float64))
            u, info = refinement.ir_solve(
                levels, f64, u64, cfg, inner_cycles=2, constrain=constrain,
            )
        else:
            fd, ud = _shard(problem.rhs(dt), problem.initial_guess(dt))
            u, info = mg_mod.mg_solve(
                levels, fd, ud, cfg, use_fmg=use_fmg, constrain=constrain,
            )
    jax.block_until_ready(u)
    dt_solve = time.perf_counter() - t0

    errors = problem.error_norms(u) if problem.exact is not None else None
    return PoissonResult(u=u, info=info, errors=errors, solve_time=dt_solve)


def observed_order(hs: np.ndarray, errs: np.ndarray) -> float:
    """Least-squares slope of log(err) vs log(h)
    (reference poisson_solver.py:315-396 computes pairwise orders; the
    regression over the whole ladder is more robust)."""
    hs, errs = np.asarray(hs, float), np.asarray(errs, float)
    good = errs > 0
    if good.sum() < 2:
        return float("nan")
    return float(np.polyfit(np.log(hs[good]), np.log(errs[good]), 1)[0])


def convergence_study(
    problem_factory: Callable[[int], Problem],
    sizes: List[int],
    *,
    precision: Any = "fp64",
    cfg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0),
) -> Dict[str, Any]:
    """h-refinement study: solve on a grid ladder, fit the observed order.

    Returns {'sizes', 'h', 'l2', 'linf', 'h1', 'order_l2', 'order_linf',
    'order_h1', 'iterations'}
    (reference poisson_solver.py:315-396, mms_validation.py:279-553)."""
    rows = []
    for n in sizes:
        prob = problem_factory(n)
        res = solve_poisson(prob, precision=precision, cfg=cfg)
        if prob.exact is None:
            raise ValueError("convergence study needs exact solutions")
        rows.append(
            dict(n=n, h=max(prob.grid.hx, prob.grid.hy),
                 iterations=res.iterations, converged=res.converged,
                 **res.errors)
        )
    return fit_study(list(sizes), rows)


def fit_study(sizes: List[int], rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Order-fit tail shared by the 2D and 3D convergence studies: each row
    carries h/l2/linf/h1/iterations/converged for one ladder size."""
    h = np.array([r["h"] for r in rows])
    l2 = np.array([r["l2"] for r in rows])
    linf = np.array([r["linf"] for r in rows])
    h1 = np.array([r.get("h1", np.nan) for r in rows])
    pairwise = list(np.log(l2[:-1] / l2[1:]) / np.log(h[:-1] / h[1:]))
    return {
        "sizes": list(sizes),
        "h": h,
        "l2": l2,
        "linf": linf,
        "h1": h1,
        "iterations": [r["iterations"] for r in rows],
        "converged": all(r["converged"] for r in rows),
        "order_l2": observed_order(h, l2),
        "order_linf": observed_order(h, linf),
        "order_h1": observed_order(h[np.isfinite(h1)], h1[np.isfinite(h1)]),
        "pairwise_orders": pairwise,
    }
