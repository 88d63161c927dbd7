"""Mixed-precision solves: iterative refinement and adaptive staging.

This is the replacement for the reference's runtime dtype
switching (reference core/precision.py:155-268, gpu/gpu_precision.py:229-289).
Under jit dtypes are static, so mixed precision is structured as:

1. **Iterative refinement** (``ir_solve``): the solution and residual live in
   float64 (cheap because it's O(N) work per outer step), while
   each correction is computed by low-precision multigrid cycles (fp32/bf16 —
   the fast path). Converges to fp64 accuracy as long as
   kappa(A)*eps_low < 1; for the 5-point Laplacian kappa ~ (2/pi/h)^2, so fp32
   inner cycles safely reach 1e-10 up to ~4097^2. This supersedes the
   reference's fp32-state/fp64-residual CUDA kernel
   (reference cuda_kernels.py:843-883) at the algorithm level.

2. **Adaptive staging** (``adaptive_solve``): a host-driven stage loop that
   starts at the lowest precision and promotes on the PrecisionPolicy's
   stagnation/threshold rules (reference core/precision.py:189-268 semantics),
   finishing with iterative refinement when the target is tighter than the
   working precision can represent.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.precision import Precision, PrecisionPolicy
from ..ops import norms, stencil as st_mod
from . import multigrid as mg_mod
from .multigrid import MultigridConfig, convergence_factor


@partial(jax.jit, static_argnames=("cfg", "inner_cycles", "max_outer",
                                   "use_fmg", "constrain"))
def _ir_jit(levels, st_hi, f, u0, cfg: MultigridConfig, inner_cycles: int,
            max_outer: int, use_fmg: bool = False, constrain=None):
    lev0 = levels[0]
    unknown = lev0.unknown
    sync0 = lev0.sync
    hx, hy = lev0.grid.hx, lev0.grid.hy
    lo = lev0.dtype

    f = f.astype(jnp.float64)
    u = u0.astype(jnp.float64)
    fnorm = norms.masked_scaled_l2(f, unknown, hx, hy)
    # relative scale max(||f||, ||r(u0)||), measured BEFORE the FMG start:
    # boundary-driven problems have f = 0
    r_init = st_mod.residual(st_hi, u, f, unknown, sync0)
    scale = jnp.maximum(fnorm, norms.scaled_l2(r_init, hx, hy))
    tol_eff = jnp.where(
        jnp.asarray(cfg.rtol), cfg.tol * jnp.maximum(scale, 1e-300), cfg.tol
    )

    _pin = (lambda v: constrain(v, lev0)) if constrain is not None \
        else (lambda v: v)
    u = _pin(u)
    if use_fmg:
        # FMG gives a discretization-accurate start (~1.5 cycles of work),
        # typically saving one-or-two outer refinements
        u = u + mg_mod.fmg(levels, f.astype(lo), cfg,
                           constrain=constrain).astype(jnp.float64)

    r0 = st_mod.residual(st_hi, u, f, unknown, sync0)
    rnorm0 = norms.scaled_l2(r0, hx, hy)
    hist = jnp.full((max_outer + 1,), jnp.nan, jnp.float64)
    hist = hist.at[0].set(rnorm0)

    def cond(carry):
        _, _, k, rnorm, _ = carry
        return (rnorm > tol_eff) & (k < max_outer)

    def body(carry):
        # the residual of the CURRENT iterate rides the carry: one fp64
        # residual per outer step, not two
        u, r, k, rnorm, hist = carry
        # low-precision correction solve: A e = r, e0 = 0
        e = jnp.zeros(lev0.grid.shape_padded, lo)
        r_lo = r.astype(lo)
        for _ in range(inner_cycles):
            e = mg_mod.mg_cycle(levels, e, r_lo, cfg, constrain)
        u = _pin(jnp.where(unknown, u + e.astype(jnp.float64), u))
        r = st_mod.residual(st_hi, u, f, unknown, sync0)
        rnorm = norms.scaled_l2(r, hx, hy)
        hist = hist.at[k + 1].set(rnorm)
        return (u, r, k + 1, rnorm, hist)

    u, _, k, rnorm, hist = jax.lax.while_loop(
        cond, body, (u, r0, jnp.asarray(0, jnp.int32), rnorm0, hist)
    )
    # single packed stats buffer -> single host readback (see multigrid.py)
    stats = jnp.stack([
        k.astype(jnp.float64), rnorm, rnorm0, fnorm,
        (rnorm <= tol_eff).astype(jnp.float64),
    ])
    return u, jnp.concatenate([stats, hist])


def ir_solve(
    levels,
    f,
    u0=None,
    cfg: MultigridConfig = MultigridConfig(),
    *,
    inner_cycles: int = 1,
    max_outer: int = 100,
    use_fmg: bool = False,
    constrain=None,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    """Solve A u = f to fp64 accuracy with low-precision multigrid cycles.

    ``levels`` is a low-precision hierarchy (fp32/bf16/mixed); the fine-level
    operator is re-materialized in float64 for the outer residual.
    ``use_fmg`` starts from a full-multigrid initial guess. ``constrain``
    threads per-level sharding constraints through the inner cycles AND the
    fp64 outer state (see parallel.distributed.make_constrainer).
    """
    lev0 = levels[0]
    if u0 is None:
        u0 = jnp.zeros(lev0.grid.shape_padded, jnp.float64)
    st_hi = lev0.stencil.astype(jnp.float64)
    u, packed = _ir_jit(levels, st_hi, f, u0, cfg, inner_cycles, max_outer,
                        use_fmg, constrain)
    out = mg_mod._unpack_info(np.asarray(packed))
    out["method"] = "iterative_refinement"
    return u, out


_STAGE_ORDER = [Precision.BF16, Precision.FP32, Precision.FP64]


def adaptive_solve(
    grid,
    spec,
    f,
    u0=None,
    *,
    a=None,
    lam=0.0,
    domain=None,
    policy: PrecisionPolicy = PrecisionPolicy(mode=Precision.ADAPTIVE),
    cfg: MultigridConfig = MultigridConfig(),
    start: Precision = Precision.FP32,
    chunk: int = 5,
    mesh=None,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    """Adaptive-precision solve: run cycle chunks, promote on policy triggers.

    Functional analogue of the reference's AdaptivePrecisionSolver
    (reference solvers/iterative.py:379-551): start low, promote when the
    policy detects stagnation or near-convergence, finish with iterative
    refinement if the final stage's epsilon cannot reach ``cfg.tol``.
    """
    constrain = None
    if mesh is not None:
        from ..parallel import distributed as dist_mod
        constrain = dist_mod.make_constrainer(mesh)
        sh = dist_mod._sharding_fn(mesh)(mesh, grid)
        f = jax.device_put(f, sh)
        if u0 is not None:
            u0 = jax.device_put(u0, sh)

    hierarchies: Dict[Precision, Any] = {}

    def get_levels(p: Precision):
        if p not in hierarchies:
            hierarchies[p] = mg_mod.build_hierarchy(
                grid, spec, a=a, lam=lam, domain=domain, dtype=p.dtype,
                cfg=cfg
            )
        return hierarchies[p]

    return _adaptive_core(
        f, u0, get_levels=get_levels, solve=mg_mod.mg_solve, ir=ir_solve,
        pad_shape=grid.shape_padded, policy=policy, cfg=cfg, start=start,
        chunk=chunk, constrain=constrain,
    )


def adaptive_solve3d(
    grid,
    spec,
    f,
    u0=None,
    *,
    a=None,
    lam=0.0,
    policy: PrecisionPolicy = PrecisionPolicy(mode=Precision.ADAPTIVE),
    cfg: MultigridConfig = MultigridConfig(),
    start: Precision = Precision.FP32,
    chunk: int = 5,
    mesh=None,
) -> Tuple[jnp.ndarray, Dict[str, Any]]:
    """3D adaptive-precision solve — same staged policy loop as
    :func:`adaptive_solve` over the 3D driver stack."""
    from . import multigrid3d as mg3

    constrain = None
    if mesh is not None:
        from ..parallel.distributed import make_constrainer3d
        from ..parallel.mesh import grid_sharding3d
        constrain = make_constrainer3d(mesh)
        sh = grid_sharding3d(mesh, grid)
        f = jax.device_put(f, sh)
        if u0 is not None:
            u0 = jax.device_put(u0, sh)

    hierarchies: Dict[Precision, Any] = {}

    def get_levels(p: Precision):
        if p not in hierarchies:
            hierarchies[p] = mg3.build_hierarchy3d(
                grid, spec, a=a, lam=lam, dtype=p.dtype, cfg=cfg
            )
        return hierarchies[p]

    def _ir3(levels, f, u0, cfg, *, max_outer, constrain):
        return mg3.ir_solve3d(levels, f, u0, cfg, max_outer=max_outer,
                              constrain=constrain)

    out = _adaptive_core(
        f, u0, get_levels=get_levels, solve=mg3.mg_solve3d, ir=_ir3,
        pad_shape=grid.shape_padded, policy=policy, cfg=cfg, start=start,
        chunk=chunk, constrain=constrain,
    )
    out[1]["method"] = "adaptive_3d"
    return out


def _adaptive_core(f, u0, *, get_levels, solve, ir, pad_shape, policy, cfg,
                   start, chunk, constrain):
    """The staged promotion loop shared by 2D and 3D adaptive solves."""
    stage_idx = _STAGE_ORDER.index(start)
    history: list = []
    switches: list = []
    # per-stage residual segments: a convergence factor over a mixed
    # bf16->fp32->IR history is not a meaningful rho (VERDICT.md weak #6),
    # so factors are reported per stage and the headline factor is the
    # final stage's.
    segments: list = []
    u = u0
    total_iters = 0

    while True:
        p = _STAGE_ORDER[stage_idx]
        eps = float(jnp.finfo(p.dtype).eps)
        # the working precision limits the reachable relative residual
        stage_tol = max(cfg.tol, 20.0 * eps)
        levels = get_levels(p)
        stage_cfg = cfg.replace(tol=stage_tol, max_iterations=chunk)
        u, info = solve(levels, f, u, stage_cfg, constrain=constrain)
        history.extend(info["history"][1:].tolist())
        segments.append((p.value, "cycle", info["history"]))
        total_iters += info["iterations"]

        rel = info["residual_norm"] / max(info["rhs_norm"], 1e-300)
        done = info["converged"] and stage_tol <= cfg.tol
        out_of_budget = total_iters >= cfg.max_iterations
        if done or out_of_budget:
            break

        promote = (
            info["converged"]  # hit the stage floor: need more precision
            or policy.should_promote(info["history"])
            or policy.should_upgrade(rel)
        )
        if promote:
            if stage_idx + 1 < len(_STAGE_ORDER):
                nxt = _STAGE_ORDER[stage_idx + 1]
                if nxt == Precision.FP64:
                    # finish with iterative refinement at the current
                    # (cheap) precision instead of full-fp64 cycles
                    switches.append((total_iters, "ir"))
                    u64 = (u if u is not None else
                           jnp.zeros(pad_shape, jnp.float64))
                    u, info = ir(
                        levels, f, u64, cfg,
                        max_outer=max(1, cfg.max_iterations - total_iters),
                        constrain=constrain,
                    )
                    history.extend(info["history"][1:].tolist())
                    segments.append(("ir", "ir_outer", info["history"]))
                    total_iters += info["iterations"]
                    break
                stage_idx += 1
                switches.append((total_iters, _STAGE_ORDER[stage_idx].value))

    hist = np.asarray([h for h in history if np.isfinite(h)])
    stage_factors = [
        {"stage": label, "rho_kind": kind,
         "factor": convergence_factor(seg_hist)}
        for label, kind, seg_hist in segments
    ]
    return u, {
        "iterations": total_iters,
        "residual_norm": float(hist[-1]) if hist.size else float("nan"),
        "rhs_norm": info["rhs_norm"],
        "history": hist,
        "converged": bool(info["converged"]),
        # headline factor = the FINAL stage's (a factor over the mixed
        # multi-stage history is not a meaningful rho); per-stage factors in
        # 'stage_factors'
        "convergence_factor": (stage_factors[-1]["factor"]
                               if stage_factors else float("nan")),
        "stage_factors": stage_factors,
        "precision_switches": switches,
        "method": "adaptive",
    }
