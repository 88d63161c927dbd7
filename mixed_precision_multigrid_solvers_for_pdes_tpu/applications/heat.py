"""Heat-equation time stepping: u_t = div(a grad u)*alpha + q.

Re-design of the reference's two heat solvers
(reference applications/heat_solver.py:34-792 and heat_equation.py:57-644):

- Every implicit step is a **shifted-operator multigrid solve**
  ``(A_sp + lam) u^{n+1} = F`` with ``A_sp = -div(a grad)`` and a
  scheme-dependent shift ``lam`` — the reference instead ran a fixed-point
  iteration around a full Poisson solve per step
  (reference heat_solver.py:308-459) or a pointwise damped relaxation
  (reference heat_equation.py:459-495). Here the shift is folded into the
  stencil diagonal (``c = w+e+s+n+lam``), so one-or-two V-cycles per step
  suffice (BASELINE.md target).
- The whole fixed-dt time loop runs under one ``lax.scan`` — zero host syncs
  per step. ``lam`` enters as a *traced scalar* added to a lam=0 base
  hierarchy, so adaptive-dt reuses the same compiled step.
- Schemes: explicit Euler (with the dt <= h^2/(4 alpha) stability guard,
  reference heat_equation.py:155-185), backward Euler, Crank-Nicolson,
  theta-method, BDF2 (reference heat_equation.py:26-31,187-266).
- Adaptive dt by step-doubling Richardson error control
  (reference heat_equation.py:268-330 semantics).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bc as bc_mod
from ..core.bc import BCKind, BoundarySpec
from ..core.grid import Grid
from ..ops import norms, stencil as st_mod
from ..solvers import multigrid as mg_mod
from ..solvers.multigrid import Level, MultigridConfig

SCHEMES = ("explicit", "backward_euler", "crank_nicolson", "theta", "bdf2")


@dataclasses.dataclass(frozen=True)
class HeatConfig:
    """Static time-stepping configuration (reference heat_equation.py:57-74)."""

    scheme: str = "crank_nicolson"
    theta: float = 0.5               # used by scheme="theta"
    cycles_per_step: int = 2         # minimum V-cycles per implicit solve
    # After cycles_per_step fixed cycles, keep cycling (device-side check)
    # while ||r|| > step_rtol * ||F||, up to max_cycles_per_step total. With
    # step_rtol=0 the count is exactly cycles_per_step — the "one V-cycle per
    # implicit step" fast path.
    step_rtol: float = 1e-9
    max_cycles_per_step: int = 12
    mg: MultigridConfig = MultigridConfig(smoother="rbgs", omega=1.0)
    dtype: Any = jnp.float32
    save_every: int = 0              # 0 = keep only the final state
    # adaptive dt (step-doubling Richardson, reference heat_equation.py:268-330)
    adaptive_dt: bool = False
    dt_tol: float = 1e-5
    dt_safety: float = 0.9
    dt_min: float = 1e-10
    dt_max: float = math.inf

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown scheme {self.scheme!r}; one of {SCHEMES}")
        if self.scheme == "theta" and not (0.0 < self.theta <= 1.0):
            raise ValueError("theta must be in (0, 1]")

    @property
    def effective_theta(self) -> float:
        return {"backward_euler": 1.0, "crank_nicolson": 0.5}.get(
            self.scheme, self.theta
        )

    @property
    def order(self) -> int:
        """Temporal accuracy order (for the Richardson exponent)."""
        if self.scheme in ("crank_nicolson", "bdf2"):
            return 2
        if self.scheme == "theta":
            return 2 if abs(self.theta - 0.5) < 1e-12 else 1
        return 1


@dataclasses.dataclass
class HeatProblem:
    """Heat problem data: initial condition + time-dependent source/BC data.

    Counterpart of reference applications/heat_solver.py:34 (HeatProblem) with
    the source/BC callables written in jnp so they trace into the scan body.
    """

    name: str
    grid: Grid
    alpha: float = 1.0
    spec: BoundarySpec = BoundarySpec()
    u0: Any = None                      # padded initial condition
    a: Any = None                       # padded coefficient field or None
    # q(X, Y, t) -> padded source array (jnp ops; t is traced). None = 0.
    q: Optional[Callable] = None
    # g(X, Y, t) -> padded array of Dirichlet values (jnp ops). None = 0.
    dirichlet: Optional[Callable] = None
    # Neumann/Robin side data: {side: g(t) scalar-or-array callable}
    bc_values: Optional[Dict[str, Callable]] = None
    # exact(X, Y, t) -> padded array, for MMS error measurement. None = unknown.
    exact: Optional[Callable] = None

    def mesh(self, dtype=jnp.float64) -> Tuple[jnp.ndarray, jnp.ndarray]:
        X, Y = self.grid.coordinates(padded=True)
        return jnp.asarray(X, dtype), jnp.asarray(Y, dtype)

    def initial_state(self, dtype) -> jnp.ndarray:
        g = self.grid
        if self.u0 is not None:
            u = jnp.asarray(self.u0, dtype)
        else:
            u = jnp.zeros(g.shape_padded, dtype)
        # install t=0 Dirichlet data on the ring
        if self.dirichlet is not None:
            X, Y = self.mesh(dtype)
            fixed = _fixed_mask(g, self.spec)
            u = jnp.where(fixed, self.dirichlet(X, Y, jnp.asarray(0.0, dtype)), u)
        return u

    def error_norms(self, u, t: float) -> Dict[str, float]:
        if self.exact is None:
            raise ValueError(f"problem {self.name!r} has no exact solution")
        g = self.grid
        X, Y = self.mesh()
        mask = bc_mod.logical_mask(g.nx, g.ny, g.shape_padded)
        ue = self.exact(X, Y, jnp.asarray(t, jnp.float64))
        diff = jnp.where(mask, u.astype(jnp.float64) - ue, 0.0)
        l2 = float(jnp.sqrt(g.hx * g.hy * jnp.sum(diff * diff)))
        return {"l2": l2, "linf": float(jnp.max(jnp.abs(diff)))}


@dataclasses.dataclass
class HeatResult:
    u: Any                              # final padded state
    t: float
    steps: int
    dt_history: np.ndarray              # per accepted step
    saved: Optional[List[Tuple[float, Any]]] = None
    errors: Optional[Dict[str, float]] = None


def _fixed_mask(grid: Grid, spec: BoundarySpec):
    return bc_mod.logical_mask(
        grid.nx, grid.ny, grid.shape_padded
    ) & ~bc_mod.unknown_mask(grid.nx, grid.ny, grid.shape_padded, spec)


def stability_limit_dt(grid: Grid, alpha: float, a_max: float = 1.0) -> float:
    """Explicit-Euler stability bound dt <= 1/(2 alpha a_max (1/hx^2 + 1/hy^2))
    (reference heat_equation.py:155-185 uses the hx=hy form h^2/(4 alpha))."""
    return 1.0 / (2.0 * alpha * a_max * (1.0 / grid.hx**2 + 1.0 / grid.hy**2))


def shift_hierarchy(levels: Tuple[Level, ...], lam) -> Tuple[Level, ...]:
    """Add a (possibly traced) scalar shift to every level's diagonal:
    (A_sp + lam). Valid because c = w+e+s+n at lam=0 by construction."""
    import dataclasses as _dc

    out = []
    for lev in levels:
        st = lev.stencil
        lam_t = jnp.asarray(lam, lev.dtype)
        out.append(
            Level(
                # works for Stencil and Stencil9; on Galerkin coarse levels
                # c+lam approximates RAP(A+lam I) (exact on the fine level,
                # where the residual is evaluated)
                stencil=_dc.replace(st, c=st.c + lam_t),
                grid=lev.grid,
                spec=lev.spec,
                dtype=lev.dtype,
                domain=lev.domain,
            )
        )
    return tuple(out)


# --------------------------------------------------------------------------
# single steps (pure, traced; lam/dt are dynamic scalars)
# --------------------------------------------------------------------------

def _source(problem: HeatProblem, X, Y, t, dtype):
    if problem.q is None:
        return jnp.zeros(X.shape, dtype)
    return problem.q(X, Y, t).astype(dtype)


def _bc_correction(problem: HeatProblem, grid, spec, t, dtype):
    """Neumann/Robin ghost-elimination RHS term at time t (for A_sp)."""
    if not problem.bc_values:
        return jnp.zeros(grid.shape_padded, dtype)
    vals = {side: fn(t) for side, fn in problem.bc_values.items()}
    return st_mod.bc_rhs_correction(grid, spec, vals, dtype)


def _install_dirichlet(problem: HeatProblem, u, X, Y, t):
    if problem.dirichlet is None:
        return u
    fixed = _fixed_mask(problem.grid, problem.spec)
    return jnp.where(fixed, problem.dirichlet(X, Y, t).astype(u.dtype), u)


def make_step_fn(
    problem: HeatProblem,
    levels0: Tuple[Level, ...],
    cfg: HeatConfig,
    constrain=None,
):
    """Build step(u_prev, u, t, dt) -> u_next for the configured scheme.

    ``levels0`` is the lam=0 hierarchy of A_sp = -div(a grad). ``u_prev`` is
    the n-1 state (used by BDF2 only; pass ``u`` for single-step schemes).
    All of (t, dt) are traced, so one compilation serves every step size.
    ``constrain`` optionally maps (array, Level) -> array to inject per-level
    sharding constraints (see parallel.distributed.make_constrainer) — with it
    the whole time loop runs SPMD over a device mesh, halo collectives
    inserted by XLA inside each V-cycle.
    """
    grid, spec, alpha = problem.grid, problem.spec, problem.alpha
    dtype = jnp.dtype(cfg.dtype)
    lev0 = levels0[0]
    unknown = lev0.unknown
    X, Y = problem.mesh(dtype)
    st_sp = lev0.stencil  # fine-level spatial stencil (lam=0)
    sync0 = lev0.sync

    if constrain is not None:
        _pin = lambda v: constrain(v, lev0)  # noqa: E731  pin scan-carry layout
    else:
        _pin = lambda v: v                   # noqa: E731

    def apply_sp(u):
        """A_sp u minus the BC-elimination correction (the true operator)."""
        if sync0 is not None:
            u = sync0(u)
        return st_mod.apply(st_sp, u)

    def cycles(levels, u, f):
        """cycles_per_step fixed cycles + tolerance-driven extras.

        The fixed-count path alone leaves an algebraic error floor of
        ~rho^cycles * ||step increment||, which pollutes temporal-order
        measurements; the while_loop tail removes it without host syncs."""
        for _ in range(cfg.cycles_per_step):
            u = mg_mod.mg_cycle(levels, u, f, cfg.mg, constrain=constrain)
        extra = cfg.max_cycles_per_step - cfg.cycles_per_step
        if cfg.step_rtol <= 0.0 or extra <= 0:
            return u
        l0 = levels[0]
        unk = l0.unknown
        fnorm = norms.masked_scaled_l2(f, unk, grid.hx, grid.hy)
        tol_eff = cfg.step_rtol * jnp.maximum(fnorm, 1e-300)

        def rnorm_of(u):
            return norms.scaled_l2(
                st_mod.residual(l0.stencil, u, f, unk), grid.hx, grid.hy)

        def cond(c):
            u, k, rn = c
            return (rn > tol_eff) & (k < extra)

        def body(c):
            u, k, _ = c
            u = mg_mod.mg_cycle(levels, u, f, cfg.mg, constrain=constrain)
            return (u, k + 1, rnorm_of(u))

        u, _, _ = jax.lax.while_loop(
            cond, body, (u, jnp.asarray(0, jnp.int32), rnorm_of(u)))
        return u

    if cfg.scheme == "explicit":

        def step(u_prev, u, t, dt):
            tn1 = t + dt
            cbc = _bc_correction(problem, grid, spec, t, dtype)
            lap = -(apply_sp(u) - cbc)            # div(a grad u) at t
            rhs = (alpha * lap + _source(problem, X, Y, t, dtype)).astype(dtype)
            u_new = jnp.where(unknown, u + dt.astype(dtype) * rhs, u)
            return _pin(_install_dirichlet(problem, u_new, X, Y, tn1))

        return step

    if cfg.scheme == "bdf2":
        # Variable-step BDF2 with ratio r = dt/dt_prev (u_prev sits dt_prev
        # back; reference heat_equation.py:187-266 only had the uniform r=1
        # form):
        #   [(1+2r)/((1+r)dt)] u^{n+1} - [(1+r)/dt] u^n + [r^2/((1+r)dt)]
        #     u^{n-1} = alpha(-A_sp u^{n+1}) + q^{n+1}
        # r=1 reduces to the classic (3, -4, 1)/(2dt) coefficients (the
        # fixed-dt scan path passes dt_prev=None).
        def step(u_prev, u, t, dt, dt_prev=None):
            tn1 = t + dt
            dt_ = dt.astype(dtype)
            if dt_prev is None:
                r = jnp.ones((), dtype)
            else:
                r = (dt / dt_prev).astype(dtype)
            lam = (1.0 + 2.0 * r) / ((1.0 + r) * alpha * dt_)
            levels = shift_hierarchy(levels0, lam)
            cbc1 = _bc_correction(problem, grid, spec, tn1, dtype)
            F = (
                ((1.0 + r) * u - (r * r / (1.0 + r)) * u_prev)
                / (alpha * dt_)
                + _source(problem, X, Y, tn1, dtype) / alpha
                + cbc1
            )
            F = jnp.where(unknown, F, jnp.zeros((), dtype))
            u_new = _install_dirichlet(problem, u, X, Y, tn1)
            return _pin(cycles(levels, u_new, F))

        return step

    th = cfg.effective_theta
    # theta-method: [A_sp + 1/(alpha theta dt)] u^{n+1}
    #   = u^n/(alpha theta dt) - (1-theta)/theta * A_sp u^n
    #     + [theta q^{n+1} + (1-theta) q^n]/(alpha theta) + c_bc^{n+1}
    #     - (1-theta)/theta * (-c_bc^n)
    def step(u_prev, u, t, dt):
        tn1 = t + dt
        dt_ = dt.astype(dtype)
        lam = 1.0 / (alpha * th * dt_)
        levels = shift_hierarchy(levels0, lam)
        qn = _source(problem, X, Y, t, dtype)
        qn1 = _source(problem, X, Y, tn1, dtype)
        cbc0 = _bc_correction(problem, grid, spec, t, dtype)
        cbc1 = _bc_correction(problem, grid, spec, tn1, dtype)
        F = u * lam + (th * qn1 + (1.0 - th) * qn) / (alpha * th) + cbc1
        if th < 1.0:
            F = F - (1.0 - th) / th * (apply_sp(u) - cbc0)
        F = jnp.where(unknown, F, jnp.zeros((), dtype))
        u_new = _install_dirichlet(problem, u, X, Y, tn1)
        return _pin(cycles(levels, u_new, F))

    return step


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("step", "n_steps", "save_every"))
def _run_scan(step, u_prev0, u0, t0, dt, n_steps: int, save_every: int):
    def body(carry, k):
        u_prev, u, t = carry
        u_new = step(u_prev, u, t, dt)
        out = u_new if save_every else None
        return (u, u_new, t + dt), out

    (u_prev, u, t), saved = jax.lax.scan(
        body, (u_prev0, u0, t0), jnp.arange(n_steps), unroll=1
    )
    if save_every:
        saved = saved[save_every - 1 :: save_every]
    return u_prev, u, t, saved


def _bootstrap_bdf2(problem, levels0, cfg, u0, t0, dt, constrain=None):
    """First BDF2 step via one Crank-Nicolson step (standard bootstrap)."""
    cn = dataclasses.replace(cfg, scheme="crank_nicolson")
    step_cn = make_step_fn(problem, levels0, cn, constrain=constrain)
    u1 = step_cn(u0, u0, t0, dt)
    return u1


def solve_heat(
    problem: HeatProblem,
    t_final: float,
    dt: Optional[float] = None,
    cfg: HeatConfig = HeatConfig(),
    *,
    n_steps: Optional[int] = None,
    mesh=None,
    checkpoint=None,
    checkpoint_every: int = 0,
) -> HeatResult:
    """Integrate the heat problem to ``t_final``.

    Fixed-dt path: the whole loop is one jitted ``lax.scan``. Adaptive path:
    host-driven accept/reject loop around the same compiled step
    (step-doubling Richardson, reference heat_equation.py:268-330).

    With ``mesh`` (a jax.sharding.Mesh from parallel.mesh.make_mesh) the
    entire run is SPMD over the device mesh: every level of every per-step
    V-cycle carries a block-partition sharding constraint and the scan carry
    stays sharded — the distributed analog the reference never had for time
    stepping (its multi-GPU path was steady-state only,
    reference gpu/multi_gpu_solver.py:244).

    With ``checkpoint`` (a utils.checkpoint.CheckpointManager) the fixed-dt
    scan runs in chunks of ``checkpoint_every`` steps, saving (u_prev, u, t)
    at each chunk boundary; a run pointed at a non-empty directory resumes
    from its latest checkpoint (the reference persisted results only —
    SURVEY.md section 5). checkpoint_every=0 saves once at the end."""
    dtype = jnp.dtype(cfg.dtype)
    grid = problem.grid
    # cache (hierarchy, step) per config on the problem: a fresh step closure
    # per call would re-trigger _run_scan's static-arg compilation every call
    cache = problem.__dict__.setdefault("_solver_cache", {})
    key = (cfg.mg, cfg.scheme, cfg.theta, cfg.cycles_per_step, cfg.step_rtol,
           cfg.max_cycles_per_step, dtype.name,
           None if mesh is None else (mesh.shape_tuple, mesh.axis_names))
    if key in cache:
        levels0, step, constrain = cache[key]
    else:
        levels0 = mg_mod.build_hierarchy(
            grid, problem.spec, a=problem.a, lam=0.0, dtype=dtype, cfg=cfg.mg
        )
        constrain = None
        if mesh is not None:
            from ..parallel import distributed as dist_mod
            constrain = dist_mod.make_constrainer(mesh)
        step = make_step_fn(problem, levels0, cfg, constrain=constrain)
        cache[key] = (levels0, step, constrain)
    u0 = problem.initial_state(dtype)
    if mesh is not None:
        from ..parallel import distributed as dist_mod
        u0 = dist_mod.shard_inputs(mesh, levels0, u0)

    if cfg.scheme == "explicit":
        limit = stability_limit_dt(
            grid, problem.alpha,
            a_max=float(np.max(problem.a)) if problem.a is not None else 1.0,
        )
        if dt is not None and dt > limit * (1 + 1e-12):
            raise ValueError(
                f"explicit dt={dt:g} exceeds stability limit {limit:g} "
                "(reference heat_equation.py:155-185 warns; we refuse)"
            )
        if dt is None:
            dt = 0.9 * limit

    if cfg.adaptive_dt:
        return _solve_adaptive(problem, levels0, cfg, step, u0, t_final,
                               dt or t_final / 100.0, constrain=constrain)

    if dt is None and n_steps is None:
        raise ValueError("provide dt or n_steps")
    if n_steps is None:
        n_steps = max(1, int(round(t_final / dt)))
    dt = t_final / n_steps  # land exactly on t_final

    t0 = jnp.asarray(0.0, jnp.float64)
    dt_t = jnp.asarray(dt, jnp.float64)
    u_prev0 = u0
    start = 0
    resumed = False
    if checkpoint is not None and checkpoint.latest_step() is not None:
        arrays, meta = checkpoint.restore()
        if abs(meta.get("dt", dt) - dt) > 1e-12 * max(abs(dt), 1.0):
            raise ValueError(
                f"checkpoint dt={meta.get('dt')} != requested dt={dt}; "
                "resume requires the same step size")
        if meta.get("scheme", cfg.scheme) != cfg.scheme:
            raise ValueError(
                f"checkpoint scheme={meta.get('scheme')!r} != requested "
                f"scheme={cfg.scheme!r}; resuming would continue from "
                "incompatible time-integration history")
        u_prev0 = jnp.asarray(arrays["u_prev"], dtype)
        u0 = jnp.asarray(arrays["u"], dtype)
        if mesh is not None:
            from ..parallel import distributed as dist_mod
            u_prev0, u0 = dist_mod.shard_inputs(mesh, levels0, u_prev0, u0)
        start = int(meta["k"])
        t0 = jnp.asarray(meta["t"], jnp.float64)
        resumed = True
    if cfg.scheme == "bdf2" and n_steps >= 1 and not resumed:
        u1 = _bootstrap_bdf2(problem, levels0, cfg, u0, t0, dt_t,
                             constrain=constrain)
        u_prev0, u0 = u0, u1
        t0 = t0 + dt_t
        start = 1
    saved_list = None
    if checkpoint is not None:
        return _solve_checkpointed(
            problem, cfg, step, u_prev0, u0, t0, dt_t, n_steps, start, dt,
            checkpoint, checkpoint_every,
        )
    if start < n_steps:
        _, u, t, saved = _run_scan(
            step, u_prev0, u0, t0, dt_t, n_steps - start, cfg.save_every
        )
        if cfg.save_every:
            ks = np.arange(start, n_steps)[cfg.save_every - 1 :: cfg.save_every]
            saved_list = [(float((k + 1) * dt), np.asarray(s))
                          for k, s in zip(ks, saved)]
    else:
        u, t = u0, t0

    result = HeatResult(
        u=u, t=float(t), steps=n_steps,
        dt_history=np.full(n_steps, dt), saved=saved_list,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, float(t))
    return result


def _solve_checkpointed(problem, cfg, step, u_prev0, u0, t0, dt_t,
                        n_steps, start, dt, checkpoint, checkpoint_every):
    """Chunked scan with checkpoint saves at chunk boundaries."""
    every = checkpoint_every if checkpoint_every > 0 else n_steps
    if cfg.save_every and every % cfg.save_every:
        raise ValueError(
            "checkpoint_every must be a multiple of save_every (snapshot "
            "phase would drift across chunk boundaries otherwise)")
    u_prev, u, t = u_prev0, u0, t0
    k = start
    saved_list: list = []
    while k < n_steps:
        m = min(every, n_steps - k)
        u_prev, u, t, saved = _run_scan(
            step, u_prev, u, t, dt_t, m, cfg.save_every)
        if cfg.save_every:
            ks = np.arange(k, k + m)[cfg.save_every - 1 :: cfg.save_every]
            saved_list += [(float((kk + 1) * dt), np.asarray(sv))
                           for kk, sv in zip(ks, saved)]
        k += m
        checkpoint.save(
            k, {"u_prev": u_prev, "u": u},
            {"t": float(t), "k": k, "dt": dt, "scheme": cfg.scheme},
        )
    result = HeatResult(
        u=u, t=float(t), steps=n_steps,
        dt_history=np.full(n_steps, dt), saved=saved_list or None,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, float(t))
    return result


def _solve_adaptive(problem, levels0, cfg, step, u0, t_final, dt0,
                    constrain=None):
    """Step-doubling: accept when |u_dt - u_{dt/2,x2}| / (2^p - 1) < dt_tol.

    BDF2 runs with variable-step coefficients (r = dt/dt_prev) and is
    bootstrapped by an error-controlled Crank-Nicolson first step (both order
    2, so one Richardson exponent serves the whole run). After an accepted
    step the kept history is (half-step state, two-half-steps state), so the
    next step's dt_prev is dt/2."""
    p = cfg.order
    denom = 2.0**p - 1.0
    is_bdf2 = cfg.scheme == "bdf2"
    t, u, u_prev = 0.0, u0, u0
    dt = float(dt0)
    dt_prev = 0.0  # spacing of (u_prev, u); 0 until a bdf2 history exists
    dts: list = []
    saved: list = []
    nsteps = 0

    if is_bdf2:
        step_cn = make_step_fn(
            problem, levels0,
            dataclasses.replace(cfg, scheme="crank_nicolson"),
            constrain=constrain,
        )

    @jax.jit
    def try_step(u_prev, u, t, dt):
        big = step(u_prev, u, t, dt)
        half = step(u_prev, u, t, 0.5 * dt)
        two = step(u, half, t + 0.5 * dt, 0.5 * dt)
        err = jnp.max(jnp.abs(big - two)) / denom
        # keep the more accurate two-half-steps state (+ its half history)
        return half, two, err

    @jax.jit
    def try_step_boot(u, t, dt):
        """One-step CN trial (bdf2 bootstrap: no valid u_prev yet)."""
        big = step_cn(u, u, t, dt)
        half = step_cn(u, u, t, 0.5 * dt)
        two = step_cn(half, half, t + 0.5 * dt, 0.5 * dt)
        err = jnp.max(jnp.abs(big - two)) / 3.0  # CN is order 2
        return half, two, err

    @jax.jit
    def try_step_bdf(u_prev, u, t, dt, dt_prev):
        big = step(u_prev, u, t, dt, dt_prev)
        half = step(u_prev, u, t, 0.5 * dt, dt_prev)
        two = step(u, half, t + 0.5 * dt, 0.5 * dt, 0.5 * dt)
        err = jnp.max(jnp.abs(big - two)) / denom
        return half, two, err

    while t < t_final - 1e-14:
        dt = min(dt, t_final - t, cfg.dt_max)
        t_t = jnp.asarray(t, jnp.float64)
        dt_t = jnp.asarray(dt, jnp.float64)
        if not is_bdf2:
            half, u_new, err = try_step(u_prev, u, t_t, dt_t)
        elif nsteps == 0:
            half, u_new, err = try_step_boot(u, t_t, dt_t)
        else:
            half, u_new, err = try_step_bdf(
                u_prev, u, t_t, dt_t, jnp.asarray(dt_prev, jnp.float64)
            )
        err = float(err)
        if err <= cfg.dt_tol or dt <= cfg.dt_min * (1 + 1e-12):
            u_prev, u = (half, u_new) if is_bdf2 else (u, u_new)
            dt_prev = 0.5 * dt
            t += dt
            nsteps += 1
            dts.append(dt)
            if cfg.save_every and nsteps % cfg.save_every == 0:
                saved.append((t, np.asarray(u)))
        # PI-free classic controller
        factor = cfg.dt_safety * (cfg.dt_tol / max(err, 1e-300)) ** (1.0 / (p + 1))
        dt = float(np.clip(dt * np.clip(factor, 0.2, 5.0), cfg.dt_min, cfg.dt_max))

    result = HeatResult(
        u=u, t=t, steps=nsteps, dt_history=np.asarray(dts),
        saved=saved or None,
    )
    if problem.exact is not None:
        result.errors = problem.error_norms(u, t)
    return result


# --------------------------------------------------------------------------
# problem factory
# --------------------------------------------------------------------------

def heat_problem_from_callables(
    name: str,
    grid: Grid,
    *,
    alpha: float = 1.0,
    spec: BoundarySpec = BoundarySpec(),
    u0: Optional[Callable] = None,
    exact: Optional[Callable] = None,
    q: Optional[Callable] = None,
    a: Optional[Callable] = None,
    bc_values: Optional[Dict[str, Callable]] = None,
) -> HeatProblem:
    """Assemble a HeatProblem. ``u0``/``a`` take (X, Y) numpy meshes;
    ``exact``/``q`` take (X, Y, t) and must use jnp ops (they trace)."""
    X, Y = grid.coordinates(padded=True)
    from ..models.problems import eval_padded

    u0_arr = eval_padded(grid, u0) if u0 is not None else (
        np.asarray(exact(jnp.asarray(X), jnp.asarray(Y), 0.0))
        if exact is not None else None
    )
    if u0_arr is not None:
        u0_arr = np.array(u0_arr)
        u0_arr[grid.nx:, :] = 0.0
        u0_arr[:, grid.ny:] = 0.0
    dirichlet = None
    if exact is not None and any(
        BCKind.DIRICHLET in spec.side(s).kinds for s in bc_mod.SIDES
    ):
        dirichlet = exact
    return HeatProblem(
        name=name, grid=grid, alpha=alpha, spec=spec,
        u0=u0_arr,
        a=eval_padded(grid, a) if a is not None else None,
        q=q, dirichlet=dirichlet, bc_values=bc_values, exact=exact,
    )
