#!/usr/bin/env python
"""Run the performance benchmark battery and write honest reports.

Counterpart of the reference's run_benchmarks.py — minus its simulated
fallback (reference run_benchmarks.py:42-56 synthesized results with
np.random). Includes the reference's headline scenarios:
- sizes x precisions solver benchmark (DoF/s, speedups vs fp64, O(N) check)
- heat stepping throughput: implicit steps at a fixed cycle budget
  (BASELINE.md config 4: 1025^2, one-or-two V-cycles per step)
- external baselines (scipy / pyamg) on the same discrete systems

Usage: python scripts/run_benchmarks.py [--quick] [--out reports/]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mixed_precision_multigrid_solvers_for_pdes_tpu as mg  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    HeatConfig,
    heat_problems,
    solve_heat,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.benchmarking import (  # noqa: E402
    BenchmarkSuite,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.benchmarking.suite import (  # noqa: E402
    system_info,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig,
)


def heat_stepping_bench(n: int, n_steps: int) -> dict:
    """Implicit heat stepping at a fixed cycle budget, whole run in one scan
    (BASELINE.md: 'one V-cycle per implicit step')."""
    prob = heat_problems.pure_diffusion(n)
    cfg = HeatConfig(
        scheme="crank_nicolson", cycles_per_step=1, step_rtol=0.0,
        dtype="float32", mg=MultigridConfig(smoother="rbgs", omega=1.0),
    )
    dt = 0.1 / n_steps
    res = solve_heat(prob, t_final=0.1, dt=dt, cfg=cfg)  # compile + warm
    t0 = time.perf_counter()
    res = solve_heat(prob, t_final=0.1, dt=dt, cfg=cfg)
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0
    return {
        "n": n,
        "steps": n_steps,
        "wall_s": wall,
        "steps_per_s": n_steps / wall,
        "dof_steps_per_s": (n - 2) ** 2 * n_steps / wall,
        "final_l2_error": res.errors["l2"] if res.errors else None,
    }


def poisson3d_bench(n: int, runs: int = 3) -> dict:
    """3D solve bench (capability the reference stubbed,
    reference applications/poisson_solver.py:483).

    <= 257^3: mixed precision (fp32 cycles + f64-outer iterative refinement,
    tol 1e-9). 513^3: pure fp32 to 3.6e-3 relative residual — the floor set by
    storing u in fp32 (r(u_fp32) ~ A(eps32 u) ~ 3.5e-3 relative, measured);
    the SOLUTION still reaches the ~4e-6 discretization-level L2 error.
    Whether the f64-outer IR path fits one card at this size is not
    measured; sharding over cards is the answer for both memory and
    accuracy at 513^3+ (BASELINE config 5)."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems3d as P3
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid3d import (
        build_hierarchy3d,
        ir_solve3d,
        mg_solve3d,
    )

    prob = P3.poisson3d_mms_sinsinsin(n)
    big = n >= 513
    cfg = MultigridConfig(smoother="rbgs", omega=1.0,
                          tol=3.6e-3 if big else 1e-9)
    levels = build_hierarchy3d(prob.grid, dtype="float32", cfg=cfg)
    if big:
        f = prob.rhs(jnp.float32)

        def solve():
            return mg_solve3d(levels, f, None, cfg)
    else:
        f = prob.rhs(jnp.float64)

        def solve():
            return ir_solve3d(levels, f, None, cfg)

    u, info = solve()  # compile + converge check
    wall = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        u, info = solve()
        wall = min(wall, time.perf_counter() - t0)
    return {
        "n": n,
        "precision": "fp32" if big else "mixed_ir",
        "wall_s": wall,
        "dof_per_s": (n - 2) ** 3 / wall,
        "iterations": info["iterations"],
        "converged": info["converged"],
        "error_l2": prob.error_norms(u)["l2"],
    }


def precond_bench(sizes=(257, 513), ilu_max_n: int = 257,
                  tol: float = 1e-8, runs: int = 3) -> list:
    """CG-preconditioner A/B on the hard problem classes (VERDICT r4
    next-round #7): host-path ILU(0)/ILU(1) vs the device-side substitutes
    (Chebyshev, MG-PC). Iteration counts are hardware-neutral; walls are
    measured where each preconditioner actually runs (ILU triangular solves
    are inherently sequential -> host CG via solvers.krylov.pcg_host;
    Chebyshev/MG-PC trace into the jitted PCG on the accelerator). ILU rows
    stop at ``ilu_max_n``: the Python/NumPy wavefront setup alone scales
    O(N) with large constants and is already minutes at 1025^2 — that IS the
    supersession argument, recorded rather than hidden."""
    from mixed_precision_multigrid_solvers_for_pdes_tpu import (
        preconditioning as pc,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers import krylov

    import numpy as np

    rows = []
    # per-class smoother for the MG preconditioner, as in run_validation:
    # 100:1 anisotropy needs line smoothing (ADI); jumps are fine with RB-GS
    cfgs = {
        "jump_coefficient": MultigridConfig(smoother="rbgs", omega=1.0,
                                            symmetric=True),
        "anisotropic": MultigridConfig(smoother="adi", omega=1.0),
    }
    for key in ("jump_coefficient", "anisotropic"):
        cfg = cfgs[key]
        for n in sizes:
            prob = P.CATALOGUE[key](n)
            levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                        lam=prob.lam, dtype="float64",
                                        cfg=cfg)
            lev0 = levels[0]
            # seeded generic RHS, NOT the MMS one: sinsin-family RHS is a
            # discrete-operator eigenvector and collapses CG to 1 iteration
            # (the round-4 degenerate-baseline lesson)
            rng = np.random.default_rng(0)
            b = jnp.where(lev0.unknown,
                          jnp.asarray(rng.standard_normal(
                              lev0.grid.shape_padded)),
                          jnp.zeros((), jnp.float64))
            mv = krylov.stencil_matvec(lev0.stencil, lev0.unknown)
            cases = {
                "none": None,
                "chebyshev4": pc.chebyshev(lev0.stencil, lev0.unknown,
                                           degree=4, grid=lev0.grid),
                "mg_pc": pc.multigrid_preconditioner(levels, cfg),
            }
            for name, M in cases.items():
                x, info = krylov.pcg(mv, b, precond=M, tol=tol,
                                     maxiter=2000)  # compile + converge
                wall = float("inf")
                for _ in range(runs):
                    t0 = time.perf_counter()
                    x, info = krylov.pcg(mv, b, precond=M, tol=tol,
                                         maxiter=2000)
                    jax.block_until_ready(x)
                    wall = min(wall, time.perf_counter() - t0)
                rows.append({
                    "problem": key, "n": n, "preconditioner": name,
                    "where": "device", "iterations": info["iterations"],
                    "converged": info["converged"], "wall_s": wall,
                    "setup_s": 0.0,
                })
            if n <= ilu_max_n:
                b_np = np.asarray(b)
                mv_np = krylov.stencil_matvec_np(lev0.stencil, lev0.unknown)
                for name, ctor in (
                    ("ilu0", lambda: pc.ILUPreconditioner(
                        lev0.grid, lev0.stencil, lev0.unknown)),
                    ("iluk1", lambda: pc.ILUKPreconditioner(
                        lev0.grid, lev0.stencil, lev0.unknown,
                        fill_level=1)),
                ):
                    t0 = time.perf_counter()
                    M = ctor()
                    setup_s = time.perf_counter() - t0
                    wall = float("inf")
                    for _ in range(max(1, runs - 1)):
                        t0 = time.perf_counter()
                        x, info = krylov.pcg_host(mv_np, b_np, precond=M,
                                                  tol=tol, maxiter=2000)
                        wall = min(wall, time.perf_counter() - t0)
                    rows.append({
                        "problem": key, "n": n, "preconditioner": name,
                        "where": "host", "iterations": info["iterations"],
                        "converged": info["converged"], "wall_s": wall,
                        "setup_s": setup_s,
                    })
    return rows


def galerkin_bench(n: int, runs: int = 3) -> list:
    """Jump-coefficient (1e3:1) robustness: rediscretize+W vs Galerkin RAP
    (ops/galerkin.py). The reference's number for this class (rho 0.142) was
    simulated (reference benchmarks/validation_suite.py:256-300); both rows
    here are measured fp64 solves to 1e-8 relative."""
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg

    prob = P.jump_coefficient_problem(n)
    f = prob.rhs(jnp.float64)
    rows = []
    for co, cyc in (("rediscretize", "W"), ("galerkin", "V"),
                    ("galerkin", "W")):
        cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-8,
                              coarsening=co, cycle=cyc)
        t0 = time.perf_counter()
        levels = mg.build_hierarchy(prob.grid, prob.spec, a=prob.a,
                                    dtype="float64", cfg=cfg)
        jax.block_until_ready([lev.stencil for lev in levels])
        setup_s = time.perf_counter() - t0
        u, info = mg.mg_solve(levels, f, None, cfg)  # compile + check
        wall = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            u, info = mg.mg_solve(levels, f, None, cfg)
            wall = min(wall, time.perf_counter() - t0)
        rows.append({
            "n": n,
            "coarsening": co,
            "cycle": cyc,
            "setup_s": setup_s,
            "wall_s": wall,
            "iterations": info["iterations"],
            "converged": info["converged"],
            "rho_cycle": info["convergence_factor"],
        })
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="reports")
    ap.add_argument("--baselines", action="store_true",
                    help="also run scipy/pyamg external baselines (CPU)")
    ap.add_argument("--xl", action="store_true",
                    help="add the 4097^2 row")
    ap.add_argument("--heat-steps", type=int, default=1000,
                    help="implicit steps for the 1025^2 heat row "
                         "(BASELINE config 4 is 1000)")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # 2049^2 is the reference's headline scaling size
    # (reference docs/results.md:271-272,358-384)
    sizes = (129, 257) if args.quick else (129, 257, 513, 1025, 2049)
    if args.xl:
        sizes = sizes + (4097,)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-8)

    suite = BenchmarkSuite(P.poisson_mms_sinsin, cfg)
    suite.run(sizes=sizes, precisions=("fp32", "fp64", "mixed"),
              runs=3 if args.quick else 5)
    report = suite.report()

    heat = [heat_stepping_bench(129 if args.quick else 513,
                                50 if args.quick else 200)]
    if not args.quick:
        # BASELINE config 4 at full scale: 1025^2 x 1000 implicit steps
        # (reference docs/results.md:116-123,487: 8.3 MG iters/step; ours
        # runs ONE V(2,2) cycle per step at a fixed budget)
        heat.append(heat_stepping_bench(1025, args.heat_steps))
    report["heat_stepping"] = heat

    if args.quick:
        report["poisson3d"] = [poisson3d_bench(65)]
    else:
        # BASELINE config 5 ladder: 257^3 standard + 513^3 stretch
        report["poisson3d"] = [poisson3d_bench(257), poisson3d_bench(513)]

    report["galerkin_jump"] = galerkin_bench(257 if args.quick else 1025)

    report["preconditioners"] = precond_bench(
        sizes=(129,) if args.quick else (257, 513, 1025),
        ilu_max_n=129 if args.quick else 257)

    if args.baselines:
        from mixed_precision_multigrid_solvers_for_pdes_tpu.validation import (
            PerformanceBaselines,
        )

        pb = PerformanceBaselines(cfg)
        # exponential MMS, NOT sinsin: sin(kx pi x) sin(ky pi y) is an exact
        # eigenvector of the discrete Laplacian, so unpreconditioned CG
        # "converges" in one iteration on it — a degenerate Krylov baseline
        # (caught in round 4 when scipy_cg reported 1 iter / 0.1 ms)
        pb.run_suite(P.poisson_mms_exponential,
                     sizes=(65, 129) if args.quick else (65, 129, 257, 513))
        report["external_baselines"] = pb.report()

    (out / "benchmark_report.json").write_text(
        json.dumps(report, indent=2, default=float))
    md = [suite.report_markdown()]
    md += ["", "## Heat stepping (implicit, fixed "
          "cycle budget)", "",
          "| n | steps | wall (s) | steps/s | final L2 err |", "|---|---|---|---|---|"]
    for h in heat:
        md.append(f"| {h['n']} | {h['steps']} | {h['wall_s']:.3f} | "
                  f"{h['steps_per_s']:.1f} | {h['final_l2_error']:.2e} |")
    md += ["", "## 3D Poisson (the reference's 3D solvers were stubs)", "",
           "| n^3 | precision | wall (s) | MDoF/s | iters | l2 error |",
           "|---|---|---|---|---|---|"]
    for r in report["poisson3d"]:
        md.append(f"| {r['n']} | {r['precision']} | {r['wall_s']:.3f} | "
                  f"{r['dof_per_s'] / 1e6:.1f} | {r['iterations']} | "
                  f"{r['error_l2']:.2e} |")
    md += ["", "## Jump coefficient 1e3:1 — coarsening robustness "
           "(reference simulated rho 0.142; these are measured)", "",
           "| n | coarsening | cycle | setup (s) | solve (s) | iters | "
           "rho/cycle |", "|---|---|---|---|---|---|---|"]
    for r in report["galerkin_jump"]:
        md.append(f"| {r['n']} | {r['coarsening']} | {r['cycle']} | "
                  f"{r['setup_s']:.3f} | {r['wall_s']:.3f} | "
                  f"{r['iterations']} | {r['rho_cycle']:.4f} |")
    md += ["", "## CG preconditioners (ILU host path vs device-side "
           "substitutes; reference preconditioning/ilu.py)", "",
           "| problem | n | preconditioner | where | iters | setup (s) | "
           "solve (s) |", "|---|---|---|---|---|---|---|"]
    for r in report["preconditioners"]:
        md.append(f"| {r['problem']} | {r['n']} | {r['preconditioner']} | "
                  f"{r['where']} | {r['iterations']} | {r['setup_s']:.3f} | "
                  f"{r['wall_s']:.3f} |")
    if "external_baselines" in report:
        md += ["", "## External baselines (same discrete systems; "
               "reference validation/performance_baselines.py:61)", "",
               "| solver | n | wall (s) | iters | l2 error | available |",
               "|---|---|---|---|---|---|"]
        for r in report["external_baselines"]["rows"]:
            err = (f"{r['error_l2']:.2e}" if r.get("error_l2") is not None
                   else "-")
            wall = "-" if r["wall_s"] != r["wall_s"] else f"{r['wall_s']:.4f}"
            md.append(f"| {r['solver']} | {r['n']} | {wall} | "
                      f"{r['iterations']} | {err} | {r['available']} |")
    (out / "benchmark_report.md").write_text("\n".join(md))

    print(json.dumps({
        "system": system_info()["device"],
        "speedups_vs_fp64": report["precision_speedups"],
        "scaling_exponents": report["scaling_exponents"],
        "heat_steps_per_s": [h["steps_per_s"] for h in heat],
    }, default=float))


if __name__ == "__main__":
    main()
