"""Smoke test of the solver on NVIDIA GPUs, through the user entry points.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the distributed phase only

One GPU:
  1. main — 2D Poisson, mixed precision (fp32/bf16 V(2,2) RB-GS cycles under
     fp64 iterative refinement, FMG start) through ``solve_poisson`` at
     1025^2, 2049^2 (relative residual 1e-9) and 4097^2 (1e-8); MMS error
     order 1025->2049 in [1.9, 2.1], 4097^2 error <= 1/3 of 2049^2; the
     257^2 iteration count against the same solve on the host CPU.
  2. other entry points — ``solve_poisson3d`` at 257^3, ``solve_heat`` at
     1025^2 (20 Crank-Nicolson steps), a Neumann ``solve_poisson`` at 1025^2.
  3. ``__graft_entry__.entry()``.
Four GPUs: 8193^2 mixed ``solve_poisson`` on a 2x2 mesh and ``halo_solve``
on the same mesh, each against the same solve on one card.

Exits non-zero, printing no result, when JAX's first device is not a GPU.
The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def card_info() -> str:
    """Name and power limit of the cards, from nvidia-smi (no JAX here)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


class Report:
    def __init__(self, card: str):
        self.card = card

    def __call__(self, msg: str) -> None:
        print(f"{msg} | {self.card}", flush=True)


def timed(fn):
    """(result, first-call seconds, warm seconds); both calls end with
    block_until_ready. The first call includes tracing and compilation."""
    import jax

    t = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t
    t = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, first, time.perf_counter() - t


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def _mixed_solve(n, tol, **kw):
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
        solve_poisson,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )

    prob = P.poisson_mms_sinsin(n)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=tol)
    return lambda: solve_poisson(prob, precision="mixed", cfg=cfg,
                                 use_fmg=True, **kw)


def _rel_residual(info) -> float:
    return info["residual_norm"] / max(info["rhs_norm"], 1e-300)


def phase_main(report, ladder=((1025, 1e-9), (2049, 1e-9), (4097, 1e-8)),
               count_n=257):
    """Main path through solve_poisson(precision='mixed', use_fmg=True)."""
    import jax

    errs = {}
    for n, tol in ladder:
        res, first, warm = timed(_mixed_solve(n, tol))
        rel = _rel_residual(res.info)
        errs[n] = res.errors["l2"]
        peak = jax.devices()[0].memory_stats() or {}
        report(f"main n={n}: iters={res.iterations} rel_residual={rel:.3e} "
               f"tol={tol:g} l2_err={errs[n]:.4e} first_call_s={first:.3f} "
               f"warm_s={warm:.4f} "
               f"peak_bytes={peak.get('peak_bytes_in_use', 'n/a')}")
        check(res.converged and rel <= tol, f"n={n} did not reach {tol}")
    n1, n2, n3 = (n for n, _ in ladder)
    order = math.log2(errs[n1] / errs[n2])
    report(f"main MMS order {n1}->{n2}: {order:.4f}; "
           f"err({n3})/err({n2}) = {errs[n3] / errs[n2]:.4f}")
    check(1.9 <= order <= 2.1, f"MMS order {order} outside [1.9, 2.1]")
    check(errs[n3] <= errs[n2] / 3, "finest error not below 1/3 of the next")

    gpu = _mixed_solve(count_n, 1e-9)()
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        cpu = _mixed_solve(count_n, 1e-9)()
    report(f"main n={count_n}: gpu iters={gpu.iterations} "
           f"cpu iters={cpu.iterations}")
    check(gpu.converged and cpu.converged, f"n={count_n} did not converge")
    check(abs(gpu.iterations - cpu.iterations) <= 1,
          "GPU and CPU iteration counts differ by more than 1")


def phase_other(report, n3d=257, n2d=1025):
    """3D, heat and Neumann entry points, once each."""
    import numpy as np

    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
        heat,
        heat_problems,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (
        solve_poisson,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson3d import (
        solve_poisson3d,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P,
        problems3d as P3,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )

    # 3D: discretization error of the sin^3 MMS is ~0.4 h^2
    prob3 = P3.poisson3d_mms_sinsinsin(n3d)
    cfg3 = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-8)
    res, first, warm = timed(lambda: solve_poisson3d(
        prob3, precision="mixed", cfg=cfg3))
    h2 = (1.0 / (n3d - 1)) ** 2
    report(f"poisson3d n={n3d}: iters={res.iterations} "
           f"rel_residual={_rel_residual(res.info):.3e} "
           f"l2_err={res.errors['l2']:.4e} first_call_s={first:.3f} "
           f"warm_s={warm:.4f}")
    check(res.converged and res.errors["l2"] <= h2,
          "3D solve did not converge to discretization accuracy")

    # heat: 20 Crank-Nicolson steps in the default fp32 state, whose
    # rounding floor (~eps32 * n relative; 5.0e-6 measured at 1025^2) sits
    # above the h^2 discretization error at this size
    hp = heat_problems.pure_diffusion(n2d)
    dt = 1e-4
    res, first, warm = timed(lambda: heat.solve_heat(
        hp, t_final=20 * dt, dt=dt, n_steps=20))
    err = res.errors["l2"]
    report(f"heat n={n2d}: steps={res.steps} t={res.t:.4g} l2_err={err:.4e} "
           f"first_call_s={first:.3f} warm_s={warm:.4f}")
    check(res.steps == 20 and np.isfinite(err) and err <= 1e-4,
          "heat run off the exact decay")

    # Neumann east side: reflect restriction; u = x^2 + y^2 is reproduced
    # exactly by the discretization
    pn = P.neumann_test_problem(n2d)
    cfgn = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9)
    res, first, warm = timed(lambda: solve_poisson(
        pn, precision="mixed", cfg=cfgn, use_fmg=True))
    report(f"neumann n={n2d}: iters={res.iterations} "
           f"rel_residual={_rel_residual(res.info):.3e} "
           f"l2_err={res.errors['l2']:.4e} first_call_s={first:.3f} "
           f"warm_s={warm:.4f}")
    check(res.converged and res.errors["l2"] <= 1e-6,
          "Neumann solve did not converge")


def phase_entry(report):
    import jax
    import numpy as np

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    step = jax.jit(fn)
    (u, rnorm), first, warm = timed(lambda: step(*args))
    report(f"entry: u{tuple(u.shape)} {u.dtype} rnorm={float(rnorm):.4e} "
           f"first_call_s={first:.3f} warm_s={warm:.6f}")
    check(u.shape == args[0].shape and bool(np.isfinite(float(rnorm))),
          "entry step output malformed")


def phase_four_cards(report, devices, n=8193, tol=1e-7):
    """Distributed solves on a 2x2 mesh against one card of the same host.

    ``tol``: the fp64 residual evaluation floor grows like h^-2 (about
    2.4e-8 relative at 8193^2), so 1e-7 is the tightest target reached.
    The halo_solve comparison runs fp64 levels: two fp32 solves that round
    differently drift apart by about eps32 * n (2.7e-5 max|u| at 1025^2
    after 6 cycles, measured on CPU devices): no bound of 1e-5 survives at
    8193^2."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu import parallel
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.parallel import (
        halo_solve as hs,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
        mg_solve,
    )

    mesh = parallel.make_mesh(devices, shape=(2, 2))
    one = devices[0]

    res4, first, warm = timed(_mixed_solve(n, tol, mesh=mesh))
    placed = len(res4.u.sharding.device_set)
    report(f"four n={n} mesh 2x2: iters={res4.iterations} "
           f"rel_residual={_rel_residual(res4.info):.3e} "
           f"l2_err={res4.errors['l2']:.6e} devices={placed} "
           f"first_call_s={first:.3f} warm_s={warm:.4f}")
    with jax.default_device(one):
        res1, first, warm = timed(_mixed_solve(n, tol))
    report(f"four n={n} one card: iters={res1.iterations} "
           f"rel_residual={_rel_residual(res1.info):.3e} "
           f"l2_err={res1.errors['l2']:.6e} first_call_s={first:.3f} "
           f"warm_s={warm:.4f}")
    check(placed == len(devices), "sharded solution not on every device")
    check(res4.converged and _rel_residual(res4.info) <= tol,
          "sharded solve did not reach its tolerance")
    check(res4.iterations == res1.iterations, "iteration counts differ")
    e4, e1 = res4.errors["l2"], res1.errors["l2"]
    check(abs(e4 - e1) <= 0.01 * e1, f"MMS errors differ: {e4} vs {e1}")

    # explicit halo path against mg_solve, fp64 levels
    prob = P.poisson_mms_sinsin(n)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0,
                          max_iterations=30, tol=tol)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float64",
                                cfg=cfg)
    f = prob.rhs(jnp.float64)
    (uh, ih), first, warm = timed(lambda: hs.halo_solve(mesh, levels, f,
                                                        cfg=cfg))
    placed = len(uh.sharding.device_set)
    report(f"four halo_solve n={n}: iters={ih['iterations']} "
           f"devices={placed} first_call_s={first:.3f} warm_s={warm:.4f}")
    with jax.default_device(one):
        (ur, ir), first, warm = timed(lambda: mg_solve(levels, f, cfg=cfg))
    du = float(jnp.max(jnp.abs(jax.device_put(uh, one) - ur)))
    umax = float(jnp.max(jnp.abs(ur)))
    report(f"four mg_solve n={n} one card: iters={ir['iterations']} "
           f"max|du|/max|u|={du / umax:.3e} first_call_s={first:.3f} "
           f"warm_s={warm:.4f}")
    check(ih["converged"] and ir["converged"], "halo comparison unconverged")
    check(ih["iterations"] == ir["iterations"], "halo iteration count")
    check(bool(np.isfinite(du)) and du <= 1e-5 * umax,
          f"halo_solve differs from mg_solve: {du} > 1e-5 * {umax}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on 4 GPUs")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    report = Report(card_info())
    print(f"card: {report.card}", flush=True)

    import mixed_precision_multigrid_solvers_for_pdes_tpu  # noqa: F401
    from mixed_precision_multigrid_solvers_for_pdes_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    print(f"compile cache: {enable_compile_cache(ROOT)}", flush=True)
    if args.four_cards:
        devices = jax.devices()
        if len(devices) < 4:
            print(f"chip_smoke: --four-cards needs 4 GPUs, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        phases = [("four_cards",
                   lambda: phase_four_cards(report, devices[:4]))]
    else:
        phases = [("main", lambda: phase_main(report)),
                  ("other", lambda: phase_other(report)),
                  ("entry", lambda: phase_entry(report))]
    for name, run in phases:
        t = time.perf_counter()
        run()
        report(f"phase {name} done in {time.perf_counter() - t:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
