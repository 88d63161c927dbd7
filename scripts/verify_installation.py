#!/usr/bin/env python
"""Installation self-check: a minute of real solves, PASS/FAIL per row.

Counterpart of the reference's scripts/verify_installation.py (455 LoC of
import checks); this one actually solves problems. Runs on whatever backend
jax picks (the GPU if present); pass --cpu to force the CPU backend with an
8-device virtual mesh so the sharding row runs anywhere.

Usage: python scripts/verify_installation.py [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

_pre = argparse.ArgumentParser(add_help=False)
_pre.add_argument("--cpu", action="store_true")
_args, _ = _pre.parse_known_args()
if _args.cpu:
    import os

    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def row(name, fn):
    t0 = time.perf_counter()
    try:
        fn()
        print(f"PASS  {name:44s} {time.perf_counter() - t0:6.1f}s", flush=True)
        return True
    except Exception as e:  # noqa: BLE001 — report, don't crash the battery
        msg = str(e).split(chr(10))[0][:100]
        print(f"FAIL  {name:44s} {msg}", flush=True)
        return False


def main():
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (
        HeatConfig,
        solve_heat,
        solve_poisson,
        solve_poisson3d,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.heat_problems import (
        pure_diffusion,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import (
        problems as P,
        problems3d as P3,
    )

    print(f"# backend: {jax.default_backend()}  devices: {len(jax.devices())}")
    cfg = mg.MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-10)
    ok = True

    def poisson2d():
        res = solve_poisson(P.poisson_mms_sinsin(129), precision="fp64",
                            cfg=cfg)
        assert res.converged and res.errors["l2"] < 5e-5, res.errors

    def mixed_ir():
        res = solve_poisson(P.poisson_mms_sinsin(129), precision="mixed",
                            cfg=cfg)
        assert res.converged, res.info
        rel = res.info["residual_norm"] / max(res.info["rhs_norm"], 1e-300)
        assert rel < 1e-9, rel

    def poisson3d():
        res = solve_poisson3d(P3.poisson3d_mms_sinsinsin(33),
                              precision="fp64", cfg=cfg)
        assert res.converged and res.errors["l2"] < 2e-3, res.errors

    def heat():
        r = solve_heat(pure_diffusion(65), t_final=0.01, dt=1e-3,
                       cfg=HeatConfig(scheme="crank_nicolson",
                                      dtype="float64"))
        assert r.errors["l2"] < 1e-3, r.errors

    def sharded():
        if len(jax.devices()) < 2:
            raise RuntimeError("needs >=2 devices (run with --cpu for a "
                               "virtual 8-device mesh)")
        from mixed_precision_multigrid_solvers_for_pdes_tpu import parallel

        mesh = parallel.make_mesh(jax.devices()[: min(8, len(jax.devices()))])
        prob = P.poisson_mms_sinsin(129)
        r1 = solve_poisson(prob, precision="fp64", cfg=cfg)
        r2 = solve_poisson(prob, precision="fp64", cfg=cfg, mesh=mesh)
        np.testing.assert_allclose(np.asarray(r2.u), np.asarray(r1.u),
                                   rtol=0, atol=1e-12)

    ok &= row("2D Poisson fp64 (129^2, O(h^2))", poisson2d)
    ok &= row("mixed precision IR to 1e-9 relative", mixed_ir)
    ok &= row("3D Poisson fp64 (33^3)", poisson3d)
    ok &= row("heat CN integration (65^2)", heat)
    ok &= row("sharded solve bit-matches single device", sharded)
    print("installation OK" if ok else "installation FAILED")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
