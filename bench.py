"""Headline benchmark: 1025^2 Poisson to 1e-9 relative residual on one GPU.

Mixed-precision solve (fp32 RB-GS V(2,2) cycles + fp64-accumulated residuals
via iterative refinement, FMG start) — the configuration the reference
benchmarks as "GPU mixed precision 1025^2" (reference docs/results.md:271,
286-292: 8.76 s fp32 / 11.23 s mixed on an A100, final accuracy 2.7e-9).

Protocol: K independent solves (distinct right-hand sides, each a full
iterative-refinement solve from a zero guess) run inside ONE jitted program
via lax.scan, and the time per solve is wall/K. One program for K solves
amortises the host's dispatch and readback over the batch. The reported time
is the median over repeats, each ended by block_until_ready.

Note on tolerance: at 1025^2 the float64 evaluation floor of the residual is
~4e-10 relative (eps64 * ||A|| * ||u|| / ||f||); 1e-9 is the tightest target
reachable without compensated accumulation.

Fails (no fallback) unless JAX's first device is a GPU. Prints ONE JSON line
naming the device kind, the card's name and power limit, and DoF/s.

Usage: python bench.py [n] [batch_k]   (defaults: 1025 16)
"""

import json
import os
import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from chip_smoke import card_info

ROOT = os.path.dirname(os.path.abspath(__file__))


def measure(n: int = 1025, K: int = 16) -> dict:
    """Run the batched protocol on the default device: compile and check K
    solves, then time 5 fresh batches. Returns per-solve seconds (median),
    the first call's seconds (compilation included) and the DoF count."""
    import mixed_precision_multigrid_solvers_for_pdes_tpu as mg
    from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (
        MultigridConfig,
    )
    from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.refinement import (
        _ir_jit,
    )

    prob = P.poisson_mms_sinsin(n)
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-9,
                          max_iterations=40)
    levels = mg.build_hierarchy(prob.grid, prob.spec, dtype="float32", cfg=cfg)
    u0 = prob.initial_guess(jnp.float64)
    st_hi = levels[0].stencil.astype(jnp.float64)

    @partial(jax.jit, static_argnames=("cfg",))
    def batch_solve(levels, st_hi, fs, u0, cfg):
        def body(carry, fk):
            u, packed = _ir_jit(levels, st_hi, fk, u0, cfg,
                                inner_cycles=2, max_outer=100, use_fmg=True)
            # stats layout (refinement._ir_jit): [iters, rnorm, rnorm0,
            # fnorm, converged, hist...]
            return carry, packed[:5]
        _, stats = jax.lax.scan(body, 0, fs)
        return stats

    # frequency-swept MMS batch: every solve is a genuinely different system
    # -lap u_i = f_i with u_i = a_i sin(kx_i pi x) sin(ky_i pi y) — distinct
    # spectral content per solve, not scalar multiples of one RHS.
    g = prob.grid
    px, py = g.shape_padded
    X, Y = np.meshgrid(np.arange(n) * g.hx, np.arange(n) * g.hy,
                       indexing="ij")
    FREQS = [(1, 1), (2, 1), (1, 3), (3, 2), (2, 5), (5, 1), (4, 3), (1, 7)]

    def make_batch(r):
        fs = np.zeros((K, px, py), np.float64)
        for i in range(K):
            kx, ky = FREQS[i % len(FREQS)]
            amp = 1.0 + (i + r * K) / (K * 8.0)
            fs[i, :n, :n] = (amp * (kx**2 + ky**2) * np.pi**2
                             * np.sin(kx * np.pi * X)
                             * np.sin(ky * np.pi * Y))
        return jnp.asarray(fs)

    def check(stats):
        stats = np.asarray(stats)
        if stats.shape != (K, 5) or not np.all(stats[:, 4] == 1.0):
            raise RuntimeError(f"bench.py: solves did not converge: {stats}")

    t0 = time.perf_counter()
    check(batch_solve(levels, st_hi, make_batch(0), u0, cfg))
    first_call_s = time.perf_counter() - t0

    per_solve = []
    for r in range(1, 6):
        fs = jax.block_until_ready(make_batch(r))
        t0 = time.perf_counter()
        stats = batch_solve(levels, st_hi, fs, u0, cfg)
        jax.block_until_ready(stats)
        per_solve.append((time.perf_counter() - t0) / K)
        check(stats)
    return {"seconds_per_solve": float(np.median(per_solve)),
            "first_call_s": first_call_s, "dofs": (n - 2) ** 2}


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: needs a GPU, JAX found {dev.platform!r}")
    card = card_info()

    from mixed_precision_multigrid_solvers_for_pdes_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache(ROOT)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1025
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    res = measure(n, K)
    print(json.dumps({
        "metric": f"poisson_{n}sq_mixed_precision_solve_DoF_per_s",
        "value": res["dofs"] / res["seconds_per_solve"],
        "unit": "DoF/s",
        "seconds_per_solve": res["seconds_per_solve"],
        "first_call_s": res["first_call_s"],
        "batch": K,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
