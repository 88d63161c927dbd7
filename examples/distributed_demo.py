#!/usr/bin/env python
"""Distributed + fault-tolerant run demo.

Walks through the production deployment pattern on one host:

1. build a device mesh (all visible devices),
2. steady solve SPMD over the mesh in every precision mode,
3. time stepping with the whole scan sharded AND checkpointed in chunks,
4. kill-and-resume: a second `solve_heat` pointed at the same checkpoint
   directory continues bit-exactly.

On CPU, launch with
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/distributed_demo.py
to emulate an 8-device mesh; on a multi-GPU host it uses the cards as-is.
Multi-host runs additionally call parallel.multihost.initialize() first
(see that module's docstring).
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

from mixed_precision_multigrid_solvers_for_pdes_tpu import parallel  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications import (  # noqa: E402
    HeatConfig,
    heat_problems,
    solve_heat,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.applications.poisson import (  # noqa: E402
    solve_poisson,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.models import problems as P  # noqa: E402
from mixed_precision_multigrid_solvers_for_pdes_tpu.solvers.multigrid import (  # noqa: E402
    MultigridConfig,
)
from mixed_precision_multigrid_solvers_for_pdes_tpu.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
)


def main():
    mesh = parallel.make_mesh(jax.devices())
    print(f"mesh: {dict(zip(mesh.axis_names, mesh.devices.shape))} "
          f"on {jax.devices()[0].platform}")

    # -- steady solves, sharded, every precision mode -----------------------
    cfg = MultigridConfig(smoother="rbgs", omega=1.0, tol=1e-8)
    for precision in ("fp64", "mixed", "adaptive"):
        res = solve_poisson(P.poisson_mms_sinsin(257), precision=precision,
                            cfg=cfg, mesh=mesh)
        print(f"poisson 257^2 {precision:8s}: {res.iterations} iters, "
              f"l2err={res.errors['l2']:.2e}, "
              f"sharded over {len(res.u.sharding.device_set)} device(s)")

    # -- sharded + checkpointed time stepping -------------------------------
    hcfg = HeatConfig(scheme="bdf2", cycles_per_step=2, dtype="float64")
    with tempfile.TemporaryDirectory() as d:
        ck = CheckpointManager(Path(d) / "ck", keep_last=2)
        # phase 1: "preempted" after 40 of 100 steps
        solve_heat(heat_problems.pure_diffusion(129), t_final=0.004,
                   n_steps=40, cfg=hcfg, mesh=mesh,
                   checkpoint=ck, checkpoint_every=20)
        print(f"preempted at step {ck.latest_step()} "
              f"(checkpoints: {ck.all_steps()})")
        # phase 2: resume to the full horizon
        res = solve_heat(heat_problems.pure_diffusion(129), t_final=0.01,
                         n_steps=100, cfg=hcfg, mesh=mesh,
                         checkpoint=ck, checkpoint_every=20)
        print(f"resumed -> t={res.t:g} in {res.steps} total steps, "
              f"errors={res.errors}")


if __name__ == "__main__":
    main()
