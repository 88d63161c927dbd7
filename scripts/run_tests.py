#!/usr/bin/env python
"""Run the test suite in per-module process batches.

On this session's host, single-process full-suite runs intermittently die
with a segfault deep inside XLA:CPU executable dispatch after ~130 heavy
jitted graphs have accumulated (crash sites vary run to run; every test
passes in smaller batches and individually, so it is an XLA/host issue, not
a library bug). Batching by directory keeps each process's compiled-program
count bounded and has been reliable.

By default the ~14 `slow`-marked ladder/robustness cases (~11 min of the
~40-min full run on the 1-core host) are deselected; pass ``--all`` to run
everything (do this at least once before a round ends).

Usage: python scripts/run_tests.py [--all] [extra pytest args...]
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BATCHES = [
    ["tests/unit/test_grid.py", "tests/unit/test_stencil.py",
     "tests/unit/test_transfer.py", "tests/unit/test_smoothers.py",
     "tests/unit/test_precision.py", "tests/unit/test_multigrid.py"],
    ["tests/unit/test_multigrid3d.py", "tests/unit/test_heat.py",
     "tests/unit/test_krylov.py", "tests/unit/test_periodic.py"],
    ["tests/unit/test_parallel.py", "tests/unit/test_tooling.py",
     "tests/unit/test_visualization.py", "tests/unit/test_reference3d.py",
     "tests/integration"],
]

# auto-append any test file not explicitly batched (new files must never be
# silently skipped)
_listed = {p for batch in BATCHES for p in batch}
_extra_batch = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "tests" / "unit").glob("test_*.py")
    if str(p.relative_to(ROOT)) not in _listed
)
if _extra_batch:
    BATCHES.append(_extra_batch)


def main() -> int:
    extra = sys.argv[1:]
    if "--all" in extra:
        extra = [a for a in extra if a != "--all"]
    else:
        extra = ["-m", "not slow", *extra]
    failed = False
    for batch in BATCHES:
        cmd = [sys.executable, "-m", "pytest", "-q", *batch, *extra]
        print("::", " ".join(cmd), flush=True)
        rc = subprocess.call(cmd, cwd=ROOT)
        if rc != 0:
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
