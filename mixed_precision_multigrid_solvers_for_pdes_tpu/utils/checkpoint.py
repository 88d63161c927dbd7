"""Solver-state checkpoint/resume.

The reference has NO solver checkpointing (SURVEY.md section 5: persistence is
results-only). Long time-stepping runs on preemptible machines need it, so
this build adds a small npz-based checkpoint manager: atomic writes
(tmp + rename), monotonically numbered steps, keep-last-k retention, and a
metadata sidecar. Arrays are pulled to host once per save — callers control
the cadence, so the device pipeline is only fenced at checkpoint boundaries.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import jax
import numpy as np


class CheckpointManager:
    """Directory of numbered checkpoints: ``ckpt_{step:012d}.npz`` (+ meta)."""

    def __init__(self, directory, *, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # ---- paths ----------------------------------------------------------

    def _path(self, step: int) -> Path:
        return self.dir / f"ckpt_{step:012d}.npz"

    def all_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("ckpt_*.npz"):
            # Skip anything whose stem doesn't parse as ckpt_<int> (e.g. a
            # stray temp file from a crashed save) instead of breaking every
            # subsequent save/restore with a ValueError.
            tail = p.stem.split("_", 1)[1]
            if tail.isdigit():
                steps.append(int(tail))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---- save / restore ---------------------------------------------------

    def save(self, step: int, arrays: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> Path:
        """Atomic save of a pytree-of-arrays + JSON-able metadata."""
        host = {k: np.asarray(jax.device_get(v)) for k, v in arrays.items()}
        meta = dict(metadata or {})
        meta.setdefault("step", step)
        meta.setdefault("saved_at", time.time())
        path = self._path(step)
        # Dotfile temp name: never matches the ckpt_*.npz glob, so a crash
        # between write and rename can't poison all_steps(). np.savez appends
        # ".npz" to bare paths, so write through an explicit file handle.
        tmp = self.dir / f".ckpt_{step:012d}.npz.tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, **host, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8))
        os.replace(tmp, path)
        self._retain()
        return path

    def restore(self, step: Optional[int] = None):
        """Returns (arrays: dict[str, np.ndarray], metadata: dict)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(self._path(step)) as z:
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
            meta = json.loads(bytes(z["__meta__"]).decode()) \
                if "__meta__" in z.files else {}
        return arrays, meta

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            self._path(s).unlink(missing_ok=True)
