"""Mixed-precision policy.

Functional counterpart of the reference's ``PrecisionManager``
(reference core/precision.py:18) and ``GPUPrecisionManager``
(reference gpu/gpu_precision.py:28). Key translation:

- CUDA fp16 tensor-core tiers -> bf16 storage.
- fp64 -> float64, used sparingly (norms, final refinement).
- The reference flips dtypes *inside* the iteration loop; under jit dtypes are
  static, so adaptive precision here is a **host-driven stage loop**: each
  stage runs a jitted solve segment at fixed per-level dtypes, and promotion
  decisions between stages replicate PrecisionManager's semantics
  (residual thresholds, stagnation/plateau detection,
  reference core/precision.py:155-268).
- Tight tolerances at low precision come from **iterative refinement**
  (fp64 outer residual, low-precision inner correction solve), replacing the
  reference's mixed_precision_residual_kernel idea
  (reference gpu/cuda_kernels.py:843-883) at the algorithm level.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np


class Precision(enum.Enum):
    """Named precision tiers (reference core/precision.py:11 + gpu fp16 tier)."""

    BF16 = "bf16"
    FP32 = "fp32"
    FP64 = "fp64"
    MIXED = "mixed"        # fp32 fine levels, bf16 coarse levels
    ADAPTIVE = "adaptive"  # staged promotion bf16/fp32 -> fp32/fp64

    @property
    def dtype(self):
        return {
            Precision.BF16: jnp.bfloat16,
            Precision.FP32: jnp.float32,
            Precision.FP64: jnp.float64,
        }.get(self, jnp.float32)


_DTYPES = {
    "bf16": jnp.bfloat16,
    "bfloat16": jnp.bfloat16,
    "fp32": jnp.float32,
    "float32": jnp.float32,
    "single": jnp.float32,
    "fp64": jnp.float64,
    "float64": jnp.float64,
    "double": jnp.float64,
}


def as_dtype(p) -> jnp.dtype:
    if isinstance(p, Precision):
        return p.dtype
    if isinstance(p, str):
        return _DTYPES[p.lower()]
    return jnp.dtype(p)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Per-level dtype policy + adaptive-stage thresholds (static/hashable).

    ``mode`` semantics:
      fp64 / fp32 / bf16 — uniform hierarchy dtype.
      mixed             — fine half of the hierarchy at ``fine``, coarse half
                          at ``coarse`` (reference core/precision.py:337-357
                          halves the hierarchy the same way).
      adaptive          — handled by solvers.adaptive: stages of increasing
                          precision driven by the promotion logic below.
    """

    mode: Precision = Precision.FP32
    fine: Precision = Precision.FP32
    coarse: Precision = Precision.BF16
    # residual-threshold switching (reference core/precision.py:155-187,248-268)
    downgrade_factor: float = 100.0
    upgrade_factor: float = 10.0
    convergence_threshold: float = 1e-6
    # stagnation promotion (reference core/precision.py:189-246)
    stagnation_window: int = 5
    stagnation_ratio: float = 0.9
    plateau_rel_change: float = 1e-3

    def level_dtypes(self, num_levels: int) -> Tuple[jnp.dtype, ...]:
        """dtype for each level, 0 = finest."""
        if self.mode in (Precision.FP64, Precision.FP32, Precision.BF16):
            return (self.mode.dtype,) * num_levels
        if self.mode == Precision.MIXED:
            half = max(1, num_levels // 2)
            return tuple(
                self.fine.dtype if lvl < half else self.coarse.dtype
                for lvl in range(num_levels)
            )
        # ADAPTIVE hierarchies start at the lowest stage; solvers.adaptive
        # rebuilds them per stage.
        return (self.fine.dtype,) * num_levels

    # ---- host-side adaptive decisions (stage boundaries) -----------------

    def should_promote(self, history: Sequence[float]) -> bool:
        """Promote precision on stagnation/plateau/instability.

        Mirrors reference core/precision.py:189-246: mean of the last
        ``stagnation_window`` residual ratios above ``stagnation_ratio``
        (stagnation), relative change below ``plateau_rel_change`` (plateau),
        or monotone increase over the window (instability).
        """
        w = self.stagnation_window
        h = np.asarray(history, dtype=np.float64)
        if h.size < w + 1:
            return False
        recent = h[-(w + 1):]
        ratios = recent[1:] / np.maximum(recent[:-1], 1e-300)
        if np.mean(ratios) > self.stagnation_ratio:
            return True
        rel_change = abs(recent[-1] - recent[0]) / max(recent[0], 1e-300)
        if rel_change < self.plateau_rel_change:
            return True
        if np.all(np.diff(recent) > 0):
            return True
        return False

    def should_upgrade(self, residual_norm: float) -> bool:
        """Near convergence, move to higher precision
        (reference core/precision.py:248-268)."""
        return residual_norm < self.upgrade_factor * self.convergence_threshold

    def should_downgrade(self, residual_norm: float) -> bool:
        """Far from convergence, lower precision is safe
        (reference core/precision.py:155-187)."""
        return residual_norm > self.downgrade_factor * self.convergence_threshold


def policy(mode="fp32", **kwargs) -> PrecisionPolicy:
    """Convenience constructor: policy('mixed'), policy('fp64'), ..."""
    if isinstance(mode, str):
        mode = Precision(mode)
    return PrecisionPolicy(mode=mode, **kwargs)
