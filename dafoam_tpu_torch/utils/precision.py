"""Numeric floors for denominator guards, from ``torch.finfo``.

``guard_tiny(dtype)`` is the smallest normal of the dtype and ``sq_guard``
a floor whose square is still normal. CUDA float64 has the full float64
exponent range, so the port needs none of the reduced-range branch of
``dafoam_tpu.utils.precision``.
"""

from __future__ import annotations

import torch


def guard_tiny(dtype: torch.dtype) -> float:
    """Smallest safe denominator-guard magnitude for `dtype`: use in
    `where(|d| > tiny, d, 1)` / `clamp_min(x, tiny)` guards."""
    return float(torch.finfo(dtype).tiny)


def sq_guard(dtype: torch.dtype) -> float:
    """Floor whose SQUARE is still a normal number of `dtype`, for guards
    whose value is later divided by denom^2 (the snGrad limiter)."""
    return 1e-30 if torch.finfo(dtype).bits >= 64 else 1e-18
