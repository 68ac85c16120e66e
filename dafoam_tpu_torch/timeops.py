"""Temporal reduction of function values for unsteady runs (port of
``dafoam_tpu.timeops``).

The reference's DATimeOp family (src/adjoint/DATimeOp/; DATimeOp.H:80-86
compute/dFScaling): the per-step history of a function value, a (T,)
tensor, reduces to one scalar. ``dFScaling``, the per-step weight that
seeds the reverse time sweep (mphys_dafoam.py:1565-1585), is the gradient
of these reductions: ``dfscaling`` takes it by ``torch.autograd.grad``.
"""

from __future__ import annotations

import torch


def time_op(values: torch.Tensor, mode: str = "final", cfg: dict | None = None):
    """values: (T,) per-time-step function values -> 0-d tensor.

    mode: final | average | max (the reference's registered types).
    cfg["timeOpFracStart"]: where the averaging window starts, as a
    fraction of the steps; cfg["timeOpMaxMode"] "KS" (the default) with
    cfg["coeffKS"]: the Kreisselmeier-Steinhauser soft max, else the
    plain max.
    """
    cfg = cfg or {}
    T = values.shape[0]
    if mode == "final":
        return values[-1]
    if mode == "average":
        frac = cfg.get("timeOpFracStart", 0.5)
        n0 = int(round(frac * (T - 1)))
        w = (torch.arange(T, device=values.device) >= n0).to(values.dtype)
        return torch.sum(values * w) / max(float(w.sum()), 1.0)
    if mode == "max":
        if cfg.get("timeOpMaxMode", "KS") == "KS":
            rho = cfg.get("coeffKS", 20.0)
            m = torch.max(values)
            return m + torch.log(torch.sum(torch.exp(rho * (values - m)))) \
                / rho
        return torch.max(values)
    raise NotImplementedError(f"timeOp {mode!r}")


def dfscaling(values: torch.Tensor, mode: str = "final",
              cfg: dict | None = None) -> torch.Tensor:
    """d time_op / d values, (T,): the reverse sweep's per-step weights."""
    v = values.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(time_op(v, mode, cfg), v)
    return g
