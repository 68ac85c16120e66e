"""Peaks of the chip and the work of the banded (DIA) products, counted
from the operator's shapes.

Bytes count each operand read once and each result written once: the
diagonal, the K bands, x (or the cotangent) and y (or x̄, d̄, c̄),
whatever a kernel reads again. Flops count one multiply and one add per
band entry and per diagonal entry applied. They count the same work
whatever implements the product.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W power limit
PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12,
         "fp64_flop_per_s": 34e12}


def work(name, n, k, c=1, diag_rows=1, itemsize=4, per_component=False):
    """(bytes, flops) of one call of ``name`` on n cells, k bands, c
    components, a diagonal of ``diag_rows`` rows (1 shared or c)."""
    if name in ("dia_matvec", "dia_matvec_t"):
        return (k + 3) * n * itemsize, 2 * (k + 1) * n
    if name in ("dia_matvec_multi", "dia_matvec_multi_t"):
        elems = diag_rows * n + k * n + 2 * c * n
        return elems * itemsize, 2 * (k + 1) * c * n
    if name == "dia_cotangent":
        # reads ct, x; writes d̄ (n) and c̄ (k, n)
        return (3 + k) * n * itemsize, (k + 1) * n
    if name == "dia_cotangent_multi":
        dbar = c * n if per_component else n
        elems = 2 * c * n + dbar + k * n
        flops = (k + 1) * c * n + (k + (0 if per_component else 1)) \
            * (c - 1) * n
        return elems * itemsize, flops
    raise KeyError(name)


def least_seconds(nbytes, flops, itemsize=4):
    peak = PEAKS["fp64_flop_per_s"] if itemsize == 8 \
        else PEAKS["fp32_flop_per_s"]
    return max(nbytes / PEAKS["hbm_bytes_per_s"], flops / peak)


def roofline_pct(calls, kernels):
    """Share, in %, of the least time of the traced launches in their
    device time. ``calls``: per kernel kind, the (bytes, flops, itemsize)
    of each call in launch order; ``kernels``: per kind, the device
    seconds of each launch in order. None when a kind's launches and
    calls do not pair up, or when nothing was traced."""
    least = spent = 0.0
    for kind, cs in calls.items():
        ks = kernels.get(kind, [])
        if len(ks) != len(cs):
            return None
        for (b, f, isz), t in zip(cs, ks):
            least += least_seconds(b, f, isz)
            spent += t
    if spent <= 0.0:
        return None
    return 100.0 * least / spent
