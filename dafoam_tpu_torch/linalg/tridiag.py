"""Batched tridiagonal solves by parallel cyclic reduction (PCR).

Port of ``dafoam_tpu.linalg.tridiag``: ceil(log2(n)) rounds of full-width
shifts and elementwise multiply-adds, no sequential recursion. PCR is
stable for the (weakly) diagonally dominant FV operators after relax(),
and the division guards make degenerate rows (zero lines of the padded
dense-DIA layout) behave as identity rows. Plain torch.
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.utils.precision import guard_tiny


def _shift0(x, o, fill=0.0):
    """Shift along axis 0 by o with constant fill: out[i] = x[i+o]."""
    n = x.shape[0]
    if o == 0:
        return x
    if abs(o) >= n:
        return torch.full_like(x, fill)
    pad = torch.full((abs(o),) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    if o > 0:
        return torch.cat([x[o:], pad])
    return torch.cat([pad, x[:n + o]])


def _bcast(coef, like):
    """Broadcast a (n, batch...) coefficient against a RHS with extra
    trailing dims."""
    while coef.ndim < like.ndim:
        coef = coef[..., None]
    return coef


def _rank_normalize(a, b, c):
    nd = max(a.ndim, b.ndim, c.ndim)
    while a.ndim < nd:
        a = a[..., None]
    while b.ndim < nd:
        b = b[..., None]
    while c.ndim < nd:
        c = c[..., None]
    return a, b, c


def pcr_solve(a, b, c, d):
    """Solve the tridiagonal system along axis 0:

        a[i] x[i-1] + b[i] x[i] + c[i] x[i+1] = d[i]

    with a[0] == 0 and c[n-1] == 0 (rows where both couplings vanish are
    independent, so one pass solves a block-diagonal family of lines).
    a, b, c: (n, *batch); d: (n, *batch) or with extra trailing dims,
    broadcast. Returns x shaped like d.
    """
    a, b, c = _rank_normalize(a, b, c)
    n = a.shape[0]
    if n == 1:
        bb = _bcast(b, d)
        return d / torch.where(torch.abs(bb) > 0, bb, 1.0)
    steps = max(1, math.ceil(math.log2(n)))
    tiny = guard_tiny(b.dtype)

    def safe_div(x, y):
        return x / torch.where(torch.abs(y) > tiny, y, 1.0)

    for k in range(steps):
        s = 1 << k
        # out-of-range rows act as identity rows: b=1, a=c=d=0
        b_m, b_p = _shift0(b, -s, 1.0), _shift0(b, s, 1.0)
        a_m, c_p = _shift0(a, -s), _shift0(c, s)
        c_m, a_p = _shift0(c, -s), _shift0(a, s)
        d_m, d_p = _shift0(d, -s), _shift0(d, s)
        alpha = -safe_div(a, b_m)
        beta = -safe_div(c, b_p)
        a = alpha * a_m
        c = beta * c_p
        b = b + alpha * c_m + beta * a_p
        d = d + _bcast(alpha, d_m) * d_m + _bcast(beta, d_p) * d_p
    bb = _bcast(b, d)
    return d / torch.where(torch.abs(bb) > tiny, bb, 1.0)


def pcr_solve_periodic(a, b, c, d):
    """Cyclic tridiagonal solve along axis 0: row 0 also couples to row
    n-1 through a[0] and row n-1 to row 0 through c[n-1]. Sherman–Morrison
    on top of two PCR solves; lines that are not cyclic reduce exactly to
    ``pcr_solve``."""
    a, b, c = _rank_normalize(a, b, c)
    n = a.shape[0]
    if n == 1:
        bb = _bcast(b, d)
        return d / torch.where(torch.abs(bb) > 0, bb, 1.0)
    tiny = guard_tiny(b.dtype)
    alpha = a[0]          # corner (0, n-1)
    beta = c[-1]          # corner (n-1, 0)
    # gamma: any nonzero scale; -b[0] (guarded) for conditioning
    gamma = torch.where(torch.abs(b[0]) > tiny, -b[0], -1.0)
    b_mod = torch.cat([(b[0] - gamma)[None], b[1:-1],
                       (b[-1] - beta * alpha / gamma)[None]])
    a_in = torch.cat([torch.zeros_like(a[:1]), a[1:]])
    c_in = torch.cat([c[:-1], torch.zeros_like(c[-1:])])
    # u vector: gamma at row 0, beta at row n-1
    mid = torch.zeros_like(b[1:-1])
    u = torch.cat([torch.broadcast_to(gamma, b[0].shape)[None], mid,
                   torch.broadcast_to(beta, b[0].shape)[None]])
    y = pcr_solve(a_in, b_mod, c_in, d)
    q = pcr_solve(a_in, b_mod, c_in, u)
    # v^T x = x[0] + (alpha/gamma) x[n-1]
    ag = alpha / gamma
    vy = y[0] + _bcast(ag, y[-1]) * y[-1]
    vq = q[0] + ag * q[-1]
    denom = _bcast(1.0 + vq, vy)
    fac = vy / torch.where(torch.abs(denom) > tiny, denom, 1.0)
    qb = q if q.ndim == y.ndim else q[..., None]
    return y - qb * fac
