"""Matrix-free Krylov solvers for the primal's segregated equations.

Port of ``dafoam_tpu.linalg.krylov.cg`` and ``.bicgstab``. The JAX versions
run inside ``lax.while_loop``; here the loop is Python and reads the
residual norm on the host once per iteration (one device->host sync).
The exit rules are the JAX ones exactly:

- cg:        iterate while it < max_iters and ||r|| > tol
- bicgstab:  iterate while it < max_iters and ||r|| finite and > tol

with tol = max(rel_tol * ||r0||, abs_tol). Scalars that only feed device
arithmetic (alpha, beta, rho, omega and the breakdown test) stay on the
device, so the branches of the JAX ``lax.cond``s become ``torch.where``.

The remaining solvers of the JAX module (the fixed-step ``*_steps`` scans
and ``gmres``) arrive with the adjoint slice.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from dafoam_tpu_torch.utils.precision import guard_tiny


class SolveInfo(NamedTuple):
    iters: int
    resid0: float
    resid: float
    converged: bool


def tdot(a, b):
    return torch.sum(a * b)


def tnorm(a):
    return torch.sqrt(tdot(a, a))


def _identity(x):
    return x


def _guard(v, tiny):
    """v where |v| > tiny, else tiny (sign-preserving breakdown guard)."""
    return torch.where(torch.abs(v) > tiny, v, tiny)


# ---------------------------------------------------------------------------
# Conjugate Gradient (SPD systems: pressure Poisson)
# ---------------------------------------------------------------------------

def cg(matvec: Callable, b, x0=None, precond: Callable | None = None,
       rel_tol=1e-6, abs_tol=1e-50, max_iters=500):
    precond = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    p = z
    rz = tdot(r, z)
    r0 = tnorm(r).item()
    tol = max(rel_tol * r0, abs_tol)
    tp = guard_tiny(b.dtype)

    it = 0
    rn = r0
    while it < max_iters and rn > tol:
        ap = matvec(p)
        # sign-preserving guards: the pressure laplacian is symmetric
        # NEGATIVE definite (OpenFOAM convention) and CG is invariant under
        # simultaneous negation — as long as we never clamp signs away
        pap = tdot(p, ap)
        alpha = rz / _guard(pap, tp)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = tdot(r, z)
        beta = rz_new / _guard(rz, tp)
        p = beta * p + z
        rz = rz_new
        it += 1
        rn = tnorm(r).item()
    return x, SolveInfo(it, r0, rn, rn <= tol)


# ---------------------------------------------------------------------------
# BiCGStab (non-symmetric: momentum / turbulence transport)
# ---------------------------------------------------------------------------

def bicgstab(matvec: Callable, b, x0=None, precond: Callable | None = None,
             rel_tol=1e-6, abs_tol=1e-50, max_iters=200):
    """Preconditioned BiCGStab with breakdown restarts and best-so-far
    tracking. On breakdown (rhat nearly orthogonal to r) the method
    restarts from the current residual; a non-finite trial iterate is
    rejected in favour of the best finite one and forces a restart."""
    precond = precond or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    r0n = tnorm(r).item()
    tol = max(rel_tol * r0n, abs_tol)
    tb = guard_tiny(b.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one
    bx, brn = x, r0n
    it = 0
    fresh = True
    rn = r0n

    while it < max_iters and math.isfinite(rn) and rn > tol:
        rho_new = tdot(rhat, r)
        rn2 = tdot(r, r)
        # serious breakdown: rhat nearly orthogonal to r -> restart
        breakdown = torch.abs(rho_new) < 1e-12 * torch.clamp_min(rn2, tb)
        restart = torch.ones_like(breakdown) if fresh else breakdown
        rhat = torch.where(restart, r, rhat)
        rho_new = torch.where(restart, rn2, rho_new)
        beta = torch.where(
            restart, 0.0,
            (rho_new / _guard(rho, tb)) * (alpha / _guard(omega, tb)))
        p = torch.where(restart, r, r + beta * (p - omega * v))
        phat = precond(p)
        v = matvec(phat)
        rv = tdot(rhat, v)
        alpha = rho_new / _guard(rv, tb)
        s_vec = r - alpha * v
        shat = precond(s_vec)
        t = matvec(shat)
        tt = tdot(t, t)
        omega = tdot(t, s_vec) / torch.where(tt > tb, tt, tb)
        x_new = x + alpha * phat + omega * shat
        r_new = s_vec - omega * t
        rn_new = tnorm(r_new).item()
        rho = rho_new
        it += 1
        finite = math.isfinite(rn_new)
        if finite:
            x, r, rn = x_new, r_new, rn_new
            if rn_new < brn:
                bx, brn = x_new, rn_new
        else:
            # reject the non-finite trial state: fall back to best-so-far
            # and force a fresh restart next iteration
            x = bx
            r = b - matvec(bx)
            rn = tnorm(r).item()
        fresh = not finite

    if not math.isfinite(rn) or brn < rn:
        x = bx
    rn = min(rn, brn)
    return x, SolveInfo(it, r0n, rn, rn <= tol)
