"""Matrix-free Krylov solvers and fixed-step smoothers.

Port of ``dafoam_tpu.linalg.krylov``: ``cg`` and ``bicgstab`` (the primal's
inner solves), ``jacobi_steps`` and ``chebyshev_steps`` (the linear-in-
defect smoothers of the fixed-point adjoint's step map), ``cg_steps`` and
``bicgstab_steps`` (its "krylov" smoother: fixed step counts, no host
read) and ``gmres`` (the adjoint's restarted, optionally deflated FGMRES).
The JAX versions run inside ``lax.while_loop``/``scan``; here the loops
are Python and the exit tests of ``cg``, ``bicgstab`` and ``gmres`` read
one number on the host per iteration (one device->host sync).
The exit rules are the JAX ones exactly:

- cg:        iterate while it < max_iters and ||r|| > tol
- bicgstab:  iterate while it < max_iters and ||r|| finite and > tol
- gmres:     a cycle stops when |g[j+1]| <= tol or after ``restart`` steps;
             cycles repeat while it < max_iters and the cycle's residual
             estimate is > tol

with tol = max(rel_tol * ||r0||, abs_tol) (gmres: rel_tol * ||b||).
Scalars that only feed device arithmetic stay on the device, so the
branches of the JAX ``lax.cond``s become ``torch.where``.

Vectors may be tensors or nested dicts of tensors; ``gmres`` flattens a
dict in sorted-key order, as ``jax.flatten_util.ravel_pytree`` does.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from dafoam_tpu_torch.utils import tree
from dafoam_tpu_torch.utils.precision import guard_tiny


class SolveInfo(NamedTuple):
    iters: int
    resid0: float
    resid: float
    converged: bool
    pc_failed: int = 0     # gmres: columns whose preconditioner failed


def tdot(a, b):
    """<a, b> over every leaf, summed in sorted-key order."""
    return functools.reduce(torch.add, tree.leaves(
        tree.tmap(lambda x, y: torch.sum(x * y), a, b)))


def tnorm(a):
    return torch.sqrt(tdot(a, a))


def taxpy(alpha, x, y):
    return tree.tmap(lambda xi, yi: alpha * xi + yi, x, y)


def tzeros_like(x):
    return tree.tmap(torch.zeros_like, x)


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


# ---------------------------------------------------------------------------
# Fixed-step smoothers: exactly reverse-differentiable
# ---------------------------------------------------------------------------
#
# The fixed-point adjoint differentiates the primal step map G(W) = W -
# C(W) R(W). At a converged primal (R ~ 0) any smooth approximate inverse C
# gives exact totals, provided autograd differentiates the map actually
# computed. A fixed number of steps is smooth and its reverse pass is the
# exact transpose; jacobi_steps and chebyshev_steps are moreover linear in
# the defect (data-independent coefficients), while the Krylov steps'
# <r,z>/<p,Ap> ratios need the sticky freeze below.

def _eps_and_live(b):
    bl = tree.leaves(b)[0]
    return (torch.finfo(bl.dtype).eps,
            torch.ones((), dtype=torch.bool, device=bl.device))


def cg_steps(matvec: Callable, b, x0=None, precond: Callable | None = None,
             n_steps=20):
    """n_steps of preconditioned CG with no convergence exit (the "krylov"
    step-map smoother). Guarded divisions keep the map smooth near
    breakdown.

    STICKY freeze: once <r, z> falls to (256 eps)^2 of the problem scale
    max(|<b, M^-1 b>|, |<r0, z0>|), further steps would iterate on
    rounding noise, which explodes in the reverse pass. A frozen step has
    alpha = 0 and is an exact identity; the freeze is a 0-d device tensor
    carried across steps, so noise cannot unfreeze it and no step reads
    anything on the host."""
    precond = precond or _identity
    x = tzeros_like(b) if x0 is None else x0
    r = tree.tmap(torch.sub, b, matvec(x))
    z = precond(r)
    rz = tdot(r, z)
    eps, live = _eps_and_live(b)
    # relative to the problem scale, not to r0: a warm-started solve at a
    # converged state starts AT the noise floor
    bz = torch.abs(tdot(b, precond(b))).detach()
    cutoff = (256.0 * eps) ** 2 * torch.maximum(bz, torch.abs(rz.detach()))
    p = z
    tp = guard_tiny(rz.dtype)
    for _ in range(int(n_steps)):
        arz = torch.abs(rz.detach())
        live = live & torch.isfinite(arz) & (arz > cutoff)
        ap = matvec(p)
        pap = tdot(p, ap)
        alpha = torch.where(live, rz / _guard(pap, tp), 0.0)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, ap, r)
        z = precond(r)
        rz_new = tdot(r, z)
        beta = torch.where(live, rz_new / _guard(rz, tp), 0.0)
        p = taxpy(beta, p, z)
        rz = rz_new
    return x


def bicgstab_steps(matvec: Callable, b, x0=None,
                   precond: Callable | None = None, n_steps=10):
    """n_steps of preconditioned BiCGStab with no restarts and no
    convergence exit (guarded divisions), with cg_steps' sticky freeze at
    (256 eps)^2 max(<b, b>, <r0, r0>) on <r, r>; a frozen step keeps r and
    has alpha = omega = 0."""
    precond = precond or _identity
    x = tzeros_like(b) if x0 is None else x0
    r = tree.tmap(torch.sub, b, matvec(x))
    rhat = r
    eps, live = _eps_and_live(b)
    one = torch.ones((), dtype=tree.leaves(b)[0].dtype, device=live.device)
    cutoff = (256.0 * eps) ** 2 * torch.maximum(tdot(b, b).detach(),
                                                tdot(r, r).detach())
    p = v = tzeros_like(b)
    rho = alpha = omega = one
    tb = guard_tiny(one.dtype)
    for _ in range(int(n_steps)):
        rr = tdot(r, r).detach()
        live = live & torch.isfinite(rr) & (rr > cutoff)
        rho_new = tdot(rhat, r)
        beta = (rho_new / _guard(rho, tb)) * (alpha / _guard(omega, tb))
        p = tree.tmap(lambda ri, pi, vi: ri + beta * (pi - omega * vi),
                      r, p, v)
        phat = precond(p)
        v = matvec(phat)
        alpha_n = rho_new / _guard(tdot(rhat, v), tb)
        s_vec = taxpy(-alpha_n, v, r)
        shat = precond(s_vec)
        t = matvec(shat)
        tt = tdot(t, t)
        omega_n = tdot(t, s_vec) / torch.where(tt > tb, tt, tb)
        alpha_n = torch.where(live, alpha_n, 0.0)
        omega_n = torch.where(live, omega_n, 0.0)
        x = tree.tmap(lambda xi, ph, sh: xi + alpha_n * ph + omega_n * sh,
                      x, phat, shat)
        r_new = taxpy(-omega_n, t, s_vec)
        # keep the pre-step residual when frozen (s and t still carry
        # rounding noise)
        r = tree.tmap(lambda rn, ro: torch.where(live, rn, ro), r_new, r)
        rho, alpha, omega = rho_new, alpha_n, omega_n
    return x


def jacobi_steps(matvec: Callable, dinv, r0, n_steps=10, omega=0.6666667):
    """delta = k steps of damped Jacobi on A delta = r0, delta0 = 0.

    LINEAR in r0 with coefficients independent of the data: no
    <r,z>/<p,Ap> ratios that turn into differentiated noise at a converged
    (r0 ~ eps) state, so the reverse pass is unconditionally stable."""
    r0l = tree.leaves(r0)[0]
    omega = torch.as_tensor(omega, dtype=r0l.dtype, device=r0l.device)
    delta, r = tzeros_like(r0), r0
    for _ in range(int(n_steps)):
        upd = tree.tmap(lambda di, ri: omega * di * ri, dinv, r)
        delta = tree.tmap(torch.add, delta, upd)
        r = tree.tmap(torch.sub, r, matvec(upd))
    return delta


def chebyshev_steps(matvec: Callable, dinv, r0, n_steps=20, lam_max=2.2,
                    ratio=30.0):
    """delta = k-step Chebyshev semi-iteration on D^-1 A delta = D^-1 r0,
    delta0 = 0, targeting the spectrum slice [lam_max/ratio, lam_max] of
    the Jacobi-preconditioned operator. lam_max may be a 0-d tensor (the
    caller's Gershgorin bound); it is a coefficient of the map, not a
    function of r0. Dot-product-free and exactly AD-transposable."""
    r0l = tree.leaves(r0)[0]
    hi = torch.as_tensor(lam_max, dtype=r0l.dtype, device=r0l.device)
    lo = hi / ratio
    theta = (hi + lo) / 2.0
    half = (hi - lo) / 2.0
    sigma = theta / half

    pr0 = tree.tmap(lambda di, ri: di * ri, dinv, r0)

    def pmv(v):
        return tree.tmap(lambda di, ai: di * ai, dinv, matvec(v))

    dvec = tree.tmap(lambda v: (1.0 / theta) * v, pr0)
    rho = 1.0 / sigma
    delta, r = tzeros_like(r0), pr0
    for _ in range(int(n_steps)):
        delta = tree.tmap(torch.add, delta, dvec)
        r = tree.tmap(torch.sub, r, pmv(dvec))
        rho_new = 1.0 / (2.0 * sigma - rho)
        dvec = tree.tmap(lambda dv, ri: rho_new * rho * dv
                         + (2.0 * rho_new / half) * ri, dvec, r)
        rho = rho_new
    return delta


# ---------------------------------------------------------------------------
# Restarted GMRES (the adjoint linear solver)
# ---------------------------------------------------------------------------

def _back_substitute(R, g):
    """Solve the upper-triangular R y = g (numpy, R's dtype)."""
    m = g.shape[0]
    y = np.zeros_like(g)
    for i in range(m - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:] @ y[i + 1:]) / R[i, i]
    return y


def _solve_lower(L, B):
    """Solve the lower-triangular L X = B (numpy, L's dtype)."""
    X = np.zeros_like(B)
    for i in range(L.shape[0]):
        X[i] = (B[i] - L[i, :i] @ X[:i]) / L[i, i]
    return X


def gmres(matvec: Callable, b, x0=None, precond: Callable | None = None,
          restart=60, rel_tol=1e-6, abs_tol=1e-14, max_iters=1000,
          deflate=0, aug0=None, return_aug=False):
    """Flexible right-preconditioned restarted GMRES (FGMRES) on a tensor
    or a dict of tensors (reference role: the adjoint KSPGMRES,
    DALinearEqn.C:28).

    Flexible: the preconditioned basis Z is stored beside V, so the
    preconditioner may itself be an inner iteration. Without a
    preconditioner and without deflation Z is not materialized.

    deflate=k > 0: deflated restarts (GMRES-E/GCRO-DR class). The last k of
    each cycle's m directions are the previous cycle's best approximations
    to A's smallest directions, extracted from the projected problem
    min_y ||Hbar y|| / ||Z y||; the recycle space survives restarts, and
    with aug0/return_aug it is carried across calls as a (k, n_flat) array.

    Preconditioner failure: a preconditioned direction that is exactly
    zero or not finite (a PC whose inner sweeps never left their zero
    start) would make A z = 0 and a zero Givens sine, which reads as
    convergence. Such a column takes the unpreconditioned V[j] instead,
    which FGMRES allows because Z is stored; ``SolveInfo.pc_failed``
    counts these columns. A column whose A z adds nothing to the earlier
    ones (a zero or non-finite pivot) is left out and ends the cycle; a
    cycle that keeps no column ends the solve. ``converged`` is never True
    for a non-finite x.

    Layout: the Krylov basis V (m+1, n) and Z live on the vectors' device;
    the small (m+1, m) Hessenberg matrix, its Givens rotations and the
    m x m deflation algebra run on the host in the vectors' dtype. One
    device->host read per Arnoldi step carries the new Hessenberg column,
    its subdiagonal entry and with them the exit test.
    """
    flexible = precond is not None
    k_defl = int(deflate)
    store_z = flexible or k_defl > 0
    precond = precond or _identity
    flat_b, unravel = tree.ravel(b)
    n = flat_b.shape[0]
    dtype, dev = flat_b.dtype, flat_b.device
    npdt = np.float64 if dtype == torch.float64 else np.float32
    tiny = guard_tiny(dtype)

    def mv_flat(u):
        return tree.ravel(matvec(unravel(u)))[0]

    def prec_flat(u):
        return tree.ravel(precond(unravel(u)))[0]

    x = torch.zeros_like(flat_b) if x0 is None else tree.ravel(x0)[0]
    bnorm = float(torch.linalg.norm(flat_b))
    tol = max(rel_tol * bnorm, abs_tol)
    m = int(restart)
    m_arn = m - k_defl     # fresh Arnoldi directions per cycle
    assert m_arn >= 1, "deflate must be < restart"
    kk = max(k_defl, 1)
    eye = np.eye(m, dtype=npdt)

    def cycle(x, U):
        r = flat_b - mv_flat(x)      # TRUE residual (x in solution space)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((m if store_z else 1, n), dtype=dtype, device=dev)
        H = np.zeros((m + 1, m), dtype=npdt)
        cs = np.zeros((m,), dtype=npdt)
        sn = np.zeros((m,), dtype=npdt)
        g = np.zeros((m + 1,), dtype=npdt)
        g[0] = npdt(float(beta))
        V[0] = r / torch.clamp_min(beta, tiny)
        unorm = torch.linalg.norm(U, dim=1).cpu().numpy() if k_defl else None
        k = n_failed = 0
        done = False
        for j in range(m):
            failed = None
            if k_defl > 0 and j >= m_arn and unorm[j - m_arn] > tiny:
                # recycle directions are solution-space vectors: they
                # enter the augmented basis verbatim (never re-
                # preconditioned), zero rows fall back to Krylov vectors
                z = U[j - m_arn]
            elif flexible:
                # a zero or non-finite PC direction takes V[j] (no host
                # read here: the flag rides on the Hessenberg column's)
                z = prec_flat(V[j])
                zmax = torch.amax(torch.abs(z))
                failed = ~(torch.isfinite(zmax) & (zmax > 0))
                z = torch.where(failed, V[j], z)
            else:
                z = V[j]
            if store_z:
                Z[j] = z
            w = mv_flat(z)
            # modified Gram-Schmidt, two passes
            h1 = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h1
            h2 = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h2
            hj1 = torch.linalg.norm(w)
            V[j + 1] = w / torch.clamp_min(hj1, tiny)
            parts = [h1 + h2, hj1[None]]
            if failed is not None:
                parts.append(failed[None].to(dtype))
            col_h = torch.cat(parts).cpu().numpy()
            if failed is not None:
                n_failed += int(col_h[j + 2] != 0)
            col = np.zeros((m + 1,), dtype=npdt)
            col[:j + 1] = col_h[:j + 1]
            hj1 = col_h[j + 1]
            col[j + 1] = hj1
            # apply the accumulated Givens rotations to column j
            for i in range(j):
                t0 = cs[i] * col[i] + sn[i] * col[i + 1]
                t1 = -sn[i] * col[i] + cs[i] * col[i + 1]
                col[i], col[i + 1] = t0, t1
            denom = np.sqrt(col[j] ** 2 + hj1 ** 2)
            if not (np.isfinite(denom) and denom > 0):
                break           # a zero or non-finite pivot: left out
            c_new = col[j] / max(denom, npdt(tiny))
            s_new = hj1 / max(denom, npdt(tiny))
            cs[j], sn[j] = c_new, s_new
            col[j], col[j + 1] = denom, 0.0
            H[:, j] = col
            g[j + 1] = -s_new * g[j]
            g[j] = c_new * g[j]
            k = j + 1
            done = bool(abs(g[j + 1]) <= tol)
            if done:
                break

        # back-substitute y from the leading k x k triangle
        y = _back_substitute(H[:k, :k], g[:k])
        S = Z if store_z else V[:m]
        x = x + S[:k].T @ torch.as_tensor(y, device=dev)
        resid = float(abs(g[k]))

        if k_defl > 0 and k >= 1:
            # refresh the recycle space: the k directions s = S^T y that
            # minimize ||A s|| / ||s|| over the cycle's search space, from
            # (Hbar^T Hbar) y = theta (S S^T) y; unused columns padded to
            # the identity
            used = np.arange(m) < k
            u2 = used[None, :] & used[:, None]
            Hbar = np.where(used[None, :], H, 0.0).astype(npdt)
            A_small = np.where(u2, Hbar.T @ Hbar, eye).astype(npdt)
            G = np.zeros((m, m), dtype=npdt)
            G[:k, :k] = (S[:k] @ S[:k].T).cpu().numpy()
            G = np.where(u2, G, eye).astype(npdt)
            ridge = np.sqrt(np.finfo(npdt).eps) * np.trace(G) / npdt(m)
            G = G + max(ridge, npdt(1e-30)) * eye
            L = np.linalg.cholesky(G)
            Li = _solve_lower(L, eye)
            Aw = Li @ A_small @ Li.T
            _, Q = np.linalg.eigh(Aw)                   # ascending
            Y = Li.T @ Q[:, :k_defl]                    # smallest k_defl
            U_new = torch.as_tensor(np.ascontiguousarray(Y[:k].T),
                                    device=dev) @ S[:k]
            nrm = torch.linalg.norm(U_new, dim=1, keepdim=True)
            U = U_new / torch.clamp_min(nrm, tiny)
        return x, U, resid, k, n_failed

    if aug0 is None:
        U = torch.zeros((kk, n), dtype=dtype, device=dev)
    else:
        U = torch.as_tensor(aug0, dtype=dtype, device=dev).reshape(kk, n)
    if aug0 is not None and k_defl > 0:
        # re-orthonormalize the carried-in recycle space: rows harvested
        # from successive calls can grow near-parallel; Cholesky whitening
        # keeps the span and restores full rank, and numerically dependent
        # rows are zeroed (the cycle then treats them as unseeded)
        Gu = (U @ U.T).cpu().numpy()
        eyek = np.eye(kk, dtype=npdt)
        ridge0 = np.sqrt(np.finfo(npdt).eps) * (
            np.trace(Gu) / npdt(kk) + npdt(1e-30))
        Lu = torch.as_tensor(np.linalg.cholesky(Gu + ridge0 * eyek),
                             device=dev)
        Uw = torch.linalg.solve_triangular(Lu, U, upper=False)
        U = torch.where(torch.isfinite(Uw), Uw, 0.0)
        rn = torch.linalg.norm(U, dim=1, keepdim=True)
        U = torch.where(rn > tiny, U / torch.clamp_min(rn, tiny), 0.0)

    r0 = float(torch.linalg.norm(flat_b - mv_flat(x)))
    res, it, done, n_failed = r0, 0, r0 <= tol, 0
    while it < max_iters and not done:
        x, U, res, k, nf = cycle(x, U)
        it += k
        n_failed += nf
        done = res <= tol or k == 0
    converged = res <= tol and bool(torch.isfinite(x).all())
    info = SolveInfo(it, r0, res, converged, n_failed)
    if return_aug:
        return unravel(x), info, U
    return unravel(x), info
