"""Discrete adjoint and total derivatives: the residual form and the
fixed-point form on the primal step map.

Port of ``dafoam_tpu.adjoint.solver``.

Residual form (``adjoint_solve``, ``total_derivative``,
``forward_total_derivative``; the reference's default ``adjEqnSolMethod:
Krylov``): with the converged state W* and R(W*, x) = 0,

    dR/dW^T psi = dJ/dW,    dJ/dx = pJ/px - psi^T pR/px,

solved by FGMRES on the state/residual-normalized system (reference
normalizeGradientVec/normalizeJacTVecProduct, DASolver.C:2356, :1443):
(D_W dR/dW^T D_R^-1) psi~ = D_W dJ/dW, psi = D_R^-1 psi~.

Fixed-point form (``adjoint_solve_fp``, ``total_derivative_fp``,
``forward_total_derivative_fp``; runFPAdj, DASimpleFoam.C:189): with the
primal's outer iteration w_{k+1} = G(w_k),

    (I - dG/dW^T) psibar = dJ/dW,    dJ/dx = pJ/px + psibar^T pG/px.

Autograd replaces ``jax.vjp``/``jax.jvp``:

- a reverse product (dR^T v, dG^T v) re-walks ONE recorded graph
  (``torch.autograd.grad`` with ``retain_graph=True``), recorded with the
  inputs detached, so each GMRES iteration costs a backward pass and no
  forward (with ``fpRemat`` the step map is instead re-run for every
  product and its graph freed after the backward);
- a forward (tangent) product runs R or G once under
  ``torch.autograd.forward_ad``: ``torch.func.linearize`` would trace it
  with ``make_fx``, and the DIA kernels launch through ctypes, which a
  trace cannot capture.

Vectors are dicts of tensors shaped like the state (inputs-shaped for
totals); in the fixed-point form ``scales`` (normalizeStates) turn the
solve into the similarity transform (I - S dG^T S^-1) y = S g,
psibar = y / S.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.autograd.forward_ad as fwAD

from dafoam_tpu_torch.linalg.krylov import (SolveInfo, gmres, taxpy, tnorm,
                                            tzeros_like)
from dafoam_tpu_torch.utils import tree


def _scale(t, scales: dict | None, invert=False):
    if not scales:
        return t
    out = {}
    for k, v in t.items():
        s = scales.get(k, 1.0)
        out[k] = v / s if invert else v * s
    return out


def _requiring_grad(t):
    """A detached copy of every leaf, marked to require grad."""
    return tree.tmap(lambda v: v.detach().requires_grad_(True), t)


def _grad(outputs, inputs, grad_outputs=None, retain_graph=False):
    """d(outputs)/d(inputs) as a tree shaped like ``inputs``, zeros where an
    input does not reach the outputs."""
    ins = tree.leaves(inputs)
    outs = tree.leaves(outputs)
    gos = None if grad_outputs is None else tree.leaves(grad_outputs)
    gs = torch.autograd.grad(outs, ins, grad_outputs=gos,
                             retain_graph=retain_graph, allow_unused=True)
    return tree.unflatten(inputs, [torch.zeros_like(i) if g is None else g
                                   for i, g in zip(ins, gs)])


def vjp(fn: Callable, primals):
    """(fn(primals) detached, v -> v^T d fn/d primals). The graph is
    recorded once and re-walked by every call of the returned function."""
    p = _requiring_grad(primals)
    with torch.enable_grad():
        out = fn(p)

    def f_vjp(v):
        return _grad(out, p, v, retain_graph=True)

    return tree.tmap(torch.Tensor.detach, out), f_vjp


def jvp(fn: Callable, primals, tangents):
    """(fn(primals), d fn/d primals . tangents) by forward-mode AD."""
    with torch.no_grad(), fwAD.dual_level():
        duals = tree.tmap(lambda p, t: fwAD.make_dual(p, t.to(p.dtype)),
                          primals, tangents)
        out = fn(duals)
        prim = tree.tmap(lambda o: fwAD.unpack_dual(o).primal, out)
        tan = tree.tmap(lambda o: fwAD.unpack_dual(o).tangent, out)
    tan = tree.tmap(lambda t, p: torch.zeros_like(p) if t is None else t,
                    tan, prim)
    return prim, tan


def dJdW_of(func_fn: Callable, state, inputs):
    """pJ/pW, the seed of the adjoint right-hand side."""
    w = _requiring_grad(state)
    with torch.enable_grad():
        J = func_fn(w, inputs)
    return _grad(J, w)


def _detached(t):
    return tree.tmap(torch.Tensor.detach, t)


def adjoint_solve(residual_fn: Callable, state, inputs, dJdW,
                  state_scales: dict | None = None,
                  res_scales: dict | None = None,
                  precond: Callable | None = None,
                  restart=60, rel_tol=1e-6, abs_tol=1e-14, max_iters=1000,
                  psi0=None, deflate=0, aug0=None, return_aug=False):
    """Solve dR/dW^T psi = dJ/dW matrix-free by FGMRES on the scaled
    operator psi~ -> D_W dR/dW^T D_R^-1 psi~.

    residual_fn: (W, inputs) -> R. A preconditioner factory marked
    ``needs_opT`` (``precond.make_coupled_pc``) receives that operator
    first. Returns (psi shaped like R, SolveInfo[, recycle space]); psi0
    and psi are unscaled at the API, the recycle space lives in the
    scaled flat space.
    """
    x = _detached(inputs)
    _, f_vjp = vjp(lambda w: residual_fn(w, x), state)

    def matT(psi_scaled):
        g = f_vjp(_scale(psi_scaled, res_scales, invert=True))
        return _scale(g, state_scales)

    if precond is not None and getattr(precond, "needs_opT", False):
        precond = precond(matT)
    x0 = None if psi0 is None else _scale(psi0, res_scales)
    out = gmres(matT, _scale(dJdW, state_scales), x0=x0, precond=precond,
                restart=restart, rel_tol=rel_tol, abs_tol=abs_tol,
                max_iters=max_iters, deflate=deflate, aug0=aug0,
                return_aug=return_aug)
    return (_scale(out[0], res_scales, invert=True), *out[1:])


def total_derivative(residual_fn: Callable, func_fn: Callable, state,
                     inputs, psi):
    """dJ/dx = pJ/px - psi^T pR/px for every leaf of ``inputs`` (reference
    calcJacTVecProduct, DASolver.C:1690)."""
    w = _detached(state)
    x = _requiring_grad(inputs)
    with torch.enable_grad():
        J = func_fn(w, x)
    pJpx = _grad(J, x)
    _, fx_vjp = vjp(lambda xx: residual_fn(w, xx), inputs)
    return tree.tmap(torch.sub, pJpx, fx_vjp(psi))


def forward_total_derivative(residual_fn: Callable, func_fn: Callable,
                             state, inputs, dx, restart=60, rel_tol=1e-10,
                             max_iters=2000, precond: Callable | None = None,
                             state_scales: dict | None = None,
                             res_scales: dict | None = None):
    """Forward-mode total derivative (the reference's ADF cross-check):
    dW = -(dR/dW)^-1 (pR/px dx), dJ = pJ/pW dW + pJ/px dx.

    The tangent system is solved in the adjoint's normalized metric,
    (D_R^-1 dR/dW D_W) y = D_R^-1 b, dW = D_W y; otherwise the two AD
    directions converge in different metrics and their totals disagree at
    the scale-imbalance level. Each GMRES product runs R once in forward
    mode."""
    _, b = jvp(lambda x: residual_fn(state, x), inputs, dx)

    def mat(v):
        _, jv = jvp(lambda w: residual_fn(w, inputs), state,
                    _scale(v, state_scales))
        return _scale(jv, res_scales, invert=True)

    y_neg, info = gmres(mat, _scale(b, res_scales, invert=True),
                        restart=restart, rel_tol=rel_tol,
                        max_iters=max_iters, precond=precond)
    dW = tree.tmap(torch.neg, _scale(y_neg, state_scales))
    _, dJ_w = jvp(lambda w: func_fn(w, inputs), state, dW)
    _, dJ_x = jvp(lambda x: func_fn(state, x), inputs, dx)
    return dJ_w + dJ_x, info


def adjoint_solve_fp(step_fn: Callable, state, inputs, dJdW,
                     rel_tol=1e-6, abs_tol=1e-14, max_iters=1000,
                     relax=1.0, accel="gmres", restart=60, psi0=None,
                     deflate=0, scales: dict | None = None,
                     aug0=None, return_aug=False, remat=False):
    """Solve (I - dG/dW^T) psibar = dJ/dW on the step map ``step_fn``
    ((W, inputs) -> (W_next, residual)); only W_next is used.

    accel "gmres": deflated restarted GMRES (``linalg/krylov.gmres``;
    aug0/return_aug carry the (deflate, n_flat) recycle space across
    calls, in the SCALED flat space). accel "richardson": plain sweeps
    y <- y + relax (S g - (I - S dG^T S^-1) y). Returns (psibar,
    SolveInfo[, recycle space]); psi0/psibar are unscaled at the API.
    remat (fpRemat) trades the recorded graph for one forward per product.
    """
    if remat:
        # adjEqnOption.fpRemat: no graph is kept across products; each
        # product re-runs the step map under grad and frees its graph in
        # the backward pass (one more forward per product, the memory of
        # one graph at a time)
        def f_vjp(v):
            p = _requiring_grad(state)
            with torch.enable_grad():
                out = step_fn(p, inputs)[0]
            return _grad(out, p, v)
    else:
        _, f_vjp = vjp(lambda w: step_fn(w, inputs)[0], state)

    def matv(v):
        g = f_vjp(_scale(v, scales, invert=True))
        return tree.tmap(torch.sub, v, _scale(g, scales))

    rhs = _scale(dJdW, scales)
    x0 = None if psi0 is None else _scale(psi0, scales)
    if accel == "gmres":
        out = gmres(matv, rhs, x0=x0, restart=restart, rel_tol=rel_tol,
                    abs_tol=abs_tol, max_iters=max_iters, deflate=deflate,
                    aug0=aug0, return_aug=return_aug)
        return (_scale(out[0], scales, invert=True), *out[1:])

    # Richardson (reference-parity plain sweeps), same transformed system
    x = tzeros_like(rhs) if x0 is None else x0
    tol = max(rel_tol * float(tnorm(rhs)), abs_tol)

    def resid(x):
        return tree.tmap(torch.sub, rhs, matv(x))

    r = resid(x)
    r0 = rn = float(tnorm(r))
    it = 0
    while it < max_iters and math.isfinite(rn) and rn > tol:
        x = taxpy(relax, r, x)
        r = resid(x)
        rn = float(tnorm(r))
        it += 1
    out = (_scale(x, scales, invert=True), SolveInfo(it, r0, rn, rn <= tol))
    # richardson has no recycle space: aug0 passes through unchanged
    return (*out, aug0) if return_aug else out


def total_derivative_fp(step_fn: Callable, func_fn: Callable, state,
                        inputs, psibar):
    """dJ/dx = pJ/px + psibar^T pG/px for every leaf of ``inputs``."""
    x = _requiring_grad(inputs)
    with torch.enable_grad():
        J = func_fn(state, x)
    pJpx = _grad(J, x)
    _, fx_vjp = vjp(lambda xx: step_fn(state, xx)[0], inputs)
    gx = fx_vjp(psibar)
    return tree.tmap(torch.add, pJpx, gx)


def forward_total_derivative_fp(step_fn: Callable, func_fn: Callable,
                                state, inputs, dx, rel_tol=1e-6,
                                abs_tol=1e-30, max_iters=1000, restart=60,
                                deflate=0, scales: dict | None = None):
    """Tangent twin of the fixed-point adjoint: solve (I - dG/dW) dW =
    pG/px dx with the same deflated GMRES, then dJ = pJ/pW dW + pJ/px dx.
    Each product runs the step map once in forward mode. scales: the same
    normalized metric (here the conjugation is S^-1 dG S)."""
    _, b = jvp(lambda x: step_fn(state, x)[0], inputs, dx)

    def mat(v):
        _, g = jvp(lambda w: step_fn(w, inputs)[0], state,
                   _scale(v, scales))
        return tree.tmap(torch.sub, v, _scale(g, scales, invert=True))

    y, info = gmres(mat, _scale(b, scales, invert=True), restart=restart,
                    rel_tol=rel_tol, abs_tol=abs_tol, max_iters=max_iters,
                    deflate=deflate)
    dW = _scale(y, scales)
    _, dJ_w = jvp(lambda w: func_fn(w, inputs), state, dW)
    _, dJ_x = jvp(lambda x: func_fn(state, x), inputs, dx)
    return dJ_w + dJ_x, info
