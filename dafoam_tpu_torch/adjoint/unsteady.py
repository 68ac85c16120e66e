"""Time-accurate unsteady adjoint: the reverse sweep over the stored
history (port of ``dafoam_tpu.adjoint.unsteady``).

The discrete adjoint of implicit-Euler/BDF2 stepping (reference
DAFoamSolverUnsteady.compute_jacvec_product, mphys_dafoam.py:1390-1679, and
calcdRdWOldTPsiAD, DASolver.C:1910). Per reverse step n = T .. 1:

    rhs    = w_n dF/dW^n - (dR^{n+1}/dW^n)^T psi^{n+1}
             - (dR^{n+2}/dW^n)^T psi^{n+2}
    psi^n  : (dR^n/dW^n)^T psi^n = rhs          (matrix-free FGMRES)
    totals += w_n pF/px - (dR^n/dx)^T psi^n

The reverse ``lax.scan`` of ``dafoam_tpu`` becomes a descending Python loop
over stored tensors. Each step records ONE residual graph, R^n(W^n,
W^{n-1}, W^{n-2}, x) with all four arguments requiring grad: every GMRES
product re-walks it (``retain_graph=True``) for d/dW^n, and one last
backward with psi^n gives, besides (dR^n/dx)^T psi^n, the two old-state
products that the next two reverse steps subtract ((dR^n/dW^{n-1})^T psi^n
is step n-1's first cross term, (dR^n/dW^{n-2})^T psi^n step n-2's
second), then frees the graph. So the device holds one step's graph at a
time, and the old-state products cost no residual evaluation of their own
(``dafoam_tpu`` evaluates R^{n+1} and R^{n+2} again at step n).

The preconditioner (``pc_assemble(W, W1, W2, inputs, n) -> pc``, built
from a detached state) is rebuilt only on reverse steps with
(T - n) % pc_interval == 0: the reference's PCMatPrecomputeInterval.

``unsteady_adjoint_totals_checkpointed`` keeps only every seg_len-th state
(a triple, for the cross terms) and recomputes one segment's history per
reverse segment, so memory is O(seg_len + T/seg_len) states instead of
O(T) (the reference re-reads every step from disk, DASolver.C:3193).
"""

from __future__ import annotations

from typing import Callable

import torch

from dafoam_tpu_torch.adjoint.solver import _grad, _requiring_grad, _scale
from dafoam_tpu_torch.linalg.krylov import gmres
from dafoam_tpu_torch.utils import tree


def at(hist, n):
    """The state at index ``n`` of a stacked (T+1, ...) history."""
    return {k: v[n] for k, v in hist.items()}


def _segment_sweep(residual_fn, func_fn, H, inputs, weights, carry, n_hi,
                   length, T, ddt_order, state_scales, res_scales, restart,
                   rel_tol, abs_tol, max_iters, pc_assemble, pc_interval,
                   log):
    """Sweep steps n = n_hi .. n_hi - length + 1 (descending).

    H(n): the stored state at global step n (n >= n_hi - length - 1).
    carry: (cross, totals, pc) with cross {n: the old-state products
    already subtracted from step n's right-hand side}. Returns the new
    carry and the per-step adjoint residuals."""
    cross, totals, pc = carry
    resids = []
    for n in range(n_hi, n_hi - length, -1):
        W, W1, W2 = H(n), H(n - 1), H(n - 2)
        wgt = weights[n - 1]

        # dF/dW^n and pF/px in one backward
        w = _requiring_grad(W)
        x = _requiring_grad(inputs)
        with torch.enable_grad():
            F = func_fn(w, x, n)
        g = _grad(F, {"W": w, "x": x})
        dFdW, dFdx = g["W"], g["x"]
        rhs = tree.tmap(lambda g: wgt * g, dFdW)
        if n in cross:
            rhs = tree.tmap(torch.sub, rhs, cross.pop(n))

        # this step's residual graph, recorded once
        w = _requiring_grad(W)
        w1 = _requiring_grad(W1)
        w2 = _requiring_grad(W2) if ddt_order == 2 else W2
        with torch.enable_grad():
            R = residual_fn(w, w1, w2, x, n)

        def matT(ps):
            g = _grad(R, w, _scale(ps, res_scales, invert=True),
                      retain_graph=True)
            return _scale(g, state_scales)

        if pc_assemble is not None and (pc is None
                                        or (T - n) % pc_interval == 0):
            pc = pc_assemble(W, W1, W2, inputs, n)
        psi_s, info = gmres(matT, _scale(rhs, state_scales), precond=pc,
                            restart=restart, rel_tol=rel_tol,
                            abs_tol=abs_tol, max_iters=max_iters)
        psi = _scale(psi_s, res_scales, invert=True)
        resids.append(info.resid)
        if log is not None:
            log(info)

        # (dR^n/d(x, W^{n-1}, W^{n-2}))^T psi^n; frees the graph
        wrt = {"x": x, "w1": w1}
        if ddt_order == 2:
            wrt["w2"] = w2
        gs = _grad(R, wrt, psi)
        totals = tree.tmap(lambda t, a, b: t + wgt * a - b, totals, dFdx,
                           gs["x"])
        for m, key in ((n - 1, "w1"), (n - 2, "w2")):
            c = gs.get(key)
            if c is not None and m >= 1:
                cross[m] = tree.tmap(torch.add, cross[m], c) \
                    if m in cross else c
    return (cross, totals, pc), resids


def unsteady_adjoint_totals(
        residual_fn: Callable,   # (W, W_old, W_oldold, inputs, n) -> res
        func_fn: Callable,       # (W, inputs, n) -> 0-d tensor
        hist: dict,              # stacked (T+1, ...), index 0 = IC
        inputs: dict,
        weights: torch.Tensor,   # (T,) dJ/df_n from the time op
        ddt_order: int = 1,
        state_scales=None, res_scales=None,
        restart=100, rel_tol=1e-8, abs_tol=1e-14, max_iters=1000,
        pc_assemble: Callable | None = None, pc_interval: int = 1,
        log: Callable | None = None):
    """In-memory reverse sweep. Returns (totals shaped like inputs, the
    (T,) per-step adjoint residuals, step T first).

    pc_assemble(W, W1, W2, inputs, n) -> pc: the preconditioner of step
    n's transposed system (``dafoam_tpu``'s pc_assemble and pc_apply in
    one: the PC is built once per assembly, not per application).
    log(SolveInfo), when given, receives each step's GMRES info."""
    T = next(iter(hist.values())).shape[0] - 1

    def H(n):
        return at(hist, min(max(n, 0), T))

    totals0 = tree.tmap(torch.zeros_like, inputs)
    (_, totals, _), resids = _segment_sweep(
        residual_fn, func_fn, H, inputs, weights, ({}, totals0, None), T, T,
        T, ddt_order, state_scales, res_scales, restart, rel_tol, abs_tol,
        max_iters, pc_assemble, pc_interval, log)
    return totals, torch.tensor(resids, dtype=torch.float64)


def unsteady_adjoint_totals_checkpointed(
        advance_fn: Callable,    # (W, inputs, n) -> state after step n
        residual_fn: Callable, func_fn: Callable,
        checkpoints: dict,       # stacked (n_seg+1, 3, ...): ckpt[s] =
                                 # states at (s*L, max(s*L-1,0),
                                 # max(s*L-2,0))
        seg_len: int, T: int,
        inputs, weights,
        ddt_order: int = 1, state_scales=None, res_scales=None,
        restart=100, rel_tol=1e-8, abs_tol=1e-14, max_iters=1000,
        pc_assemble=None, pc_interval: int = 1, log=None):
    """Checkpoint/recompute reverse sweep for long histories: segment s
    (steps s*L+1 .. s*L+L) is recomputed from its checkpoint with
    ``advance_fn`` under no_grad and swept. A step reads only W^n, W^{n-1}
    and W^{n-2}; the cross terms of the segment above arrive in the
    carry."""
    n_seg = T // seg_len
    if T != n_seg * seg_len:
        raise ValueError("T must be a multiple of seg_len")
    totals = tree.tmap(torch.zeros_like, inputs)
    carry = ({}, totals, None)
    all_resids = []
    for s in range(n_seg - 1, -1, -1):
        n0 = s * seg_len
        ck = {k: v[s] for k, v in checkpoints.items()}
        states = {n0 - 2: at(ck, 2), n0 - 1: at(ck, 1), n0: at(ck, 0)}
        W = states[n0]
        with torch.no_grad():
            for n in range(n0 + 1, n0 + seg_len + 1):
                W = advance_fn(W, inputs, n)
                states[n] = W
        carry, resids = _segment_sweep(
            residual_fn, func_fn, states.__getitem__, inputs, weights, carry, n0 + seg_len,
            seg_len, T, ddt_order, state_scales, res_scales, restart,
            rel_tol, abs_tol, max_iters, pc_assemble, pc_interval, log)
        all_resids += resids
    return carry[1], torch.tensor(all_resids, dtype=torch.float64)
