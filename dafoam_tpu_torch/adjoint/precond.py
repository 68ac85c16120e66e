"""Block preconditioners for the residual-form adjoint GMRES.

Port of ``dafoam_tpu.adjoint.precond``. The per-equation FvMatrix operators
that the residual assembly already builds (momentum, pressure, turbulence)
approximate dR/dW^T block by block:

    PC(r)_U   ~ (M_U /V)^-T r_U        (a few Jacobi-BiCGStab sweeps)
    PC(r)_p   ~ (M_p /V)^-T r_p        (a few Jacobi-CG sweeps)
    PC(r)_phi ~ -r_phi                 (d R_phi / d phi = -I)
    PC(r)_nuT ~ (M_sa/V)^-T r_nuT

or, with ``pcType`` "lineJacobi"/"coupledLine", by exact ADI line solves
(``linalg/lines.py``), optionally coupled through the full transposed
Jacobian by block Gauss-Seidel sweeps.

Every transposed product M^T x is one K3a launch on M's own bands
(``fvmatrix.matvec_t_fn``); the forward-system twins (``_solve_F``,
``line_solver_F``) use K1/K2. Vector equations run component-major (C, nc)
through the ``_multi`` kernels with a per-component diagonal, where
``dafoam_tpu`` iterates cell-major on an (nc, 3) diagonal: the iterates
agree up to the order of summation.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.linalg.krylov import bicgstab, cg
from dafoam_tpu_torch.linalg.lines import cell_major_matvec, line_solver
from dafoam_tpu_torch.ops.fvmatrix import (FvMatrix, banded, matvec_fn,
                                           matvec_t_fn)
from dafoam_tpu_torch.utils.precision import guard_tiny


def transpose(m: FvMatrix) -> FvMatrix:
    """LDU transpose: swap lower/upper (boundary folds sit on the diag)."""
    return FvMatrix(diag=m.diag, lower=m.upper, upper=m.lower,
                    source=m.source)


def _sweeper(m: FvMatrix, topo, make, symmetric, iters):
    """r -> z ~ A^-1 r by ``iters`` Jacobi-preconditioned CG/BiCGStab
    sweeps (rel_tol 0.05), A = M or M^T as ``make`` (matvec_fn/matvec_t_fn)
    applies it. The band coefficients and the inverse diagonal are built
    once per layout. Vector fields (nc, C) run component-major on a banded
    mesh."""
    prepared = {}
    solver = cg if symmetric else bicgstab

    def prepare(r):
        cm = r.ndim == 2 and banded(topo)
        if cm:
            d = m.diag[None, :] if m.diag.ndim == 1 else \
                m.diag.t().contiguous()
            mv = make(m, topo, component_major=True)
        else:
            d = m.diag if m.diag.ndim == r.ndim else m.diag[..., None]
            mv = make(m, topo)
        td = guard_tiny(d.dtype)
        return cm, mv, 1.0 / torch.where(torch.abs(d) > td, d, 1.0)

    def solve(r):
        if r.ndim not in prepared:
            prepared[r.ndim] = prepare(r)
        cm, mv, dinv = prepared[r.ndim]
        rr = r.t().contiguous() if cm else r
        z, _ = solver(mv, rr, precond=lambda x: dinv * x, rel_tol=0.05,
                      max_iters=iters)
        return z.t() if cm else z

    return solve


def _vol(vol, r):
    return vol if r.ndim == 1 else vol[:, None]


def _block_T(m, topo, vol, symmetric, iters):
    """r -> x ~ ((M/V)^T)^-1 r:  M^T z = r, x = V z, by ``_sweeper``."""
    sweep = _sweeper(m, topo, matvec_t_fn, symmetric, iters)
    return lambda r: _vol(vol, r) * sweep(r)


def _block_F(m, topo, vol, symmetric, iters):
    """r -> x ~ (M/V)^-1 r:  M x = V r (the forward twin of _block_T, for
    the untransposed dR/dW of forward_total_derivative)."""
    sweep = _sweeper(m, topo, matvec_fn, symmetric, iters)
    return lambda r: sweep(_vol(vol, r) * r)


def _solve_T(m: FvMatrix, r, topo, vol, symmetric=False, iters=15):
    """Approximately solve (M/V)^T x = r."""
    return _block_T(m, topo, vol, symmetric, iters)(r)


def _solve_F(m: FvMatrix, r, topo, vol, symmetric=False, iters=15):
    """Approximately solve (M/V) x = r."""
    return _block_F(m, topo, vol, symmetric, iters)(r)


def line_solver_T(m: FvMatrix, topo, geom, adi_sweeps=1):
    """Line-implicit approximate inverse of (M/V)^T: the ADI line solves of
    ``linalg/lines.line_solver`` on transpose(m), with K3a defect
    products, times V. None without a dense-DIA layout (the caller falls
    back to the Krylov-sweep block)."""
    base = line_solver(transpose(m), topo, adi_sweeps=adi_sweeps,
                       matvec=cell_major_matvec(m, topo, matvec_t_fn))
    if base is None:
        return None
    return lambda r: _vol(geom.vol, r) * base(r)


def line_solver_F(m: FvMatrix, topo, geom, adi_sweeps=1):
    """Line-implicit approximate inverse of (M/V) (forward twin of
    line_solver_T). None without a dense-DIA layout."""
    base = line_solver(m, topo, adi_sweeps=adi_sweeps)
    if base is None:
        return None
    return lambda r: base(_vol(geom.vol, r) * r)


def _block_map(blockinvs: dict, scales: dict, identity_fields):
    """r -> per-field block inverse, in the scaled space D o B o D^-1:
    fields with an inverse use it, ``identity_fields`` use -I, the rest
    pass through."""
    def apply(r):
        out = {}
        for k, v in r.items():
            s = scales.get(k, 1.0)
            v = v / s
            if blockinvs.get(k) is not None:
                v = blockinvs[k](v)
            elif k in identity_fields:
                v = -v
            out[k] = v * s
        return out
    return apply


def build_forward_pc(mats: dict, topo, geom, opt: dict,
                     identity_fields=("phi",)):
    """Block preconditioner for the FORWARD linearized system dR/dW in raw
    residual form (forward_total_derivative wraps it in the scale
    adapters). The same per-equation blocks as build_pc, untransposed;
    pcFwdInnerIters defaults to 2x pcInnerIters (at least 30), because
    BiCGStab's best-so-far on convection-dominated blocks can stay at the
    zero start for ~20 iterations, which makes a block a silent no-op."""
    pctype = opt.get("pcType", "segregated")
    iters = int(opt.get("pcFwdInnerIters",
                        max(30, 2 * int(opt.get("pcInnerIters", 15)))))
    blockinvs = {}
    for k, (m, sym) in mats.items():
        sv = None
        if pctype in ("coupledLine", "lineJacobi"):
            sv = line_solver_F(m, topo, geom,
                               adi_sweeps=int(opt.get("pcADISweeps", 1)))
        blockinvs[k] = sv or _block_F(m, topo, geom.vol, sym, iters)
    return _block_map(blockinvs, {}, identity_fields)


def make_coupled_pc(blockinvs: dict, state_scales=None, sweeps=2,
                    identity_fields=("phi",)):
    """Coupled block-Gauss-Seidel preconditioner FACTORY.

    The returned factory receives the scaled operator matT that FGMRES
    applies (one residual vjp per call) and returns

        psi   = Binv(r)
        psi  += Binv(r - matT psi)     (sweeps-1 times)

    with Binv the per-field block inverse: the reference's fixed-point
    adjoint smoother (runFPAdj block Gauss-Seidel, DASimpleFoam.C:189) as a
    flexible-GMRES preconditioner. The factory carries ``needs_opT``.
    """
    blockapply = _block_map(blockinvs, state_scales or {}, identity_fields)

    def factory(matT):
        def pc(r):
            psi = blockapply(r)
            for _ in range(max(0, sweeps - 1)):
                rho = {k: r[k] - v for k, v in matT(psi).items()}
                upd = blockapply(rho)
                psi = {k: psi[k] + upd[k] for k in psi}
            return psi
        return pc

    factory.needs_opT = True
    return factory


def build_pc(mats: dict, topo, geom, state_scales, opt: dict,
             identity_fields=("phi",)):
    """Dispatch on adjEqnOption.pcType (the entry point solvers call):

      "segregated"  block-diagonal, pcInnerIters Krylov sweeps per block
      "lineJacobi"  block-diagonal, exact per-field line-implicit solves
      "coupledLine" line-implicit blocks + pcCoupledSweeps block-GS sweeps
                    through the full transposed Jacobian

    A line block that cannot be built (no dense-DIA layout) falls back to
    the Krylov-sweep block.
    """
    pctype = opt.get("pcType", "segregated")
    iters = int(opt.get("pcInnerIters", 15))
    if pctype in ("coupledLine", "lineJacobi"):
        blockinvs = {}
        for k, (m, sym) in mats.items():
            sv = line_solver_T(m, topo, geom,
                               adi_sweeps=int(opt.get("pcADISweeps", 1)))
            blockinvs[k] = sv or _block_T(m, topo, geom.vol, sym, iters)
        sweeps = 1 if pctype == "lineJacobi" else \
            int(opt.get("pcCoupledSweeps", 2))
        return make_coupled_pc(blockinvs, state_scales=state_scales,
                               sweeps=sweeps, identity_fields=identity_fields)
    return make_block_pc(mats, topo, geom, state_scales=state_scales,
                         iters=iters, identity_fields=identity_fields)


def make_block_pc(matrices: dict, topo, geom, state_scales=None,
                  iters=15, identity_fields=("phi",)):
    """The block-diagonal preconditioner: {state: (FvMatrix, symmetric)}
    inverted by _block_T sweeps, identity_fields by -I, the rest passed
    through; in the scaled adjoint space of adjoint_solve (the scaled
    operator is D_W A^T D_R^-1, so PC = D_R o blockinv(A^T) o D_W^-1)."""
    blockinvs = {k: _block_T(m, topo, geom.vol, sym, iters)
                 for k, (m, sym) in matrices.items()}
    return _block_map(blockinvs, state_scales or {}, identity_fields)
