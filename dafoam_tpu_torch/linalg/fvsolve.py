"""Solve one FvMatrix equation (the primal's segregated sub-solves).

Port of ``dafoam_tpu.linalg.fvsolve.solve`` with the Jacobi
preconditioner: symmetric systems (pressure) go to CG, asymmetric ones
(momentum, turbulence) to BiCGStab, both preconditioned with the inverse
diagonal. The solve is in correction form, x = x0 + A^-1 (b - A x0), with
the inner Krylov solve started from zero and its tolerance relative to
||b - A x0|| — the same iterates as the JAX package's
``custom_linear_solve`` wrapper.

Vector equations on a banded mesh run TRANSPOSED, component-major (C, nc),
so every momentum matvec is one K2 launch over all three components.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.linalg.krylov import bicgstab, cg
from dafoam_tpu_torch.ops.fvmatrix import FvMatrix, matvec, matvec_fn
from dafoam_tpu_torch.utils.precision import guard_tiny


def _component_major_ok(m: FvMatrix, psi0, topo) -> bool:
    """Vector (nc, C) solves run component-major on the banded mesh.

    Unlike the JAX rule, a per-component diagonal (nc, C) qualifies too:
    K2 takes it as a (C, nc) diagonal, so the momentum equation (whose
    boundary folding leaves a (nc, 3) diagonal) still reads its bands
    once for all components."""
    return psi0.ndim == 2 and topo.dia() is not None


def solve(m: FvMatrix, psi0, topo, symmetric=False, rel_tol=1e-7,
          abs_tol=1e-50, max_iters=500, rhs=None, pc: str = "jacobi"):
    """Solve M x = source (+rhs) starting from psi0. Returns (x, SolveInfo)
    of the inner correction solve."""
    if pc != "jacobi":
        raise NotImplementedError(
            f"pc={pc!r} is not ported yet: the line and multigrid "
            "preconditioners arrive with the adjoint slice "
            "(ROADMAP.md queue 1, P3)")
    b = m.source if rhs is None else m.source + rhs
    cm = _component_major_ok(m, psi0, topo)
    if cm:
        b = b.t().contiguous()
        # contiguous: the Krylov vectors inherit the layout of dinv
        d = m.diag[None, :] if m.diag.ndim == 1 else m.diag.t().contiguous()
        x0 = psi0.t().contiguous()
    else:
        d = m.diag if m.diag.ndim == psi0.ndim else m.diag[..., None]
        x0 = psi0
    td = guard_tiny(d.dtype)
    dinv = 1.0 / torch.where(torch.abs(d) > td, d, 1.0)
    mv = matvec_fn(m, topo, component_major=cm)

    def prec(r):
        return dinv * r

    solver = cg if symmetric else bicgstab
    delta, info = solver(mv, b - mv(x0), precond=prec, rel_tol=rel_tol,
                         abs_tol=abs_tol, max_iters=max_iters)
    x = x0 + delta
    if cm:
        x = x.t()
    return x, info


def initial_residual_norm(m: FvMatrix, psi, topo, rhs=None):
    """OpenFOAM-style normalized initial residual (for convergence control,
    reference DAUtility::primalResidualControl)."""
    b = m.source if rhs is None else m.source + rhs
    ax = matvec(m, psi, topo)
    xbar = torch.mean(psi, dim=0, keepdim=True)
    axbar = matvec(m, torch.broadcast_to(xbar, psi.shape), topo)
    norm = torch.sum(torch.abs(ax - axbar)) + torch.sum(torch.abs(b - axbar))
    return torch.sum(torch.abs(b - ax)) / torch.clamp_min(
        norm, guard_tiny(norm.dtype))
