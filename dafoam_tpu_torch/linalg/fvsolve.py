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

Inside ``fixed_inner()`` (the fixed-point adjoint's step map) every solve
dispatches to ``solve_fixed``: a fixed number of smoother sweeps in
defect-correction form, exactly differentiable by autograd.
"""

from __future__ import annotations

import contextlib

import torch

from dafoam_tpu_torch.linalg.krylov import (SolveInfo, bicgstab, cg,
                                            chebyshev_steps, jacobi_steps)
from dafoam_tpu_torch.ops.fvmatrix import FvMatrix, matvec, matvec_fn
from dafoam_tpu_torch.utils.precision import guard_tiny


def _component_major_ok(m: FvMatrix, psi0, topo) -> bool:
    """Vector (nc, C) solves run component-major on the banded mesh.

    Unlike the JAX rule, a per-component diagonal (nc, C) qualifies too:
    K2 takes it as a (C, nc) diagonal, so the momentum equation (whose
    boundary folding leaves a (nc, 3) diagonal) still reads its bands
    once for all components."""
    return psi0.ndim == 2 and topo.dia() is not None


# Scoped switch: inside fixed_inner(), every solve — in the solver's own
# step and in the turbulence model's correct() — dispatches to solve_fixed
# with n_iters = round(scale * max_iters). The fixed-point adjoint wraps
# its step map in this context.
_FIXED_INNER: list = []


@contextlib.contextmanager
def fixed_inner(scale: float = 1.0, smoother: str = "linear"):
    _FIXED_INNER.append((float(scale), str(smoother)))
    try:
        yield
    finally:
        _FIXED_INNER.pop()


def solve(m: FvMatrix, psi0, topo, symmetric=False, rel_tol=1e-7,
          abs_tol=1e-50, max_iters=500, rhs=None, pc: str = "jacobi"):
    """Solve M x = source (+rhs) starting from psi0. Returns (x, SolveInfo)
    of the inner correction solve (inside ``fixed_inner``: of the fixed
    smoother, with iters = its sweep budget)."""
    if _FIXED_INNER:
        scale, smoother = _FIXED_INNER[-1]
        n = max(1, int(round(scale * max_iters)))
        x = solve_fixed(m, psi0, topo, symmetric=symmetric, n_iters=n,
                        rhs=rhs, smoother=smoother)
        return x, SolveInfo(n, 0.0, 0.0, True)
    if pc != "jacobi":
        raise NotImplementedError(
            f"pc={pc!r} is not ported yet: the primal's line and "
            "multigrid preconditioners (linalg/lines.py, mg.mg_solver) "
            "come with the residual-form adjoint (ROADMAP.md queue 1, P3)")
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


def solve_fixed(m: FvMatrix, psi0, topo, symmetric=False, n_iters=20,
                rhs=None, smoother="linear"):
    """FIXED-ITERATION approximate solve x = x0 + C(b - A x0): the smoother
    variant of ``solve`` used by the fixed-point adjoint's step map.

    Autograd through it is the exact transpose of the map computed. At a
    converged primal any smooth approximate inverse C gives exact totals
    (the dC terms carry the defect b - A x ~ R -> 0), so C is built from
    a DETACHED copy of the matrix (frozen internal matvecs, frozen
    diagonal) while the outer defect keeps the live matrix: the reverse
    pass never differentiates the multigrid/PCR/Chebyshev coefficient
    algebra. The damped-Jacobi scan keeps the live matrix (its matrix
    dependence is plain bilinear products).

    smoother="mg": geometric-multigrid defect correction (``linalg/mg.py``)
    for scalar equations on a grid-form mesh, else falls through to
    "line": ADI line solves for scalar equations on a dense-DIA layout
    with line directions (not ported yet: raises), else to "linear":
    Chebyshev on the Jacobi-preconditioned operator for symmetric
    equations, damped Jacobi otherwise. smoother="krylov" (the frozen
    CG/BiCGStab step scans) is not ported yet and raises.
    """
    b = m.source if rhs is None else m.source + rhs
    cm = _component_major_ok(m, psi0, topo)
    if cm:
        b = b.t().contiguous()
        d = m.diag[None, :] if m.diag.ndim == 1 else m.diag.t().contiguous()
        x0 = psi0.t().contiguous()
    else:
        d = m.diag if m.diag.ndim == psi0.ndim else m.diag[..., None]
        x0 = psi0

    mv = matvec_fn(m, topo, component_major=cm)
    msg = m._replace(diag=m.diag.detach(), lower=m.lower.detach(),
                     upper=m.upper.detach())
    mv_f = matvec_fn(msg, topo, component_major=cm)
    d_f = d.detach()
    td = guard_tiny(d_f.dtype)
    dinv = 1.0 / torch.where(torch.abs(d_f) > td, d_f, 1.0)

    if smoother == "mg":
        from dafoam_tpu_torch.linalg import mg as mgmod
        if x0.ndim == 1 and mgmod.grid_structure(topo) is not None:
            h = mgmod.build_hierarchy(msg, topo)
            sweeps = max(1, min(2, int(round(n_iters / 15))))
            r = b - mv(x0)           # live defect
            c = mgmod.vcycle(h, r, omega=1.7)
            for _ in range(sweeps - 1):
                c = c + mgmod.vcycle(h, r - mv_f(c), omega=1.7)
            return x0 + c
        smoother = "line"  # no grid form: fall through to ADI lines

    if smoother == "line":
        from dafoam_tpu_torch.linalg.lines import line_directions
        if x0.ndim == 1 and line_directions(topo):
            raise NotImplementedError(
                "fpInnerSmoother 'line' (ADI line solves) is not ported yet "
                "(ROADMAP.md queue 1: linalg/lines.py)")
        smoother = "linear"  # vector eq / no dense-DIA layout: fall back

    if smoother != "linear":
        raise NotImplementedError(
            f"fpInnerSmoother {smoother!r} (cg_steps/bicgstab_steps) is not "
            "ported yet (ROADMAP.md queue 1)")
    r0 = b - mv(x0)                  # live defect
    if symmetric:
        # certain Gershgorin bound for lam(D^-1 A) of the FROZEN matrix: a
        # Chebyshev polynomial evaluated outside its target interval grows
        # like cosh(k acosh(1+eps))
        from dafoam_tpu_torch.ops.core import face_sum_pair
        row_off = face_sum_pair(torch.abs(msg.upper), torch.abs(msg.lower),
                                topo)
        dabs = torch.abs(msg.diag)
        lam_hi = 1.0 + torch.max(
            row_off / torch.clamp_min(dabs, guard_tiny(dabs.dtype)))
        x = x0 + chebyshev_steps(mv_f, dinv, r0, n_steps=int(n_iters),
                                 lam_max=1.05 * lam_hi)
    else:
        x = x0 + jacobi_steps(mv, dinv, r0, n_steps=int(n_iters))
    return x.t() if cm else x


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
