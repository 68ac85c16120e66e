"""Solve one FvMatrix equation (the primal's segregated sub-solves).

Port of ``dafoam_tpu.linalg.fvsolve``: symmetric systems (pressure) go to
CG, asymmetric ones (momentum, turbulence) to BiCGStab, preconditioned with
the inverse diagonal or (``pc="line"``) with ADI line solves. A symmetric
Jacobi solve of a scalar field on a banded mesh runs the device PCG
(``krylov.dia_pcg``), and so do its transpose and tangent solves. The
solve is in correction form, x = x0 + A^-1 (b - A x0), with the inner
Krylov solve started from zero and its tolerance relative to ||b - A x0||.

``solve`` is differentiable through ``_LinearSolve``, the torch
counterpart of the JAX package's ``lax.custom_linear_solve``: reverse mode
by a tight transpose solve, forward mode by one more forward solve.

Vector equations on a banded mesh run TRANSPOSED, component-major (C, nc),
so every momentum matvec is one K2 launch over all three components.

Inside ``fixed_inner()`` (the fixed-point adjoint's step map) every solve
dispatches to ``solve_fixed``: a fixed number of smoother sweeps in
defect-correction form, exactly differentiable by autograd.
"""

from __future__ import annotations

import contextlib

import torch

from dafoam_tpu_torch.adjoint.precond import transpose
from dafoam_tpu_torch.linalg import mg as mgmod
from dafoam_tpu_torch.linalg.krylov import (SolveInfo, bicgstab,
                                            bicgstab_steps, cg, cg_steps,
                                            chebyshev_steps, dia_pcg,
                                            jacobi_steps)
from dafoam_tpu_torch.linalg.lines import (apply_line_solve,
                                           build_line_solves,
                                           cell_major_matvec,
                                           line_directions, line_solver)
from dafoam_tpu_torch.ops.fvmatrix import (FvMatrix, banded, dia_bands,
                                           matvec, matvec_fn, matvec_t_fn)
from dafoam_tpu_torch.parallel.halo import active as active_halo
from dafoam_tpu_torch.utils import timing
from dafoam_tpu_torch.utils.precision import guard_tiny


def _component_major_ok(m: FvMatrix, psi0, topo) -> bool:
    """Vector (nc, C) solves run component-major on the banded mesh.

    Unlike the JAX rule, a per-component diagonal (nc, C) qualifies too:
    K2 takes it as a (C, nc) diagonal, so the momentum equation (whose
    boundary folding leaves a (nc, 3) diagonal) still reads its bands
    once for all components. The halo route keeps them cell-major."""
    return psi0.ndim == 2 and banded(topo)


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


class _Plan:
    """What one implicit solve needs besides its tensor inputs: the frozen
    matrix, its forward and transposed DIA products, the preconditioners,
    the Krylov method and its tolerances; for the device PCG instead of
    the last four, ``pcg``: ``krylov.dia_pcg``'s operands (diag, coef,
    offsets, dinv) of the symmetric matrix. ``info`` holds the forward
    solve's SolveInfo."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.info = None

    def forward_solve(self, rhs):
        return self._solve(rhs, self.mv, self.prec, self.rel_tol,
                           self.max_iters)

    def transpose_solve(self, rhs):
        return self._solve(rhs, self.mv_t, self.prec_t, self.trans_rel_tol,
                           self.trans_max_iters)

    def _solve(self, rhs, mv, prec, rel_tol, max_iters):
        if self.pcg is not None:
            return dia_pcg(*self.pcg, rhs, rel_tol=rel_tol,
                           abs_tol=self.abs_tol, max_iters=max_iters)
        return self.solver(mv, rhs, precond=prec, rel_tol=rel_tol,
                           abs_tol=self.abs_tol, max_iters=max_iters)

    def matrix_product(self, diag, lower, upper, x):
        """(diag, lower, upper) applied to x in the solve's layout."""
        mm = self.m._replace(diag=diag, lower=lower, upper=upper)
        return matvec_fn(mm, self.topo, component_major=self.cm)(x)


class _LinearSolve(torch.autograd.Function):
    """delta = A^-1 r for A = (diag, lower, upper): the rules of
    ``lax.custom_linear_solve`` in ``dafoam_tpu.linalg.fvsolve.solve``.

    - forward: the Krylov solve from zero, tolerance relative to ||r||;
    - backward: lambda = A^-T delta_bar by a TIGHT transpose solve (see
      ``solve``; transposed products through K3a, or the forward product
      for a symmetric matrix, as JAX's ``symmetric`` does); r_bar = lambda
      and the matrix cotangent -lambda (x) delta, which the banded
      matvec's reverse rule (K3b) forms;
    - jvp: delta_dot = A^-1 (r_dot - A_dot delta), one more forward solve
      (JAX's tangent solve uses the forward tolerance too).

    A loose transpose solve would leak into the fixed-point adjoint's
    totals (JAX measured pRelTol 0.05 -> 2.5e-3 gradient error).
    """

    @staticmethod
    def forward(diag, lower, upper, r, plan):
        delta, plan.info = plan.forward_solve(r)
        return delta

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plan = inputs[4]
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, ct):
        (delta,) = ctx.saved_tensors
        plan = ctx.plan
        lam, _ = plan.transpose_solve(ct.contiguous())
        need = ctx.needs_input_grad[:3]
        grads = [None, None, None]
        if any(need):
            m = plan.m
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_(n) for t, n in
                          zip((m.diag, m.lower, m.upper), need)]
                y = plan.matrix_product(*leaves, delta)
                wanted = [t for t in leaves if t.requires_grad]
                got = iter(torch.autograd.grad(y, wanted, -lam,
                                               allow_unused=True))
            grads = [next(got) if n else None for n in need]
        return (*grads, lam, None)

    @staticmethod
    def jvp(ctx, ddiag, dlower, dupper, dr, _):
        (delta,) = ctx.saved_tensors
        plan = ctx.plan
        rhs = torch.zeros_like(delta) if dr is None else dr
        if ddiag is not None or dlower is not None or dupper is not None:
            m = plan.m
            tang = [torch.zeros_like(p) if t is None else t for t, p in
                    zip((ddiag, dlower, dupper), (m.diag, m.lower, m.upper))]
            rhs = rhs - plan.matrix_product(*tang, delta)
        out, _ = plan.forward_solve(rhs.contiguous())
        return out


def solve(m: FvMatrix, psi0, topo, symmetric=False, rel_tol=1e-7,
          abs_tol=1e-50, max_iters=500, rhs=None, pc: str = "jacobi"):
    """Solve M x = source (+rhs) starting from psi0. Returns (x, SolveInfo)
    of the inner correction solve (inside ``fixed_inner``: of the fixed
    smoother, with iters = its sweep budget).

    Differentiable in M and rhs in both AD modes through the implicit
    rule of ``_LinearSolve`` (``fpInnerMode: implicit`` differentiates the
    primal step through it). The warm start stays outside the rule, in
    correction form x = x0 + A^-1 (b - A x0) with x0 detached and the
    defect b - A x0 on the live matrix: d x = A^-1 (db - dA x).

    pc="line" (primalLinearSolver.pPC) preconditions with the ADI line
    solves of ``linalg/lines.py`` and switches to BiCGStab (the sweep is
    nonsymmetric); without line directions it falls back to Jacobi.
    pc="mg" preconditions a scalar equation on a grid-form mesh with one
    geometric-multigrid V-cycle (``linalg/mg.py``, omega 1.7) of the
    detached matrix, also with BiCGStab; without a grid form it falls
    through to "line".
    Transpose solves run to rel min(rel_tol, 1e-10) within max(max_iters,
    1000) iterations.
    """
    if _FIXED_INNER:
        scale, smoother = _FIXED_INNER[-1]
        n = max(1, int(round(scale * max_iters)))
        x = solve_fixed(m, psi0, topo, symmetric=symmetric, n_iters=n,
                        rhs=rhs, smoother=smoother)
        return x, SolveInfo(n, 0.0, 0.0, True)
    return _krylov_solve(m, psi0, topo, symmetric, rel_tol, abs_tol,
                         max_iters, rhs, pc)


@timing.spanned("krylov.solve")
def _krylov_solve(m, psi0, topo, symmetric, rel_tol, abs_tol, max_iters,
                  rhs, pc):
    """The Krylov path of ``solve``."""
    if pc not in ("jacobi", "line", "mg"):
        raise ValueError(f"unknown pc {pc!r}")
    if pc != "jacobi" and active_halo(topo) is not None:
        raise ValueError(f"pPC {pc!r} needs the dense-DIA or grid layout; "
                         "the halo route runs the canonical one (use "
                         "jacobi)")
    b = m.source if rhs is None else m.source + rhs
    cm = _component_major_ok(m, psi0, topo)
    if cm:
        b = b.t().contiguous()
        # contiguous: the Krylov vectors inherit the layout of dinv
        d = m.diag[None, :] if m.diag.ndim == 1 else m.diag.t().contiguous()
        x0 = psi0.detach().t().contiguous()
    else:
        d = m.diag if m.diag.ndim == psi0.ndim else m.diag[..., None]
        x0 = psi0.detach()
    mf = m._replace(diag=m.diag.detach(), lower=m.lower.detach(),
                    upper=m.upper.detach(), source=m.source.detach())
    d = d.detach()
    td = guard_tiny(d.dtype)
    dinv = 1.0 / torch.where(torch.abs(d) > td, d, 1.0)

    def prec(r):
        return dinv * r

    prec_t = prec
    pcg = _pcg_operands(mf, psi0, topo, symmetric, pc, dinv)
    if pcg is None:
        mv = matvec_fn(mf, topo, component_major=cm)
        mv_t = mv if symmetric else matvec_t_fn(mf, topo,
                                                component_major=cm)
        solver = cg if symmetric else bicgstab
    else:
        mv = mv_t = solver = None
    if pc == "mg":
        if m.diag.ndim == 1 and psi0.ndim == 1 \
                and mgmod.grid_structure(topo) is not None:
            # one V-cycle (omega 1.7) of the frozen matrix; the transpose
            # solve gets a hierarchy of its own built on A^T
            h = mgmod.build_hierarchy(mf, topo)
            ht = mgmod.build_hierarchy(transpose(mf), topo)
            prec = lambda r: mgmod.vcycle(h, r, omega=1.7)  # noqa: E731
            prec_t = lambda r: mgmod.vcycle(ht, r, omega=1.7)  # noqa: E731
            solver = bicgstab        # the V-cycle is nonsymmetric
        else:
            pc = "line"              # no grid form: fall through to lines
    if pc == "line" and line_directions(topo):
        # the line PC works cell-major; wrap it for component-major solves
        lp = line_solver(mf, topo)
        lpt = line_solver(transpose(mf), topo,
                          matvec=cell_major_matvec(mf, topo, matvec_t_fn))
        prec = (lambda r: lp(r.t()).t().contiguous()) if cm else lp
        prec_t = (lambda r: lpt(r.t()).t().contiguous()) if cm else lpt
        solver = bicgstab

    plan = _Plan(m=mf, topo=topo, cm=cm, mv=mv, mv_t=mv_t, prec=prec,
                 prec_t=prec_t, solver=solver, pcg=pcg, rel_tol=rel_tol,
                 abs_tol=abs_tol, max_iters=max_iters,
                 trans_rel_tol=min(rel_tol, 1e-10),
                 trans_max_iters=max(max_iters, 1000))
    r = b - matvec_fn(m, topo, component_major=cm)(x0)   # live defect
    delta = _LinearSolve.apply(m.diag, m.lower, m.upper, r, plan)
    x = x0 + delta
    if cm:
        x = x.t()
    return x, plan.info


def _pcg_operands(mf, psi0, topo, symmetric, pc, dinv):
    """``krylov.dia_pcg``'s operands (diag, coef, offsets, dinv) when the
    solve can take the device PCG: a symmetric Jacobi-preconditioned solve
    of a scalar (n,) float32 or float64 field on a banded mesh, off the
    halo route; else None. A = A^T, so the transpose solves take them
    too."""
    if not (symmetric and pc == "jacobi" and psi0.ndim == 1
            and mf.diag.ndim == 1
            and mf.diag.dtype in (torch.float32, torch.float64)
            and active_halo(topo) is None):
        return None
    bands = dia_bands(mf, topo)
    if bands is None:
        return None
    offsets, coef = bands
    return mf.diag.contiguous(), coef.contiguous(), offsets, dinv


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
    with line directions (``_LineSweep``), else to "linear":
    Chebyshev on the Jacobi-preconditioned operator for symmetric
    equations, damped Jacobi otherwise. smoother="krylov": the frozen
    matrix's CG (symmetric) or BiCGStab steps with the sticky freeze of
    ``cg_steps``/``bicgstab_steps`` (stronger contraction per step, but
    its coefficient ratios depend on the defect: the freeze is what keeps
    its reverse pass finite at the rounding floor).
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
        # scalar equations only (the pressure, where the stiffness lives);
        # relaxed momentum is diagonally dominant and damped Jacobi
        # contracts it
        if x0.ndim == 1 and line_directions(topo):
            lp = _line_sweep(msg, topo)
            # one ADI sweep ~ a dozen matvec-equivalents; budget sweeps
            # against the requested smoother-iteration count
            sweeps = max(1, min(4, int(round(n_iters / 10))))
            r = b - mv(x0)           # live defect
            c = lp(r)
            for _ in range(sweeps - 1):
                c = c + lp(r - mv_f(c))
            return x0 + c
        smoother = "linear"  # vector eq / no dense-DIA layout: fall back

    if smoother == "krylov":
        # frozen-matrix CG/BiCGStab steps on the live defect
        stepper = cg_steps if symmetric else bicgstab_steps
        c = stepper(mv_f, b - mv(x0), x0=torch.zeros_like(x0),
                    precond=lambda r: dinv * r, n_steps=int(n_iters))
        x = x0 + c
        return x.t() if cm else x
    if smoother != "linear":
        raise ValueError(f"unknown fpInnerSmoother {smoother!r}")
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


class _LineSweep(torch.autograd.Function):
    """c = L r, one defect-correction ADI composition of a frozen matrix
    M over its line directions,

        L_1 = S_1,  L_n = S_n + (I - S_n M) L_{n-1}

    (S_k the exact solve of direction k's tridiagonal restriction), with
    its ALGORITHMIC transpose as the backward rule: the same algorithm on
    M^T with the direction order reversed (by induction on n), each
    tridiagonal solved by the same forward PCR. Autograd through the PCR
    recurrences is numerically unstable: JAX measured 30% vjp differences
    between op orderings on the stretched NACA O-mesh in f64. L is linear
    in r, so the jvp is L applied to the tangent."""

    @staticmethod
    def forward(r, fwd, bwd):
        return fwd(r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fwd, ctx.bwd = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, ct):
        return ctx.bwd(ct.contiguous()), None, None

    @staticmethod
    def jvp(ctx, dr, _f, _b):
        return ctx.fwd(dr.contiguous())


def _line_sweep(msg: FvMatrix, topo):
    """r -> L r of ``_LineSweep`` for the frozen scalar matrix ``msg``:
    forward defects through K1, transposed ones through K3a."""
    sv = build_line_solves(msg, topo)
    sv_t = build_line_solves(transpose(msg), topo)
    mv1 = matvec_fn(msg, topo)
    mv2 = matvec_t_fn(msg, topo)
    diag = msg.diag

    def fwd(rr):
        z = apply_line_solve(sv[0], diag, rr)
        for e in sv[1:]:
            z = z + apply_line_solve(e, diag, rr - mv1(z))
        return z

    def bwd(ct):
        z = apply_line_solve(sv_t[-1], diag, ct)
        for e in reversed(sv_t[:-1]):
            z = z + apply_line_solve(e, diag, ct - mv2(z))
        return z

    return lambda r: _LineSweep.apply(r, fwd, bwd)


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
