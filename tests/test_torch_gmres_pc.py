"""FGMRES when the preconditioner fails (dafoam_tpu_torch only, CPU, f64).

The segregated PC of the scalar-transport adjoints is 15 Jacobi-BiCGStab
sweeps per block. On a right-hand side close to a constant field
(dJ/dT of a volume sum) BiCGStab's best-so-far iterate can stay at its
zero start, and the PC returns exactly 0. An FGMRES column z = 0 gives
A z = 0 and a zero Givens sine, which once read as convergence after one
iteration with a non-finite psi (0 / 0 in the back substitution). This
showed from 64x64 (steady) and 48x48 (time-spectral, 5 instances) up.
dafoam_tpu runs these two adjoints without a PC, so the cases are held
to the port's own unpreconditioned solve and to the true residual:

- gmres on a small system with a PC that returns zeros, or NaN, solves
  it as ``precond=None`` does, and reports the failed columns; an
  operator that maps the start direction to 0 ends unconverged with a
  finite x instead of a silent NaN;
- the steady DAScalarTransportFoam on a 64x64 box (variableVolSum of T,
  fixedValue 1.6 inlet) with the default options: psi finite, its true
  residual meets the GMRES bar, and the totals equal the
  ``pcType: "none"`` run's at 1e-8;
- DATimeSpectralScalarFoam on a 48x48 box with
  tests/test_torch_time_spectral.py's options (N = 5), at its initial
  state (the fault needs no primal sweep): psi finite and ``converged``
  as the true residual says.
"""

import numpy as np
import pytest
import torch

from dafoam_tpu_torch.adjoint import solver as adjsolver
from dafoam_tpu_torch.linalg.krylov import gmres, tnorm
from dafoam_tpu_torch.mesh import box_hex_mesh
from dafoam_tpu_torch.solvers import make_solver
from dafoam_tpu_torch.utils import tree
from test_torch_cases import assert_close
from test_torch_time_spectral import ts_options

torch.set_num_threads(1)
F64 = torch.float64
BOX = (1.0, 0.6, 0.1)
KINDS = {"zmin": "empty", "zmax": "empty"}
ZERO_GRAD = {"type": "zeroGradient"}


def _system(n=40, seed=0):
    rng = np.random.default_rng(seed)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n)) / np.sqrt(n)
    b = rng.standard_normal(n)
    return torch.tensor(A, dtype=F64), torch.tensor(b, dtype=F64)


@pytest.mark.parametrize("pc", ["zeros", "nan", "singular"])
def test_gmres_survives_a_failed_preconditioner(pc):
    A, b = _system()
    x_ref, info_ref = gmres(lambda v: A @ v, b, restart=60, rel_tol=1e-12)
    assert info_ref.converged and info_ref.pc_failed == 0
    if pc == "singular":
        # A z = 0 for the first direction: a zero pivot, not convergence
        x, info = gmres(lambda v: torch.zeros_like(v), b, restart=60,
                        rel_tol=1e-12)
        assert not info.converged and info.iters == 0
        assert bool(torch.isfinite(x).all())
        return
    fill = 0.0 if pc == "zeros" else float("nan")
    x, info = gmres(lambda v: A @ v, b, restart=60, rel_tol=1e-12,
                    precond=lambda v: torch.full_like(v, fill))
    assert info.converged and info.iters == info_ref.iters
    assert info.pc_failed == info.iters
    assert float(torch.linalg.norm(A @ x - b)) <= 1e-12 * float(
        torch.linalg.norm(b))
    assert_close(x.numpy(), x_ref.numpy(), 1e-12, "x")


def _true_resid(s, st, x, func, psi):
    """||S (dR/dW^T psi - dJ/dW)||: psi's residual in the normalizeStates
    metric that the adjoint's GMRES runs in, and ||S dJ/dW||."""
    scales = s._scales(x)
    dJdW = adjsolver.dJdW_of(lambda w, xx: s.eval_function(func, w, xx),
                             st, x)
    _, f_vjp = adjsolver.vjp(lambda w: s._norm_residuals(w, x), st)
    res = tree.tmap(torch.sub, adjsolver._scale(f_vjp(psi), scales),
                    adjsolver._scale(dJdW, scales))
    return float(tnorm(res)), float(tnorm(adjsolver._scale(dJdW, scales)))


def _finite(t):
    return all(bool(torch.isfinite(v).all()) for v in tree.leaves(t))


def _scalar(n, rel_tol, **over):
    opts = {
        "solverName": "DAScalarTransportFoam",
        "ddtScheme": "steadyState",
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {"T": {
            "xmin": {"type": "fixedValue", "value": 1.6}, "xmax": ZERO_GRAD,
            "ymin": ZERO_GRAD, "ymax": ZERO_GRAD}},
        "initialFields": {"T": 1.0},
        "function": {"TMean": {"type": "variableVolSum", "varName": "T",
                               "scale": 1.0}},
        "normalizeStates": {"T": 1.0},
        "adjEqnOption": {"gmresRelTol": rel_tol, "gmresAbsTol": 1e-30},
        "meshFaceLayout": "canonical",
    }
    opts.update(over)
    pts, topo = box_hex_mesh(n, n, 1, BOX, kinds=KINDS)
    s = make_solver(opts, topo, pts, device="cpu", dtype=F64)
    x = s.make_inputs()
    x["params"]["U"] = s._tensor([0.4, 0.0, 0.0]).expand(
        s.topo.n_cells, 3).contiguous()
    return s, x


def test_scalar_adjoint_with_the_default_pc():
    rel = 1e-11
    s, x = _scalar(64, rel)
    assert s.option["adjEqnOption"]["pcType"] == "segregated"
    st, info = s.run_primal(s.init_state(), x)
    assert info.converged
    psi, ai = s.solve_adjoint(st, x, "TMean")
    assert _finite(psi) and ai.converged and ai.pc_failed >= 1
    true, bn = _true_resid(s, st, x, "TMean", psi)
    assert true <= rel * bn, (true, rel * bn, ai)
    tot = s.total_derivative(st, x, "TMean", psi)

    s0, _ = _scalar(64, rel, adjEqnOption={
        "gmresRelTol": rel, "gmresAbsTol": 1e-30, "pcType": "none"})
    psi0, ai0 = s0.solve_adjoint(st, x, "TMean")
    assert ai0.converged and ai0.pc_failed == 0
    tot0 = s0.total_derivative(st, x, "TMean", psi0)
    # one vector: T is 1.6 everywhere at this steady state, so dJ/dDT
    # and the frozen velocity's totals cancel to ~1e-15 (the inlet value's
    # and the points' do not)
    got, want = tree.leaves(tot), tree.leaves(tot0)
    assert len(got) == len(want)
    assert_close(torch.cat([g.reshape(-1) for g in got]).numpy(),
                 torch.cat([w.reshape(-1) for w in want]).numpy(), 1e-8,
                 "totals")
    assert float(tot["bc"]["T"]["xmin"]) > 0.0


def test_time_spectral_adjoint_with_the_default_pc():
    rel = 1e-8
    o = ts_options(primalMaxIters=0, adjEqnOption={
        "gmresRelTol": rel, "gmresAbsTol": 1e-30})
    pts, topo = box_hex_mesh(48, 48, 1, BOX, kinds=KINDS)
    s = make_solver(o, topo, pts, device="cpu", dtype=F64)
    assert s.option["adjEqnOption"]["pcType"] == "segregated"
    x = s.make_inputs()
    x["params"]["U"] = s._tensor([0.4, 0.0, 0.0]).expand(
        s.topo.n_cells, 3).contiguous()
    st, _ = s.run_primal(s.init_state(), x)
    psi, ai = s.solve_adjoint(st, x, "TMean")
    assert _finite(psi) and ai.pc_failed >= 1
    true, bn = _true_resid(s, st, x, "TMean", psi)
    assert ai.converged == (true <= rel * bn), (true, rel * bn, ai)
    assert ai.converged
