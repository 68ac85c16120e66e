"""Unsteady compressible PIMPLE solver and its time-accurate adjoint
(port of ``dafoam_tpu.solvers.rho_pimple``).

Reference: DARhoPimpleFoam (src/adjoint/DASolver/DARhoPimpleFoam/,
residual DAResidualRhoPimpleFoam.C): the DARhoSimpleFoam equation set with
implicit-Euler time terms,

  momentum:   + (rho U - rho_o U_o)/dt
  energy:     + Cp (rho T - rho_o T_o)/dt
  continuity: + (psi p - psi_o p_o)/dt   (implicit in p via psi = 1/RT)

and DAPimpleFoam's time loop and reverse sweep (unpreconditioned, as in
``dafoam_tpu``). U solves run K2, the T and p solves K1.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.adjoint.unsteady import unsteady_adjoint_totals
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.solvers.pimple import DAPimpleFoam, stack_history
from dafoam_tpu_torch.solvers.rho_simple import DARhoSimpleFoam
from dafoam_tpu_torch.timeops import dfscaling


class DARhoPimpleFoam(DARhoSimpleFoam):

    def __init__(self, option, topo, points, *, device, dtype):
        super().__init__(option, topo, points, device=device, dtype=dtype)
        self.dt = float(self.option["deltaT"])
        self.n_steps = int(round(float(self.option["endTime"]) / self.dt))
        pcfg = self.option.get("pimple", {}) or {}
        self.n_outer = pcfg.get("nOuterCorrectors", 3)
        self.n_corr = pcfg.get("nCorrectors", 2)

    # -- time-term helpers -----------------------------------------------------
    def _add_ddt_U(self, M, W, W_old, inputs, geom):
        rho = self.rho_of(W, inputs)
        rho_o = self.rho_of(W_old, inputs)
        v = geom.vol[:, None]
        diag = M.diag + (rho * geom.vol / self.dt)[:, None]
        src = M.source + (rho_o[:, None] * W_old["U"]) * v / self.dt
        return M._replace(diag=diag, source=src)

    def _add_ddt_T(self, M, W, W_old, inputs, geom):
        Cp = self._thermo(inputs)[0]
        rho = self.rho_of(W, inputs)
        rho_o = self.rho_of(W_old, inputs)
        diag = M.diag + Cp * rho * geom.vol / self.dt
        src = M.source + Cp * rho_o * W_old["T"] * geom.vol / self.dt
        return M._replace(diag=diag, source=src)

    def _add_ddt_p(self, M, W, W_old, inputs, geom):
        """The mass balance ddt(rho) + div(phi) = 0 in the pEqn convention
        (contribution = lap(p) - div(phiHbyA) = 0): ddt(rho) enters with a
        minus sign, which also strengthens the negative diagonal."""
        R = self._thermo(inputs)[1]
        psi = 1.0 / (R * W["T"])
        psi_o = 1.0 / (R * W_old["T"])
        diag = M.diag - psi * geom.vol / self.dt
        src = M.source - psi_o * W_old["p"] * geom.vol / self.dt
        return M._replace(diag=diag, source=src)

    # -- residual ----------------------------------------------------------------
    def residuals_unsteady(self, W, W_old, W_oldold, inputs, n=None):
        """The normalized residual of one implicit-Euler step (``n`` and
        ``W_oldold`` are unused: no time-dependent term reads them)."""
        geom = self.geometry(inputs)
        topo = self.topo
        U, p, T, phi = W["U"], W["p"], W["T"], W["phi"]
        UEqn, U_bco = self._ueqn(W, inputs, geom)
        UEqn = self._add_ddt_U(UEqn, W, W_old, inputs, geom)
        p_b = bc.boundary_value(self._bco("p", p, inputs, geom, phi, 0), p,
                                topo)
        r_U = fvx.residual(UEqn, U, geom, topo) \
            + fvc.grad(geom, topo, p, p_b)
        _, _, _, _, pM, _, flux_fn = self._projection(W, inputs, geom, UEqn,
                                                      U_bco, U)
        pM = self._add_ddt_p(pM, W, W_old, inputs, geom)
        TEqn, _ = self._teqn(W, inputs, geom)
        TEqn = self._add_ddt_T(TEqn, W, W_old, inputs, geom)
        out = {"U": r_U, "p": fvx.residual(pM, p, geom, topo),
               "T": fvx.residual(TEqn, T, geom, topo),
               "phi": flux_fn(p) - phi}
        return self._apply_res_norm(out, geom)

    # -- one time step -----------------------------------------------------------
    def _step(self, state_old, inputs, geom):
        lin = self.option["primalLinearSolver"]
        topo = self.topo
        st = state_old
        for _ in range(self.n_outer):
            UEqn, U_bco = self._ueqn(st, inputs, geom)
            UEqn = self._add_ddt_U(UEqn, st, state_old, inputs, geom)
            p = st["p"]
            p_b = bc.boundary_value(self._bco("p", p, inputs, geom,
                                              st["phi"], 0), p, topo)
            rhs_U = -fvc.grad(geom, topo, p, p_b) * geom.vol[:, None]
            U_pred, info = fvsolve.solve(UEqn, st["U"], topo,
                                         symmetric=False,
                                         rel_tol=lin["uRelTol"],
                                         max_iters=lin["uMaxIters"],
                                         rhs=rhs_U)
            self._log_solve("U", info)
            st = dict(st, U=self._bound("U", U_pred))

            TEqn, _ = self._teqn(st, inputs, geom)
            TEqn = self._add_ddt_T(TEqn, st, state_old, inputs, geom)
            T_new, info = fvsolve.solve(TEqn, st["T"], topo, symmetric=False,
                                        rel_tol=lin["turbRelTol"],
                                        max_iters=lin["turbMaxIters"])
            self._log_solve("T", info)
            st = dict(st, T=self._bound("T", T_new))

            for _ in range(self.n_corr):
                rAU, _, HbyA, _, pM, _, flux_fn = self._projection(
                    st, inputs, geom, UEqn, U_bco, st["U"])
                pM = self._add_ddt_p(pM, st, state_old, inputs, geom)
                p_new, info = fvsolve.solve(pM, st["p"], topo,
                                            symmetric=not self.transonic,
                                            rel_tol=lin["pRelTol"],
                                            max_iters=lin["pMaxIters"])
                self._log_solve("p", info)
                p_new = self._bound("p", p_new)
                phi_new = flux_fn(p_new)
                p_b3 = bc.boundary_value(self._bco("p", p_new, inputs, geom,
                                                   phi_new, 0), p_new, topo)
                U_new = self._bound("U", HbyA - rAU[:, None] * fvc.grad(
                    geom, topo, p_new, p_b3))
                st = dict(st, U=U_new, p=p_new, phi=phi_new)
        return st

    # -- time loop (DAPimpleFoam's structure) -------------------------------------
    def solve_primal_history(self, state0, inputs):
        geom = self.geometry(inputs)
        states = [state0]
        for _ in range(self.n_steps):
            states.append(self._step(states[-1], inputs, geom))
        return states[-1], stack_history(states)

    solve_primal = DAPimpleFoam.solve_primal
    eval_function_history = DAPimpleFoam.eval_function_history

    def solve_unsteady_adjoint(self, hist, inputs, func_name):
        """(totals, per-step adjoint residuals), unpreconditioned."""
        cfg = self.option["function"][func_name]
        with torch.no_grad():
            _, vals = self.eval_function_history(func_name, hist, inputs)
        weights = dfscaling(vals, cfg.get("timeOp", "final"), cfg)
        scales = self._scales(inputs)
        opt = self.option["adjEqnOption"]
        return unsteady_adjoint_totals(
            self.residuals_unsteady,
            lambda W, x, n: self.eval_function(func_name, W, x),
            hist, inputs, weights, ddt_order=1,
            state_scales=scales, res_scales=scales,
            restart=opt["gmresRestart"], rel_tol=opt["gmresRelTol"],
            abs_tol=opt["gmresAbsTol"], max_iters=opt["gmresMaxIters"],
            log=lambda info: self._log_solve("adjoint", info))
