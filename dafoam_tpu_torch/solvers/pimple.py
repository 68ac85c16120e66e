"""Unsteady incompressible PIMPLE solver and its time-accurate adjoint
(port of ``dafoam_tpu.solvers.pimple``).

Reference: DAPimpleFoam (src/adjoint/DASolver/DAPimpleFoam/, residual
DAResidualPimpleFoam.C) and its unsteady adjoint (mphys_dafoam.py:1250,
the reverse sweep at :1390).

- primal: a Python loop over time steps; each step runs nOuterCorrectors
  outer correctors (a BiCGStab momentum predictor through K2, then
  nCorrectors Jacobi-CG pressure corrections through K1, then the
  turbulence model with its implicit Euler term). The history is stacked
  on the device with the initial condition at index 0 (the reference
  writes OpenFOAM time directories instead);
- adjoint: ``adjoint/unsteady.py``'s reverse sweep; per-step function
  values reduce by ``timeops.time_op`` (DATimeOp), whose gradient gives
  the per-step weights (dFScaling). The segregated PC's transposed block
  products run K3a.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.adjoint.precond import build_pc
from dafoam_tpu_torch.adjoint.unsteady import (
    at, unsteady_adjoint_totals, unsteady_adjoint_totals_checkpointed)
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.solvers.base import PrimalInfo
from dafoam_tpu_torch.solvers.simple import DASimpleFoam
from dafoam_tpu_torch.timeops import dfscaling, time_op


def stack_history(states: list) -> dict:
    """A list of state dicts -> one dict of (len, ...) tensors."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


class DAPimpleFoam(DASimpleFoam):

    def __init__(self, option, topo, points, *, device, dtype):
        super().__init__(option, topo, points, device=device, dtype=dtype)
        self.dt = float(self.option["deltaT"])
        self.n_steps = int(round(float(self.option["endTime"]) / self.dt))
        pcfg = self.option.get("pimple", {}) or {}
        self.n_outer = pcfg.get("nOuterCorrectors", 3)
        self.n_corr = pcfg.get("nCorrectors", 2)
        # Euler or backward (BDF2, reference ddtSchemeOrder 2)
        sch = self.option.get("ddtScheme", "Euler")
        self.ddt_scheme = "backward" if sch == "backward" else "Euler"
        self.ddt_order = 2 if self.ddt_scheme == "backward" else 1

    # -- unsteady momentum matrix (Euler/BDF2 ddt, no relaxation) ---------
    # BDF2 as a blend: ddt = ((1+b/2) W - (1+b) W1 + b/2 W2)/dt with b = 0
    # (Euler) or 1 (BDF2); OpenFOAM's 'backward' bootstraps Euler on step
    # 1, and the adjoint linearizes the same per-step scheme.
    def _ddt_blend(self, psi, psi_old, psi_oldold, geom, b):
        v = geom.vol if psi.ndim == 1 else geom.vol[:, None]
        ni = self.topo.n_internal
        diagc = (1.0 + 0.5 * b) * v / self.dt
        src = v / self.dt * ((1.0 + b) * psi_old - 0.5 * b * psi_oldold)
        return fvx.FvMatrix(diag=torch.zeros_like(psi) + diagc,
                            lower=psi.new_zeros((ni,)),
                            upper=psi.new_zeros((ni,)),
                            source=torch.zeros_like(psi) + src)

    def _ueqn_dt(self, state, W_old, inputs, geom, W_oldold=None,
                 bdf2=None):
        U, phi = state["U"], state["phi"]
        U_bco = self._bco_U(U, inputs, geom, phi)
        b = 0.0 if (W_oldold is None or self.ddt_order == 1) \
            else (1.0 if bdf2 is None else bdf2)
        Woo = W_old if W_oldold is None else W_oldold
        M = fvm.div(geom, self.topo, phi, U, U_bco,
                    scheme=self.div_u_scheme) \
            + self.turb.divdevreff(U, state, inputs, geom, U_bco) \
            + self._ddt_blend(U, W_old["U"], Woo["U"], geom, b)
        return M, U_bco

    def _model_ddt(self, W, W_old, W_oldold, k, bdf2=None):
        if self.ddt_order == 2 and W_oldold is not None:
            b = 1.0 if bdf2 is None else bdf2
            return ((1.0 + 0.5 * b) * W[k] - (1.0 + b) * W_old[k]
                    + 0.5 * b * W_oldold[k]) / self.dt
        return (W[k] - W_old[k]) / self.dt

    # -- residual R^n(W^n, W^{n-1}, W^{n-2}) ------------------------------
    def residuals_unsteady(self, W, W_old, W_oldold, inputs, n=None):
        """The normalized residual of time step ``n`` (its time n dt feeds
        the time-dependent BCs; BDF2 bootstraps Euler at n = 1)."""
        geom = self.geometry(inputs)
        topo = self.topo
        bdf2 = None
        if n is not None:
            inputs = {**inputs, "t": float(n) * self.dt}
            if self.ddt_order == 2:
                bdf2 = float(n > 1)
        U, p, phi = W["U"], W["p"], W["phi"]
        UEqn, U_bco = self._ueqn_dt(
            W, W_old, inputs, geom,
            W_oldold=W_oldold if self.ddt_order == 2 else None, bdf2=bdf2)
        p_b = bc.boundary_value(self._bco_p(p, inputs, geom, phi), p, topo)
        gradp = fvc.grad(geom, topo, p, p_b)
        r_U = fvx.residual(UEqn, U, geom, topo) + gradp
        _, rAU_f, _, phiHbyA, pM, p_bco = self._projection(
            W, inputs, geom, UEqn, U_bco, U)
        r_p = fvx.residual(pM, p, geom, topo)
        r_phi = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f, p, p_bco) \
            - phi
        out = {"U": r_U, "p": r_p, "phi": r_phi}
        if self.turb.model_states:
            U_b = bc.boundary_value(U_bco, U, topo)
            gradU = fvc.grad(geom, topo, U, U_b)
            res_t = self.turb.residuals(W, inputs, geom, phi, gradU=gradU)
            for k in self.turb.model_states:
                res_t[k] = res_t[k] + self._model_ddt(W, W_old, W_oldold, k,
                                                      bdf2=bdf2)
            out.update(res_t)
        return self._apply_res_norm(out, geom)

    # -- one time step -------------------------------------------------------
    def _step(self, state_old, inputs, geom, state_oldold=None, t=None):
        """One PIMPLE time step from ``state_old`` (BDF2 when
        ``state_oldold`` is given)."""
        lin = self.option["primalLinearSolver"]
        topo = self.topo
        if t is not None:
            inputs = {**inputs, "t": t}
        st = state_old
        for _ in range(self.n_outer):
            UEqn, U_bco = self._ueqn_dt(st, state_old, inputs, geom,
                                        W_oldold=state_oldold)
            p = st["p"]
            p_b = bc.boundary_value(self._bco_p(p, inputs, geom, st["phi"]),
                                    p, topo)
            rhs_U = -fvc.grad(geom, topo, p, p_b) * geom.vol[:, None]
            U_pred, info = fvsolve.solve(UEqn, st["U"], topo,
                                         symmetric=False,
                                         rel_tol=lin["uRelTol"],
                                         max_iters=lin["uMaxIters"],
                                         rhs=rhs_U)
            self._log_solve("U", info)
            st = dict(st, U=U_pred)
            for _ in range(self.n_corr):
                rAU, rAU_f, HbyA, phiHbyA, pM, p_bco2 = self._projection(
                    st, inputs, geom, UEqn, U_bco, st["U"])
                p_new, info = fvsolve.solve(pM, st["p"], topo,
                                            symmetric=True,
                                            rel_tol=lin["pRelTol"],
                                            max_iters=lin["pMaxIters"])
                self._log_solve("p", info)
                phi_new = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f,
                                                       p_new, p_bco2)
                p_b2 = bc.boundary_value(
                    self._bco_p(p_new, inputs, geom, phi_new), p_new, topo)
                U_new = HbyA - rAU[:, None] * fvc.grad(geom, topo, p_new,
                                                       p_b2)
                st = dict(st, U=U_new, p=p_new, phi=phi_new)
            if self.turb.model_states:
                U_b = bc.boundary_value(
                    self._bco_U(st["U"], inputs, geom, st["phi"]), st["U"],
                    topo)
                gradU = fvc.grad(geom, topo, st["U"], U_b)
                # BDF2 as an equivalent Euler step:
                # (1.5 W - 2 W1 + .5 W2)/dt = (W - (4 W1 - W2)/3)/(dt/1.5)
                if state_oldold is None:
                    dt_t, old_t = self.dt, state_old
                else:
                    dt_t = self.dt / 1.5
                    old_t = {k: (4.0 * a - state_oldold[k]) / 3.0
                             for k, a in state_old.items()}
                st = self.turb.correct(st, inputs, geom, st["phi"],
                                       gradU=gradU,
                                       rel_tol=lin["turbRelTol"],
                                       max_iters=lin["turbMaxIters"],
                                       relax=1.0, dt=dt_t, old=old_t)
                for name, inf in self.turb.last_solve_info.items():
                    self._log_solve(name, inf)
        return st

    def _advance(self, W, W_old, inputs, geom, n):
        """Time step n from W (BDF2 with W_old from step 2 on)."""
        if self.ddt_order == 2 and n > 1:
            return self._step(W, inputs, geom, state_oldold=W_old,
                              t=float(n) * self.dt)
        return self._step(W, inputs, geom, t=float(n) * self.dt)

    # -- time loop -------------------------------------------------------------
    def solve_primal_history(self, state0, inputs):
        """(final state, the history stacked (T+1, ...) with the initial
        condition at index 0). BDF2 takes an Euler step first."""
        geom = self.geometry(inputs)
        states = [state0]
        for n in range(1, self.n_steps + 1):
            states.append(self._advance(states[-1], states[max(n - 2, 0)],
                                        inputs, geom, n))
        return states[-1], stack_history(states)

    def solve_primal_checkpoints(self, state0, inputs, seg_len):
        """Forward pass that keeps only checkpoint triples (the states at
        steps s L, s L - 1, s L - 2, clipped at 0) and every step's function
        values: the memory side of the checkpoint/recompute reverse sweep
        (the reference writes every step to disk, DASolver.C:3193).

        Returns (stT, checkpoints stacked (n_seg+1, 3, ...), {function:
        (T,) values})."""
        if self.n_steps % seg_len:
            raise ValueError("endTime/deltaT must be a multiple of seg_len")
        geom = self.geometry(inputs)
        fnames = list(self.option["function"].keys())
        recent = [state0, state0, state0]      # steps n, n-1, n-2
        cks = [stack_history(recent)]
        vals = {f: [] for f in fnames}
        for n in range(1, self.n_steps + 1):
            st = self._advance(recent[0], recent[1], inputs, geom, n)
            recent = [st] + recent[:2]
            for f in fnames:
                vals[f].append(self.eval_function(f, st, inputs))
            if n % seg_len == 0:
                cks.append(stack_history(recent))
        func_vals = {f: torch.stack(v) for f, v in vals.items()}
        return recent[0], stack_history(cks), func_vals

    def solve_primal(self, state, inputs):
        stT, hist = self.solve_primal_history(state, inputs)
        ok = self.states_valid(stT)
        W_old = at(hist, -2)
        res = self.residuals_unsteady(stT, W_old, W_old, inputs,
                                      n=self.n_steps)
        mx = float(torch.stack([torch.max(torch.abs(v))
                                for v in res.values()]).max())
        return stT, PrimalInfo(self.n_steps, mx, ok, not ok)

    # -- unsteady functions ------------------------------------------------------
    def eval_function_history(self, name, hist, inputs):
        """(time_op of the per-step values, the (T,) values of steps
        1..T)."""
        cfg = self.option["function"][name]
        vals = torch.stack([self.eval_function(name, at(hist, n), inputs)
                            for n in range(1, self.n_steps + 1)])
        return time_op(vals, cfg.get("timeOp", "final"), cfg), vals

    # -- unsteady adjoint preconditioner (segregated, amortized) ------------
    def unsteady_pc_assemble(self, W, W1, W2, inputs, n=None):
        """The per-equation operators linearized at step n (PC matrices
        only; rebuilt every unsteadyAdjoint.PCMatUpdateInterval reverse
        steps, the reference's PCMatPrecomputeInterval). ``n`` matters
        only where the operators depend on the step (a moving mesh)."""
        with torch.no_grad():
            geom = self.geometry(inputs)
            UEqn, U_bco = self._ueqn_dt(
                W, W1, inputs, geom,
                W_oldold=W2 if self.ddt_order == 2 else None)
            pM = self._projection(W, inputs, geom, UEqn, U_bco, W["U"])[4]
            mats = {"U": UEqn, "p": pM}
            if self.turb.model_states:
                U_b = bc.boundary_value(U_bco, W["U"], self.topo)
                gradU = fvc.grad(geom, self.topo, W["U"], U_b)
                for k, (m, _sym) in self.turb.pc_matrices(
                        W, inputs, geom, W["phi"], gradU).items():
                    mats[k] = m + fvm.ddt(geom, self.topo, W[k], W1[k],
                                          self.dt)
        return mats

    def _unsteady_pc_apply_fn(self, inputs):
        """mats -> the preconditioner of one reverse step. The sweep
        rebuilds the PC per assembly and has no standing transposed
        operator, so the coupled variant is clamped to its block-diagonal
        line-implicit form."""
        with torch.no_grad():
            geom = self.geometry(inputs)
            scales = self.state_scales(geom)
        opt = dict(self.option["adjEqnOption"])
        if opt.get("pcType") == "coupledLine":
            opt["pcType"] = "lineJacobi"

        def build(mats):
            pc = build_pc({k: (m, k == "p") for k, m in mats.items()},
                          self.topo, geom, scales, opt)
            if getattr(pc, "needs_opT", False):
                pc = pc(None)    # one sweep: the operator is never used
            return pc

        return build

    def _unsteady_adj_cfg(self, inputs, func_name, vals):
        cfg = self.option["function"][func_name]
        weights = dfscaling(vals, cfg.get("timeOp", "final"), cfg)
        with torch.no_grad():
            scales = self.state_scales(self.geometry(inputs))
        opt = self.option["adjEqnOption"]
        pc_assemble = None
        if opt.get("pcType", "none") not in ("none", None):
            build = self._unsteady_pc_apply_fn(inputs)

            def pc_assemble(W, W1, W2, x, n):
                return build(self.unsteady_pc_assemble(W, W1, W2, x, n))
        pc_interval = int(self.option["unsteadyAdjoint"]
                          .get("PCMatUpdateInterval", 1))
        return weights, scales, opt, pc_assemble, pc_interval

    def _sweep_kw(self, inputs, func_name, vals):
        weights, scales, opt, pc_assemble, pc_interval = \
            self._unsteady_adj_cfg(inputs, func_name, vals)
        return dict(inputs=inputs, weights=weights,
                    ddt_order=self.ddt_order, state_scales=scales,
                    res_scales=scales, restart=opt["gmresRestart"],
                    rel_tol=opt["gmresRelTol"], abs_tol=opt["gmresAbsTol"],
                    max_iters=opt["gmresMaxIters"], pc_assemble=pc_assemble,
                    pc_interval=pc_interval,
                    log=lambda info: self._log_solve("adjoint", info))

    def solve_unsteady_adjoint(self, hist, inputs, func_name):
        """Total derivatives of the time-reduced function w.r.t. inputs:
        (totals, the per-step adjoint residuals, step T first)."""
        with torch.no_grad():
            _, vals = self.eval_function_history(func_name, hist, inputs)
        return unsteady_adjoint_totals(
            self.residuals_unsteady,
            lambda W, x, n: self.eval_function(func_name, W, x),
            hist, **self._sweep_kw(inputs, func_name, vals))

    def solve_unsteady_adjoint_checkpointed(self, state0, inputs,
                                            func_name, seg_len):
        """The long-history unsteady adjoint: checkpoint/recompute
        reverse sweep, memory O(seg_len + T/seg_len) states instead of
        O(T). Returns (totals, resids, J)."""
        if self.ddt_order == 2:
            raise NotImplementedError(
                "checkpointed sweep currently supports ddt_order=1 "
                "(Euler); use the in-memory sweep for BDF2")
        with torch.no_grad():
            _, checkpoints, func_vals = self.solve_primal_checkpoints(
                state0, inputs, seg_len)
            geom = self.geometry(inputs)
        vals = func_vals[func_name]
        cfg = self.option["function"][func_name]
        J = time_op(vals, cfg.get("timeOp", "final"), cfg)
        totals, resids = unsteady_adjoint_totals_checkpointed(
            lambda W, x, n: self._step(W, x, geom, t=float(n) * self.dt),
            self.residuals_unsteady,
            lambda W, x, n: self.eval_function(func_name, W, x),
            checkpoints, seg_len, self.n_steps,
            **self._sweep_kw(inputs, func_name, vals))
        return totals, resids, float(J)
