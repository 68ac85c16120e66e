"""Implicit Runge-Kutta (Radau IIA, two stages) PIMPLE (port of
``dafoam_tpu.solvers.irk_pimple``).

Reference: DAIrkPimpleFoam (src/adjoint/DASolver/DAIrkPimpleFoam/
DAIrkPimpleFoam.C). The Radau23 collocation scheme through its
differentiation matrix,

    stage 1 (t + dt/3):  (D10 W^n + D11 W1 + D12 W2)/dt + N(W1) = 0
    stage 2 (t + dt):    (D20 W^n + D21 W1 + D22 W2)/dt + N(W2) = 0,

D1 = (-2, 3/2, 1/2), D2 = (2, -9/2, 5/2) (DAIrkPimpleFoam.C:42-50): third
order and L-stable.

- primal: maxSweeps Gauss-Seidel sweeps per time step over the two
  stages; each stage solve is a relaxed BiCGStab momentum predictor (K2),
  nCorrectors Jacobi-CG pressure corrections (K1) and the turbulence
  model's implicit step with the collocation ddt written as an Euler step
  (dt/dkk, old = -rate dt/dkk);
- adjoint: the stage-1 fields are registered states (U1, p1, phi1 and the
  model's fields with suffix 1) beside the end-of-step fields, so one
  per-step residual holds both collocation rows, and the parent's reverse
  sweep (``adjoint/unsteady.py``) linearizes the coupled stages. Each step
  reads W^n only (ddt_order 1). The segregated PC has one block per field
  of each stage; its transposed products run K3a.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.adjoint.precond import build_pc
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.solvers.pimple import DAPimpleFoam
from dafoam_tpu_torch.states import StateInfo, StateLayout


class DAIrkPimpleFoam(DAPimpleFoam):

    # Radau IIA(2,3) differentiation-matrix rows (c = (1/3, 1))
    D1 = (-2.0, 1.5, 0.5)
    D2 = (2.0, -4.5, 2.5)

    def __init__(self, option, topo, points, *, device, dtype):
        super().__init__(option, topo, points, device=device, dtype=dtype)
        if self.has_T:
            raise NotImplementedError("DAIrkPimpleFoam: passive T transport "
                                      "is not supported (as the reference)")
        si = self.state_info
        self._base_states = ("U", "p", "phi") + tuple(si.model)
        self.state_info = StateInfo(
            vol_vector=("U", "U1"),
            vol_scalar=("p", "p1"),
            model=si.model + tuple(k + "1" for k in si.model),
            surface_scalar=("phi", "phi1"))
        self.layout = StateLayout(
            self.state_info, topo.n_cells, topo.n_faces,
            ordering=self.option.get("adjStateOrdering", "state"))
        irk = self.option.get("irk", {}) or {}
        self.max_sweeps = int(irk.get("maxSweeps", 4))
        self.relax_ueqn = float(irk.get("relaxUEqn", 1.0))
        # IRK collocation: each step depends on W^n only
        self.ddt_scheme, self.ddt_order = "IRK", 1

    # ------------------------------------------------------------------
    # stage helpers
    # ------------------------------------------------------------------
    def _stage_view(self, W, s):
        suf = "1" if s == 1 else ""
        return {k: W[k + suf] for k in self._base_states}

    def _stage_coeffs(self, s):
        """(d0, own-stage dkk, other-stage coefficient) of stage s."""
        d0, d1, d2 = self.D1 if s == 1 else self.D2
        return (d0, d1, d2) if s == 1 else (d0, d2, d1)

    def _irk_ddt_matrix(self, psi, dkk, rate, geom):
        """The collocation ddt as an FvMatrix (diag dkk/dt V, source
        -rate V): its residual row is dkk psi/dt + rate per volume."""
        v = geom.vol if psi.ndim == 1 else geom.vol[:, None]
        ni = self.topo.n_internal
        return fvx.FvMatrix(diag=torch.zeros_like(psi) + dkk / self.dt * v,
                            lower=psi.new_zeros((ni,)),
                            upper=psi.new_zeros((ni,)),
                            source=torch.zeros_like(psi) - rate * v)

    def _stage_ueqn(self, Wst, dkk, rate_U, inputs, geom):
        U, phi = Wst["U"], Wst["phi"]
        U_bco = self._bco_U(U, inputs, geom, phi)
        M = fvm.div(geom, self.topo, phi, U, U_bco,
                    scheme=self.div_u_scheme) \
            + self.turb.divdevreff(U, Wst, inputs, geom, U_bco) \
            + self._irk_ddt_matrix(U, dkk, rate_U, geom)
        return M, U_bco

    # ------------------------------------------------------------------
    # residuals: both collocation rows in one dict
    # ------------------------------------------------------------------
    def residuals_unsteady(self, W, W_old, W_oldold, inputs, n=None):
        if n is not None:
            inputs = {**inputs, "t": float(n) * self.dt}
        geom = self.geometry(inputs)
        topo = self.topo
        views = {1: self._stage_view(W, 1), 2: self._stage_view(W, 2)}
        out = {}
        for s in (1, 2):
            suf = "1" if s == 1 else ""
            d0, dkk, doth = self._stage_coeffs(s)
            Wst, Woth = views[s], views[3 - s]

            def rate(k, d0=d0, doth=doth, Woth=Woth):
                return (d0 * W_old[k] + doth * Woth[k]) / self.dt

            U, p, phi = Wst["U"], Wst["p"], Wst["phi"]
            UEqn, U_bco = self._stage_ueqn(Wst, dkk, rate("U"), inputs,
                                           geom)
            p_b = bc.boundary_value(self._bco_p(p, inputs, geom, phi), p,
                                    topo)
            out["U" + suf] = fvx.residual(UEqn, U, geom, topo) \
                + fvc.grad(geom, topo, p, p_b)
            _, rAU_f, _, phiHbyA, pM, p_bco = self._projection(
                Wst, inputs, geom, UEqn, U_bco, U)
            out["p" + suf] = fvx.residual(pM, p, geom, topo)
            out["phi" + suf] = phiHbyA \
                - fvm.laplacian_flux(geom, topo, rAU_f, p, p_bco) - phi
            if self.turb.model_states:
                U_b = bc.boundary_value(U_bco, U, topo)
                gradU = fvc.grad(geom, topo, U, U_b)
                res_t = self.turb.residuals(Wst, inputs, geom, phi,
                                            gradU=gradU)
                for k in self.turb.model_states:
                    out[k + suf] = res_t[k] + dkk * Wst[k] / self.dt \
                        + rate(k)
        return self._apply_res_norm(out, geom)

    def _apply_res_norm(self, res, geom):
        """Stage rows take their base row's normalization."""
        base = {k: v for k, v in res.items() if not k.endswith("1")}
        stage = {k[:-1]: v for k, v in res.items() if k.endswith("1")}
        out = dict(super()._apply_res_norm(base, geom))
        for k, v in super()._apply_res_norm(stage, geom).items():
            out[k + "1"] = v
        return out

    def state_scales(self, geom):
        out = super().state_scales(geom)
        ns = self.option["normalizeStates"]
        for k in list(out):
            if k.endswith("1") and k[:-1] in out and k not in ns:
                out[k] = out[k[:-1]]
        return out

    def init_state(self):
        st = super().init_state()
        for k in self._base_states:
            st[k + "1"] = st[k]
        return st

    # ------------------------------------------------------------------
    # primal: Gauss-Seidel sweeps of SIMPLE-style stage solves
    # ------------------------------------------------------------------
    def _stage_solve(self, s, st, state_old, inputs, geom, lin):
        suf = "1" if s == 1 else ""
        oth = "" if s == 1 else "1"
        d0, dkk, doth = self._stage_coeffs(s)
        Wst = self._stage_view(st, s)
        topo = self.topo

        def rate(k):
            return (d0 * state_old[k] + doth * st[k + oth]) / self.dt

        M, U_bco = self._stage_ueqn(Wst, dkk, rate("U"), inputs, geom)
        M = fvx.relax(M, Wst["U"], self.relax_ueqn, topo)
        p_b = bc.boundary_value(
            self._bco_p(Wst["p"], inputs, geom, Wst["phi"]), Wst["p"], topo)
        rhs_U = -fvc.grad(geom, topo, Wst["p"], p_b) * geom.vol[:, None]
        U_pred, info = fvsolve.solve(M, Wst["U"], topo, symmetric=False,
                                     rel_tol=lin["uRelTol"],
                                     max_iters=lin["uMaxIters"], rhs=rhs_U)
        self._log_solve("U", info)
        Wst = dict(Wst, U=U_pred)
        for _ in range(self.n_corr):
            rAU, rAU_f, HbyA, phiHbyA, pM, p_bco2 = self._projection(
                Wst, inputs, geom, M, U_bco, Wst["U"])
            p_new, info = fvsolve.solve(pM, Wst["p"], topo, symmetric=True,
                                        rel_tol=lin["pRelTol"],
                                        max_iters=lin["pMaxIters"])
            self._log_solve("p", info)
            phi_new = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f, p_new,
                                                   p_bco2)
            p_b2 = bc.boundary_value(
                self._bco_p(p_new, inputs, geom, phi_new), p_new, topo)
            U_new = HbyA - rAU[:, None] * fvc.grad(geom, topo, p_new, p_b2)
            Wst = dict(Wst, U=U_new, p=p_new, phi=phi_new)
        if self.turb.model_states:
            U_b = bc.boundary_value(
                self._bco_U(Wst["U"], inputs, geom, Wst["phi"]), Wst["U"],
                topo)
            gradU = fvc.grad(geom, topo, Wst["U"], U_b)
            # collocation ddt as an Euler step:
            # dkk/dt (psi - (-rate dt/dkk)) == dkk psi/dt + rate
            dt_eff = self.dt / dkk
            old_eff = {k: -rate(k) * dt_eff for k in self.turb.model_states}
            Wst = self.turb.correct(Wst, inputs, geom, Wst["phi"],
                                    gradU=gradU, rel_tol=lin["turbRelTol"],
                                    max_iters=lin["turbMaxIters"],
                                    relax=1.0, dt=dt_eff, old=old_eff)
            for name, inf in self.turb.last_solve_info.items():
                self._log_solve(name, inf)
        return {**st, **{k + suf: Wst[k] for k in self._base_states}}

    def _step(self, state_old, inputs, geom, state_oldold=None, t=None):
        if t is not None:
            inputs = {**inputs, "t": t}
        lin = self.option["primalLinearSolver"]
        st = state_old
        for _ in range(self.max_sweeps):
            st = self._stage_solve(1, st, state_old, inputs, geom, lin)
            st = self._stage_solve(2, st, state_old, inputs, geom, lin)
        return st

    # ------------------------------------------------------------------
    # unsteady adjoint PC: per-equation operators of both stages
    # ------------------------------------------------------------------
    def unsteady_pc_assemble(self, W, W1, W2, inputs, n=None):
        with torch.no_grad():
            geom = self.geometry(inputs)
            mats = {}
            for s in (1, 2):
                suf = "1" if s == 1 else ""
                _, dkk, _ = self._stage_coeffs(s)
                Wst = self._stage_view(W, s)
                UEqn, U_bco = self._stage_ueqn(
                    Wst, dkk, torch.zeros_like(Wst["U"]), inputs, geom)
                mats["U" + suf] = UEqn
                mats["p" + suf] = self._projection(Wst, inputs, geom, UEqn,
                                                   U_bco, Wst["U"])[4]
                if self.turb.model_states:
                    U_b = bc.boundary_value(U_bco, Wst["U"], self.topo)
                    gradU = fvc.grad(geom, self.topo, Wst["U"], U_b)
                    for k, (m, _sym) in self.turb.pc_matrices(
                            Wst, inputs, geom, Wst["phi"], gradU).items():
                        mats[k + suf] = m + fvm.ddt(
                            geom, self.topo, Wst[k], Wst[k], self.dt / dkk)
        return mats

    def _unsteady_pc_apply_fn(self, inputs):
        """mats -> the PC of one reverse step: p and p1 symmetric, phi and
        phi1 identity blocks; coupledLine clamps to lineJacobi as in the
        parent."""
        with torch.no_grad():
            geom = self.geometry(inputs)
            scales = self.state_scales(geom)
        opt = dict(self.option["adjEqnOption"])
        if opt.get("pcType") == "coupledLine":
            opt["pcType"] = "lineJacobi"

        def build(mats):
            pc = build_pc({k: (m, k in ("p", "p1")) for k, m in mats.items()},
                          self.topo, geom, scales, opt,
                          identity_fields=("phi", "phi1"))
            if getattr(pc, "needs_opT", False):
                pc = pc(None)    # one sweep: the operator is never used
            return pc

        return build
