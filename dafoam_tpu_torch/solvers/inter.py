"""Two-phase VoF solver (interFoam) with a differentiable MULES limiter
(port of ``dafoam_tpu.solvers.inter``).

Reference: DAInterFoam (src/adjoint/DASolver/DAInterFoam/: UEqnInter.H
rho-weighted momentum with face-reconstructed buoyancy and pressure,
pEqnInter.H p_rgh projection, src/include/VoF/alphaEqn.H cAlpha interface
compression) and its differentiable MULES fork (src/adjoint/DAMisc/
MULESDF/).

- alpha: one explicit flux-corrected (Zalesak/MULES) update per time
  step, a bounded upwind flux plus a limited antidiffusive (central +
  compression) correction that keeps alpha in [0, 1];
- momentum: ddt(rho U) + div(rhoPhi, U) - laplacian(mu, U), PISO-style
  (no predictor solve), with buoyancy and p_rgh forces reconstructed from
  faces (fvc.reconstruct);
- pressure: laplacian(rAUf, p_rgh) == div(phiHbyA + phig) by Jacobi-CG
  through K1; R_phi = phiHbyA + phig - p_rghEqn.flux() - phi;
- the alpha residual row is explicit, R_alpha = alpha - alphaUpdate(W_old),
  so the reverse sweep carries it through its cross-step products.

The dam break starts at rest with alpha exactly 0 or 1: phi == 0 on every
face and most antidiffusive fluxes vanish, so |.|, max, min and clip all
sit on their kinks. They are ``ops.core``'s ``abs_ad``, ``maximum``,
``minimum`` and ``clip``, which take jnp's derivative at a tie; torch.abs
or torch.clamp there would change the first reverse step. The Zalesak
ratio's floor is dafoam_tpu's 1e-30 in f64 and 1e-15 in f32, where the
square of 1e-30 underflows and the reverse sweep would turn NaN.
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.models import make_turbulence_model
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import (abs_ad, boundary_gather,
                                       cell_to_face_nei, cell_to_face_own,
                                       clip, face_sum_pair, maximum, minimum,
                                       surface_sum)
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import DASolverBase
from dafoam_tpu_torch.solvers.pimple import DAPimpleFoam
from dafoam_tpu_torch.states import StateInfo


class DAInterFoam(DAPimpleFoam):

    def __init__(self, option, topo, points, *, device, dtype):
        opt = option if isinstance(option, DAOption) else DAOption(option)
        # its own states and no turbulence model: DASimpleFoam's set-up is
        # bypassed, DASolverBase's taken directly
        self.has_T = False
        self.state_info = StateInfo(vol_vector=("U",),
                                    vol_scalar=("p_rgh", "alpha"),
                                    surface_scalar=("phi",))
        DASolverBase.__init__(self, opt, topo, points, device=device,
                              dtype=dtype)
        self.turb = make_turbulence_model("None", topo, self.option)
        self.div_u_scheme = self.option["divSchemes"].get(
            "div(rhoPhi,U)", "upwind")
        tp = self.option["transportProperties"]
        self.rho1 = float(tp.get("rho1", 1000.0))
        self.rho2 = float(tp.get("rho2", 1.0))
        self.nu1 = float(tp.get("nu1", 1e-6))
        self.nu2 = float(tp.get("nu2", 1.48e-5))
        self.c_alpha = float(tp.get("cAlpha", 1.0))
        self.g = self._tensor(np.asarray(self.option.get("g",
                                                         [0.0, -9.81, 0.0])))
        self.dt = float(self.option["deltaT"])
        self.n_steps = int(round(float(self.option["endTime"]) / self.dt))
        pcfg = self.option.get("pimple", {}) or {}
        self.n_outer = pcfg.get("nOuterCorrectors", 3)
        self.n_corr = pcfg.get("nCorrectors", 2)
        self.ddt_scheme, self.ddt_order = "Euler", 1
        self.p_needs_ref = not any(
            s["type"] == "fixedValue"
            for s in self.bc_spec.get("p_rgh", {}).values())
        ni = topo.n_internal
        fixed = np.zeros((topo.n_faces - ni,))
        for p in topo.patches:
            s = self.bc_spec.get("U", {}).get(p.name,
                                              {"type": "zeroGradient"})
            if s["type"] in ("fixedValue", "noSlip", "empty") \
                    or p.kind == "empty":
                fixed[p.start - ni:p.start - ni + p.size] = 1.0
        self._fixed_flux_b = self._tensor(fixed)
        self._user_bounds = {}

    # -- mixture (differentiable in the params) --------------------------
    def _mixture(self, alpha, inputs):
        p = inputs["params"]
        rho1 = p.get("rho1", self.rho1)
        rho2 = p.get("rho2", self.rho2)
        nu1 = p.get("nu1", self.nu1)
        nu2 = p.get("nu2", self.nu2)
        a = clip(alpha, 0.0, 1.0)
        rho = a * rho1 + (1.0 - a) * rho2
        mu = a * rho1 * nu1 + (1.0 - a) * rho2 * nu2
        return rho, mu

    def _bco_a(self, alpha, inputs, geom, phi):
        return bc.coeffs(self.bc_spec.get("alpha", {}),
                         inputs["bc"].get("alpha", {}), self.topo, geom,
                         alpha, rank=0, phi_b=phi[self.topo.n_internal:])

    def _bco_p(self, p, inputs, geom, phi):
        return bc.coeffs(self.bc_spec["p_rgh"],
                         inputs["bc"].get("p_rgh", {}), self.topo, geom, p,
                         rank=0, phi_b=phi[self.topo.n_internal:])

    def _sn_diff(self, x, geom):
        """(x_nei - x_own) delta-coefficient-weighted on internal faces."""
        ni = self.topo.n_internal
        return (cell_to_face_nei(x, self.topo)
                - cell_to_face_own(x, self.topo)) * geom.nonorth_dc[:ni]

    def _face_interp(self, x, geom):
        """Face values of x, the boundary faces taking their owner's."""
        return fvc.interpolate(geom, self.topo, x, boundary_gather(x,
                                                                   self.topo))

    # -- MULES alpha update (explicit, flux-corrected) --------------------
    def alpha_update(self, alpha_old, phi, U, inputs, geom):
        """One Euler FCT step: bounded upwind plus limited antidiffusion
        (compression + central correction), the MULESDF analogue.
        Returns (alpha_new, the face flux alphaPhi)."""
        topo = self.topo
        ni = topo.n_internal
        dt = self.dt
        dtype = alpha_old.dtype
        a_b = bc.boundary_value(self._bco_a(alpha_old, inputs, geom, phi),
                                alpha_old, topo)
        a_own = cell_to_face_own(alpha_old, topo)
        a_nei = cell_to_face_nei(alpha_old, topo)
        phi_i = phi[:ni]
        pos = (phi_i >= 0.0).to(dtype)

        # low-order (bounded upwind) face flux
        F_low = phi_i * (pos * a_own + (1.0 - pos) * a_nei)

        # high order: central + interface compression
        w = geom.weights[:ni]
        a_cen = w * a_own + (1.0 - w) * a_nei
        grad_a = fvc.grad(geom, topo, alpha_old, a_b)
        g_f = self._face_interp(grad_a, geom)[:ni]
        gmag = torch.sqrt(maximum(torch.sum(g_f * g_f, -1), 1e-16))
        nhat = g_f / gmag[:, None]
        msf = torch.where(geom.magsf[:ni] > 0.0, geom.magsf[:ni], 1.0)
        phic = self.c_alpha * abs_ad(phi_i) / msf
        phir = phic * (nhat * geom.sf[:ni]).sum(-1)
        # alphar scheme on alpha(1 - alpha), upwind with respect to phir
        ar_own = a_own * (1.0 - a_own)
        ar_nei = a_nei * (1.0 - a_nei)
        posr = (phir >= 0.0).to(dtype)
        F_comp = phir * (posr * ar_own + (1.0 - posr) * ar_nei)
        A = phi_i * a_cen + F_comp - F_low     # antidiffusive face flux

        vol_dt = geom.vol / dt
        # boundary flux: outflow takes the owner's alpha, inflow the BC's
        phi_b = phi[ni:]
        pos_b = (phi_b >= 0.0).to(dtype)
        F_b = phi_b * (pos_b * boundary_gather(alpha_old, topo)
                       + (1.0 - pos_b) * a_b)
        a_low = alpha_old - dt * surface_sum(F_low, F_b, topo) / geom.vol

        # Zalesak limiter with global bounds [0, 1] (MULES alphaMax/Min):
        # a face flux A > 0 raises the neighbour and lowers the owner
        P_plus = face_sum_pair(maximum(-A, 0.0), maximum(A, 0.0), topo)
        P_minus = face_sum_pair(maximum(A, 0.0), maximum(-A, 0.0), topo)
        Q_plus = maximum(1.0 - a_low, 0.0) * vol_dt
        Q_minus = maximum(a_low - 0.0, 0.0) * vol_dt
        # the floor of P is dafoam_tpu's 1e-30 in f64; in f32 its square
        # underflows, and the vjp of Q/P then takes 0 * inf = NaN where the
        # min picks 1, so f32 floors at 1e-15
        tiny = 1e-30 if alpha_old.dtype == torch.float64 else 1e-15
        R_plus = minimum(Q_plus / maximum(P_plus, tiny), 1.0)
        R_minus = minimum(Q_minus / maximum(P_minus, tiny), 1.0)
        # A >= 0: owner loses (R_minus[own]), neighbour gains (R_plus[nei])
        lam = torch.where(
            A >= 0.0,
            minimum(cell_to_face_own(R_minus, topo),
                    cell_to_face_nei(R_plus, topo)),
            minimum(cell_to_face_own(R_plus, topo),
                    cell_to_face_nei(R_minus, topo)))
        F_lim = F_low + lam * A
        alpha_new = alpha_old - dt * surface_sum(F_lim, F_b, topo) / geom.vol
        return alpha_new, torch.cat([F_lim, F_b])

    # -- shared momentum / pressure assembly --------------------------------
    def _momentum(self, W, rho, rho_old, U_old, rho_phi, mu_f, inputs,
                  geom, scheme):
        """ddt(rho U) + div(rhoPhi, U) - laplacian(mu, U) and U's BC."""
        topo = self.topo
        ni = topo.n_internal
        U = W["U"]
        U_bco = self._bco_U(U, inputs, geom, W["phi"])
        M = fvm.div(geom, topo, rho_phi, U, U_bco, scheme=scheme) \
            - fvm.laplacian(geom, topo, mu_f, U, U_bco)
        v = geom.vol[:, None]
        return M + fvx.FvMatrix(
            diag=torch.broadcast_to(rho[:, None] * v / self.dt, U.shape),
            lower=U.new_zeros((ni,)), upper=U.new_zeros((ni,)),
            source=rho_old[:, None] * v / self.dt * U_old), U_bco

    def _pressure(self, M, U_bco, W, rho, ghf, inputs, geom):
        """(rAU, HbyA, phiHbyA, rAUf, phig, p_rgh matrix, p_rgh BC) of the
        projection at W."""
        topo = self.topo
        U, p = W["U"], W["p_rgh"]
        rAU = 1.0 / fvx.A(M, geom)
        HbyA = rAU[:, None] * fvx.H(M, U, geom, topo)
        U_b = bc.boundary_value(U_bco, U, topo)
        HbyA_b = torch.where(self._fixed_flux_b[:, None] > 0.5, U_b,
                             boundary_gather(HbyA, topo))
        phiHbyA = fvc.flux(geom, topo, HbyA, HbyA_b)
        rAU_f = self._face_interp(rAU, geom)
        # buoyancy face flux phig = -ghf snGrad(rho) rAUf |Sf|
        sng_rho = torch.cat([self._sn_diff(rho, geom),
                             rho.new_zeros((topo.n_boundary,))])
        phig = -ghf * sng_rho * rAU_f * geom.magsf
        p_bco = self._bco_p(p, inputs, geom, W["phi"])
        pM = fvm.laplacian(geom, topo, rAU_f, p, p_bco)
        pM = pM.add_source(
            fvc.div_surface(geom, topo, phiHbyA + phig) * geom.vol)
        if self.p_needs_ref:
            pM = fvx.set_reference(pM, 0, 0.0)
        return rAU, HbyA, phiHbyA, rAU_f, phig, sng_rho, pM, p_bco

    # -- one time step ------------------------------------------------------
    def _step(self, state_old, inputs, geom, state_oldold=None, t=None):
        if t is not None:
            inputs = {**inputs, "t": t}
        lin = self.option["primalLinearSolver"]
        topo = self.topo
        ghf = geom.cf @ self.g
        alpha_new, alpha_phi = self.alpha_update(
            state_old["alpha"], state_old["phi"], state_old["U"], inputs,
            geom)
        rho, mu = self._mixture(alpha_new, inputs)
        rho_old, _ = self._mixture(state_old["alpha"], inputs)
        mu_f = self._face_interp(mu, geom)
        rho_phi = self.rho2 * state_old["phi"] \
            + (self.rho1 - self.rho2) * alpha_phi
        st = dict(state_old, alpha=alpha_new)
        for _ in range(self.n_outer):
            M, U_bco = self._momentum(st, rho, rho_old, state_old["U"],
                                      rho_phi, mu_f, inputs, geom,
                                      self.div_u_scheme)
            # predictor skipped (PISO-style): straight to the projection
            rAU, HbyA, phiHbyA, rAU_f, phig, _, pM, _ = self._pressure(
                M, U_bco, st, rho, ghf, inputs, geom)
            for _ in range(self.n_corr):
                p_new, info = fvsolve.solve(pM, st["p_rgh"], topo,
                                            symmetric=True,
                                            rel_tol=lin["pRelTol"],
                                            max_iters=lin["pMaxIters"])
                self._log_solve("p_rgh", info)
                pflux = fvm.laplacian_flux(
                    geom, topo, rAU_f, p_new,
                    self._bco_p(p_new, inputs, geom, st["phi"]))
                # U = HbyA + rAU reconstruct((phig - pflux)/rAUf)
                # (reference pEqnInter.H:64)
                U_new = HbyA + rAU[:, None] * fvc.reconstruct(
                    geom, topo, (phig - pflux) / torch.where(
                        rAU_f > 0.0, rAU_f, 1.0))
                st = dict(st, U=U_new, p_rgh=p_new,
                          phi=phiHbyA + phig - pflux)
        return st

    # -- residual -----------------------------------------------------------
    def residuals_unsteady(self, W, W_old, W_oldold, inputs, n=None):
        if n is not None:
            inputs = {**inputs, "t": float(n) * self.dt}
        geom = self.geometry(inputs)
        topo = self.topo
        ghf = geom.cf @ self.g
        U, p, phi, alpha = W["U"], W["p_rgh"], W["phi"], W["alpha"]

        alpha_pred, alpha_phi = self.alpha_update(
            W_old["alpha"], W_old["phi"], W_old["U"], inputs, geom)
        rho, mu = self._mixture(alpha, inputs)
        rho_old, _ = self._mixture(W_old["alpha"], inputs)
        rho_phi = self.rho2 * W_old["phi"] \
            + (self.rho1 - self.rho2) * alpha_phi
        M, U_bco = self._momentum(W, rho, rho_old, W_old["U"], rho_phi,
                                  self._face_interp(mu, geom), inputs, geom,
                                  self.div_u_scheme)
        _, _, phiHbyA, rAU_f, phig, sng_rho, pM, p_bco = self._pressure(
            M, U_bco, W, rho, ghf, inputs, geom)
        # body force: buoyancy + p_rgh gradient, face-reconstructed
        sng_p = torch.cat([self._sn_diff(p, geom),
                           bc.boundary_sngrad(p_bco, p, topo)])
        force = fvc.reconstruct(geom, topo,
                                (-ghf * sng_rho - sng_p) * geom.magsf)
        out = {"U": fvx.residual(M, U, geom, topo) - force,
               "p_rgh": fvx.residual(pM, p, geom, topo),
               "phi": phiHbyA + phig
               - fvm.laplacian_flux(geom, topo, rAU_f, p, p_bco) - phi,
               "alpha": alpha - alpha_pred}
        return self._apply_res_norm(out, geom)

    def boundary_fields(self, state, inputs, geom):
        topo = self.topo
        phi = state["phi"]
        return {"U": bc.boundary_value(
                    self._bco_U(state["U"], inputs, geom, phi), state["U"],
                    topo),
                "alpha": bc.boundary_value(
                    self._bco_a(state["alpha"], inputs, geom, phi),
                    state["alpha"], topo),
                "p_rgh": bc.boundary_value(
                    self._bco_p(state["p_rgh"], inputs, geom, phi),
                    state["p_rgh"], topo)}

    # -- unsteady adjoint PC: two-phase operators --------------------------
    def unsteady_pc_assemble(self, W, W1, W2, inputs, n=None):
        """The segregated PC's matrices: rho-weighted upwind momentum and
        the p_rgh laplacian (the explicit alpha rows pass through)."""
        with torch.no_grad():
            geom = self.geometry(inputs)
            _, alpha_phi = self.alpha_update(W1["alpha"], W1["phi"],
                                             W1["U"], inputs, geom)
            rho, mu = self._mixture(W["alpha"], inputs)
            rho_phi = self.rho2 * W1["phi"] \
                + (self.rho1 - self.rho2) * alpha_phi
            M, _ = self._momentum(W, rho, rho, torch.zeros_like(W["U"]),
                                  rho_phi, self._face_interp(mu, geom),
                                  inputs, geom, "upwind")
            rAU_f = self._face_interp(1.0 / fvx.A(M, geom), geom)
            p_bco = self._bco_p(W["p_rgh"], inputs, geom, W["phi"])
            pM = fvm.laplacian(geom, self.topo, rAU_f, W["p_rgh"], p_bco)
            if self.p_needs_ref:
                pM = fvx.set_reference(pM, 0, 0.0)
        return {"U": M, "p_rgh": pM}
