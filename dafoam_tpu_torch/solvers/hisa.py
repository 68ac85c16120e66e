"""Density-based compressible flow solver, the DAHisaFoam role (port of
``dafoam_tpu.solvers.hisa``).

The reference's DAHisaFoam (src/adjoint/DASolver/DAHisaFoam/) wraps the
HiSA library for the primal (AUSM-family flux, JT-KIRK implicit pseudo
time) and defines its adjoint residual in DAResidualHisaFoam.C with the
laxFriedrichs (:118) and JST (:137) fluxes:

    R_p = -div(phi);  R_U = -div(phiUp);  R_T = -div(phiEp)
    + viscous terms when not inviscid: laplacian(muEff, U) + div(tauMC),
      div(sigmaDotU) and laplacian(alphaEff, e) in the energy equation,

with the conservative variables of the primitive states (U, p, T) by
perfect-gas thermo (rho = p/(R T), e = Cv T, rhoE = rho (e + |U|^2/2)).

The primal is matrix-free Newton pseudo-transient continuation:
(diag(dQ/dW)/dtau - dR/dW) dW = R, solved by full FGMRES with a coupled
5x5-block Rusanov preconditioner. ``jax.linearize`` becomes forward-mode
AD: every GMRES product is one jvp of the flow residual under
``torch.autograd.forward_ad`` (the residual passes through none of the
port's custom autograd Functions, so forward AD sees through it). The
pseudo-time loop, its SER CFL ramp, the revert-to-best safeguard and the
three-candidate line search are host decisions, one or two syncs per
iteration. No banded matvec runs here: the block PC's 5x5 inverse is a
batched library call (``torch.linalg.inv``), as ``jnp.linalg.inv`` is in
``dafoam_tpu``, not a port of a TPU kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dafoam_tpu_torch.adjoint import solver as adjsolver
from dafoam_tpu_torch.linalg.krylov import gmres
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.mesh.walldist import compute_wall_distance
from dafoam_tpu_torch.models import (make_turbulence_model,
                                     turbulence_model_class)
from dafoam_tpu_torch.ops import bc, fvc
from dafoam_tpu_torch.ops.core import (abs_ad, boundary_gather,
                                       boundary_scatter_add,
                                       cell_to_face_nei, cell_to_face_own,
                                       clip, face_sum_pair, maximum,
                                       surface_sum)
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo
from dafoam_tpu_torch.utils.precision import guard_tiny

FLOW_KEYS = ("U", "p", "T")


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _mv(A, x):
    """Batched (n, 5, 5) @ (n, 5)."""
    return torch.einsum("cij,cj->ci", A, x)


def _to_blocks(p, U, T):
    """(nc, 5) in the conservative ordering (p/rho, U/rhoU, T/rhoE)."""
    return torch.cat([p[:, None], U, T[:, None]], dim=1)


class DAHisaFoam(DASolverBase):

    def __init__(self, option, topo, points, *, device, dtype):
        opt = option if isinstance(option, DAOption) else DAOption(option)
        turb_name = opt["turbulenceModel"]
        model_states = turbulence_model_class(turb_name).model_states
        self.state_info = StateInfo(vol_vector=("U",),
                                    vol_scalar=("p", "T"),
                                    model=tuple(model_states))
        super().__init__(opt, topo, points, device=device, dtype=dtype)
        geom0 = compute_geometry(self.points, topo)
        self.wall_dist = self._tensor(compute_wall_distance(
            geom0.cc.cpu().numpy(), points, topo))
        kw = {"bc_spec": self.bc_spec} \
            if turb_name not in ("None", "laminar") else {}
        self.turb = make_turbulence_model(turb_name, topo, self.option,
                                          wall_dist=self.wall_dist, **kw)
        self.turb.setup_wall_functions(self.bc_spec)
        self._user_bounds = (option.get("primalVarBounds", {})
                             if isinstance(option, dict) else {})
        h = self.option.get("hisa", {})
        self.inviscid = bool(h.get("inviscid", False))
        self.flux_scheme = h.get("fluxScheme", "AUSMPlusUp")
        self.jst_k2 = float(h.get("jst_k2", 0.5))
        self.jst_k4 = float(h.get("jst_k4", 0.02))
        # open (inlet/outlet) boundary faces get a Rusanov characteristic
        # flux between the owner and BC states: pure BC-value fluxes have
        # no dissipation there and trap acoustic modes between reflective
        # boundaries. Wall-type faces keep the BC-value flux (exact zero
        # mass flux). Classified statically from the U BC types.
        closed = ("slip", "noSlip", "symmetry", "symmetryPlane", "empty",
                  "wall")
        uspec = self.bc_spec["U"]
        mask = np.zeros((topo.n_boundary,))
        ni = topo.n_internal
        for p in topo.patches:
            btype = uspec.get(p.name, {"type": "zeroGradient"})["type"]
            if btype not in closed:
                mask[p.start - ni:p.start - ni + p.size] = 1.0
        self._open_b = self._tensor(mask)
        self._has_open = bool(mask.any())
        # the last primal's final CFL (host float)
        self.last_cfl = None

    # -- thermo (perfect gas, e-based) ---------------------------------------
    def _thermo(self, inputs):
        p = inputs["params"]
        R = p.get("R", 287.0)
        gamma = p.get("gamma", 1.4)
        Cv = R / (gamma - 1.0)
        return (R, gamma, Cv, p.get("mu", 1.8e-5), p.get("Pr", 0.7),
                p.get("Prt", 0.9))

    # -- BC helpers --------------------------------------------------------------
    def _bcos(self, state, inputs, geom, phi_b=None):
        topo = self.topo
        if phi_b is None:
            phi_b = state["p"].new_zeros((topo.n_boundary,))
        return {name: bc.coeffs(self.bc_spec[name],
                                inputs["bc"].get(name, {}), topo, geom,
                                state[name], rank=rank, phi_b=phi_b)
                for name, rank in (("U", 1), ("p", 0), ("T", 0))}

    # -- conservative variables and fluxes -------------------------------------
    def _cons(self, state, inputs, U_b, p_b, T_b):
        R, gamma, Cv = self._thermo(inputs)[:3]
        p, T, U = state["p"], state["T"], state["U"]
        rho = p / (R * T)
        rhoU = rho[:, None] * U
        rhoE = rho * (Cv * T + 0.5 * (U * U).sum(-1))
        rho_b = p_b / (R * T_b)
        rhoU_b = rho_b[:, None] * U_b
        rhoE_b = rho_b * (Cv * T_b + 0.5 * (U_b * U_b).sum(-1))
        c = torch.sqrt(gamma * R * T)
        c_b = torch.sqrt(gamma * R * T_b)
        return rho, rhoU, rhoE, rho_b, rhoU_b, rhoE_b, c, c_b

    def _central_fluxes(self, geom, state, U_b, p_b, rho, rhoU, rhoE,
                        rho_b, rhoU_b, rhoE_b, c, c_b):
        """Central (linear-interpolated) convective fluxes on all faces:
        phi = interp(rhoU).Sf, phiUp = interp(rhoU x U + p I).Sf expanded
        per side (no (nf,3,3) tensor), phiEp = interp((rhoE + p) U).Sf."""
        topo = self.topo
        ni = topo.n_internal
        p, U = state["p"], state["U"]
        w = geom.weights[:ni]
        sf_i = geom.sf[:ni]
        U_own, U_nei = cell_to_face_own(U, topo), cell_to_face_nei(U, topo)
        uSf_own, uSf_nei = _dot(U_own, sf_i), _dot(U_nei, sf_i)
        rhoU_own = cell_to_face_own(rhoU, topo)
        rhoU_nei = cell_to_face_nei(rhoU, topo)
        phi_i = _dot(w[:, None] * rhoU_own + (1 - w)[:, None] * rhoU_nei,
                     sf_i)
        p_own, p_nei = cell_to_face_own(p, topo), cell_to_face_nei(p, topo)
        phiUp_i = (w[:, None] * (rhoU_own * uSf_own[:, None]
                                 + p_own[:, None] * sf_i)
                   + (1 - w)[:, None] * (rhoU_nei * uSf_nei[:, None]
                                         + p_nei[:, None] * sf_i))
        rEp_own = cell_to_face_own(rhoE, topo) + p_own
        rEp_nei = cell_to_face_nei(rhoE, topo) + p_nei
        phiEp_i = w * rEp_own * uSf_own + (1 - w) * rEp_nei * uSf_nei
        phi_b, phiUp_b, phiEp_b = self._boundary_fluxes(
            geom, state, U_b, p_b, rho, rhoU, rhoE, rho_b, rhoU_b, rhoE_b,
            c, c_b)
        return (torch.cat([phi_i, phi_b]), torch.cat([phiUp_i, phiUp_b]),
                torch.cat([phiEp_i, phiEp_b]))

    def _spec_radius_faces(self, geom, state, c):
        """|interp(U).Sf|/|Sf| + interp(c) on internal faces (specR)."""
        topo = self.topo
        ni = topo.n_internal
        w = geom.weights[:ni]
        U = state["U"]
        Uf = (w[:, None] * cell_to_face_own(U, topo)
              + (1 - w)[:, None] * cell_to_face_nei(U, topo))
        msf = maximum(geom.magsf[:ni], 1e-36)
        un = abs_ad(_dot(Uf, geom.sf[:ni])) / msf
        cf = w * cell_to_face_own(c, topo) \
            + (1 - w) * cell_to_face_nei(c, topo)
        return cf + un

    def _ausm_fluxes(self, geom, state, U_b, p_b, rho, rhoU, rhoE, rho_b,
                     rhoU_b, rhoE_b, c, c_b):
        """AUSM+up interface flux (Liou 2006) on internal faces, the flux
        HiSA's primal integrates (fluxScheme AUSMPlusUp); piecewise
        polynomial splittings, so differentiable. Boundary faces keep the
        BC-value flux of _central_fluxes."""
        topo = self.topo
        ni = topo.n_internal
        msf = maximum(geom.magsf[:ni], 1e-36)
        nhat = geom.sf[:ni] / msf[:, None]
        rhoL, rhoR = cell_to_face_own(rho, topo), cell_to_face_nei(rho, topo)
        UL = cell_to_face_own(state["U"], topo)
        UR = cell_to_face_nei(state["U"], topo)
        pL = cell_to_face_own(state["p"], topo)
        pR = cell_to_face_nei(state["p"], topo)
        EL, ER = cell_to_face_own(rhoE, topo), cell_to_face_nei(rhoE, topo)
        # zero-area (padded dense-layout) faces: neutral states
        valid = geom.magsf[:ni] > 0.0
        rhoL = torch.where(valid, rhoL, 1.0)
        rhoR = torch.where(valid, rhoR, 1.0)
        aL, aR = cell_to_face_own(c, topo), cell_to_face_nei(c, topo)
        a2 = torch.where(valid, 0.5 * (aL + aR), 1.0)
        unL, unR = _dot(UL, nhat), _dot(UR, nhat)
        ML, MR = unL / a2, unR / a2

        def M1(M, s):
            return 0.5 * (M + s * abs_ad(M))

        def M4(M, s, beta=0.125):
            sub = s * 0.25 * (M + s) ** 2 + s * beta * (M * M - 1.0) ** 2
            return torch.where(abs_ad(M) >= 1.0, M1(M, s), sub)

        def P5(M, s, alpha=0.1875):
            sub = 0.25 * (M + s) ** 2 * (2.0 - s * M) \
                + s * alpha * M * (M * M - 1.0) ** 2
            sup = torch.where(s * M > 0.0, 1.0, 0.0).to(M.dtype)
            return torch.where(abs_ad(M) >= 1.0, sup, sub)

        rho2 = 0.5 * (rhoL + rhoR)
        Kp, Ku, sigma = 0.25, 0.75, 1.0
        Mbar2 = 0.5 * (unL * unL + unR * unR) / (a2 * a2)
        Mp = -Kp * maximum(1.0 - sigma * Mbar2, 0.0) \
            * (pR - pL) / (rho2 * a2 * a2)
        M2 = M4(ML, 1.0) + M4(MR, -1.0) + Mp
        mdot = a2 * M2 * torch.where(M2 > 0.0, rhoL, rhoR)
        pu = -Ku * P5(ML, 1.0) * P5(MR, -1.0) * (rhoL + rhoR) \
            * a2 * (unR - unL)
        p2 = P5(ML, 1.0) * pL + P5(MR, -1.0) * pR + pu
        up = M2 > 0.0
        HL = (EL + pL) / rhoL
        HR = (ER + pR) / rhoR
        vf = valid.to(rho.dtype)
        phi_i = mdot * msf * vf
        phiUp_i = (mdot[:, None] * torch.where(up[:, None], UL, UR)
                   * msf[:, None] + p2[:, None] * geom.sf[:ni]) \
            * vf[:, None]
        phiEp_i = mdot * torch.where(up, HL, HR) * msf * vf
        phi_b, phiUp_b, phiEp_b = self._boundary_fluxes(
            geom, state, U_b, p_b, rho, rhoU, rhoE, rho_b, rhoU_b, rhoE_b,
            c, c_b)
        return (torch.cat([phi_i, phi_b]), torch.cat([phiUp_i, phiUp_b]),
                torch.cat([phiEp_i, phiEp_b]))

    def _boundary_fluxes(self, geom, state, U_b, p_b, rho, rhoU, rhoE,
                         rho_b, rhoU_b, rhoE_b, c, c_b):
        """BC-value flux on wall-type faces, the Rusanov flux between the
        owner and BC states on open faces."""
        topo = self.topo
        ni = topo.n_internal
        sf_b = geom.sf[ni:]
        msf_b = maximum(geom.magsf[ni:], 1e-36)
        uSf_b = _dot(U_b, sf_b)
        phi_bc = _dot(rhoU_b, sf_b)
        phiUp_bc = rhoU_b * uSf_b[:, None] + p_b[:, None] * sf_b
        phiEp_bc = (rhoE_b + p_b) * uSf_b
        if not self._has_open:
            return phi_bc, phiUp_bc, phiEp_bc
        rho_o = boundary_gather(rho, topo)
        rhoU_o = boundary_gather(rhoU, topo)
        rhoE_o = boundary_gather(rhoE, topo)
        U_o = boundary_gather(state["U"], topo)
        p_o = boundary_gather(state["p"], topo)
        c_o = boundary_gather(c, topo)
        uSf_o = _dot(U_o, sf_b)
        phi_o = _dot(rhoU_o, sf_b)
        phiUp_o = rhoU_o * uSf_o[:, None] + p_o[:, None] * sf_b
        phiEp_o = (rhoE_o + p_o) * uSf_o
        lam = torch.maximum(abs_ad(uSf_o) / msf_b + c_o,
                            abs_ad(uSf_b) / msf_b + c_b) * msf_b
        phi_ru = 0.5 * (phi_o + phi_bc) - 0.5 * lam * (rho_b - rho_o)
        phiUp_ru = 0.5 * (phiUp_o + phiUp_bc) \
            - 0.5 * lam[:, None] * (rhoU_b - rhoU_o)
        phiEp_ru = 0.5 * (phiEp_o + phiEp_bc) - 0.5 * lam * (rhoE_b - rhoE_o)
        ob = self._open_b > 0.5
        return (torch.where(ob, phi_ru, phi_bc),
                torch.where(ob[:, None], phiUp_ru, phiUp_bc),
                torch.where(ob, phiEp_ru, phiEp_bc))

    def _fluxes(self, state, inputs, geom, bcos, scheme=None):
        """(phi, phiUp, phiEp) with the configured dissipation, plus the
        boundary values and conservative variables needed downstream."""
        scheme = scheme or self.flux_scheme
        topo = self.topo
        ni = topo.n_internal
        act = bcos["p"].active
        U_b = bc.boundary_value(bcos["U"], state["U"], topo) * act[:, None]
        # empty-plane faces carry zeroed BC values; guard the thermo
        # division and zero their fluxes through the active mask
        p_b = bc.boundary_value(bcos["p"], state["p"], topo) * act
        T_b = torch.where(act > 0.5,
                          bc.boundary_value(bcos["T"], state["T"], topo), 1.0)
        rho, rhoU, rhoE, rho_b, rhoU_b, rhoE_b, c, c_b = self._cons(
            state, inputs, U_b, p_b, T_b)
        if scheme == "AUSMPlusUp":
            phi, phiUp, phiEp = self._ausm_fluxes(
                geom, state, U_b, p_b, rho, rhoU, rhoE, rho_b, rhoU_b,
                rhoE_b, c, c_b)
            return (phi, phiUp, phiEp, U_b, p_b, T_b, rho, rho_b, c)
        phi, phiUp, phiEp = self._central_fluxes(
            geom, state, U_b, p_b, rho, rhoU, rhoE, rho_b, rhoU_b, rhoE_b,
            c, c_b)
        specR = self._spec_radius_faces(geom, state, c)
        msf_i = geom.magsf[:ni]

        def d1(x):  # first difference across internal faces (nei - own)
            return cell_to_face_nei(x, topo) - cell_to_face_own(x, topo)

        if scheme == "laxFriedrichs":
            # DAResidualHisaFoam.C:118: flux -= 0.5 specR (x_N - x_O) |Sf|
            diss = 0.5 * specR * msf_i
            d_phi = diss * d1(rho)
            d_phiUp = diss[:, None] * d1(rhoU)
            d_phiEp = diss * d1(rhoE)
        else:  # JST (DAResidualHisaFoam.C:137)
            p_st = state["p"]
            w = geom.weights[:ni]
            p_sum = 2.0 * (w * cell_to_face_own(p_st, topo)
                           + (1 - w) * cell_to_face_nei(p_st, topo))
            sensor = clip(abs_ad(d1(p_st)) / (p_sum + 1e-16), 0.0, 1.0)
            eps2 = self.jst_k2 * sensor
            eps4 = maximum(self.jst_k4 - eps2, 0.0)
            # d3 = orthogonalSnGrad(d2)/dc^2 = (d2_N - d2_O)/dc
            # (DAResidualHisaFoam.C:176-181)
            inv_dc = 1.0 / maximum(geom.delta_coeffs[:ni], 1e-36)

            def jst(x):
                dx = d1(x)
                ext = (1,) * (dx.ndim - 1)
                d2 = surface_sum(dx * msf_i.reshape((-1,) + ext), None,
                                 topo) / geom.vol.reshape((-1,) + ext)
                d3 = d1(d2) * inv_dc.reshape((-1,) + ext)
                return (eps2.reshape((-1,) + ext) * dx
                        - eps4.reshape((-1,) + ext) * d3) \
                    * (msf_i * specR).reshape((-1,) + ext)

            d_phi, d_phiUp, d_phiEp = jst(rho), jst(rhoU), jst(rhoE)
        phi = torch.cat([phi[:ni] - d_phi, phi[ni:]])
        phiUp = torch.cat([phiUp[:ni] - d_phiUp, phiUp[ni:]])
        phiEp = torch.cat([phiEp[:ni] - d_phiEp, phiEp[ni:]])
        return (phi, phiUp, phiEp, U_b, p_b, T_b, rho, rho_b, c)

    # -- residuals ------------------------------------------------------------------
    def residuals(self, state, inputs):
        return self._residuals_geom(state, inputs, self.geometry(inputs))

    def _residuals_geom(self, state, inputs, geom, scheme=None):
        topo = self.topo
        ni = topo.n_internal
        R, gamma, Cv, mu, Pr, Prt = self._thermo(inputs)
        bcos = self._bcos(state, inputs, geom)
        (phi, phiUp, phiEp, U_b, p_b, T_b, rho, rho_b, c) = self._fluxes(
            state, inputs, geom, bcos, scheme=scheme)
        r_p = -fvc.div_surface(geom, topo, phi)
        r_U = -fvc.div_surface(geom, topo, phiUp)
        r_T = -fvc.div_surface(geom, topo, phiEp)

        if not self.inviscid:
            U = state["U"]
            mut = rho * self.turb.nut(state, inputs, geom)
            mut_b = rho_b * self.turb.nut_boundary(state, inputs, geom)
            mu_eff = mu + mut
            mu_eff_b = mu + mut_b
            mu_eff_f = fvc.interpolate(geom, topo, mu_eff, mu_eff_b)
            gradU = fvc.grad(geom, topo, U, U_b)
            sngU_b = bc.boundary_sngrad(bcos["U"], U, topo)
            sngU = fvc.snGrad(geom, topo, U, sngU_b, corrected=True,
                              grad_psi=gradU,
                              grad_psi_b=boundary_gather(gradU, topo))
            # fvc::laplacian(muEff, U)
            visc_flux = mu_eff_f[:, None] * sngU * geom.magsf[:, None]
            r_U = r_U + surface_sum(visc_flux[:ni], visc_flux[ni:],
                                    topo) / geom.vol[:, None]
            # tauMC = muEff dev2(gradU^T), its divergence explicit
            gt = torch.swapaxes(gradU, -1, -2)
            tr = torch.diagonal(gradU, dim1=-2, dim2=-1).sum(-1)
            eye = torch.eye(3, dtype=U.dtype, device=U.device)
            tau = mu_eff[:, None, None] * (
                gt - (2.0 / 3.0) * tr[..., None, None] * eye)
            tau_b = boundary_gather(tau, topo)
            r_U = r_U + fvc.div_tensor(geom, topo, tau, tau_b)
            # sigmaDotU work term (DAResidualHisaFoam.C:96-103)
            tau_f = fvc.interpolate(geom, topo, tau, tau_b)
            nhat = geom.sf / maximum(geom.magsf, 1e-36)[:, None]
            sig = (mu_eff_f[:, None] * sngU
                   + (nhat[:, :, None] * tau_f).sum(dim=1))
            Uf = fvc.interpolate(geom, topo, U, U_b)
            sigU = _dot(sig, Uf) * geom.magsf
            r_T = r_T + surface_sum(sigU[:ni], sigU[ni:], topo) / geom.vol
            # laplacian(alphaEff, e) with e = Cv T (perfect gas)
            alpha_f = fvc.interpolate(geom, topo, mu / Pr + mut / Prt,
                                      mu / Pr + mut_b / Prt)
            sngT_b = bc.boundary_sngrad(bcos["T"], state["T"], topo)
            gradT = fvc.grad(geom, topo, state["T"], T_b)
            sngT = fvc.snGrad(geom, topo, state["T"], sngT_b,
                              corrected=True, grad_psi=gradT,
                              grad_psi_b=boundary_gather(gradT, topo))
            eflux = Cv * alpha_f * sngT * geom.magsf
            r_T = r_T + surface_sum(eflux[:ni], eflux[ni:], topo) / geom.vol

        out = {"U": r_U, "p": r_p, "T": r_T}
        if self.turb.model_states:
            # the model transports on the VOLUMETRIC flux (mut = rho nut)
            rho_f = fvc.interpolate(geom, topo, rho, rho_b)
            phi_vol = phi / maximum(rho_f, 1e-36)
            gradU_t = fvc.grad(geom, topo, state["U"], U_b)
            out.update(self.turb.residuals(state, inputs, geom, phi_vol,
                                           gradU=gradU_t))
        return out

    # -- bounds and the pseudo-time step ----------------------------------------
    def _bound(self, name, v):
        b = self._user_bounds
        lo, hi = b.get(name + "Min"), b.get(name + "Max")
        if name in ("p", "T"):
            lo = 10.0 if lo is None else lo
        if lo is None and hi is None:
            return v
        return clip(v, -math.inf if lo is None else lo,
                    math.inf if hi is None else hi)

    def _inv_dtau(self, state, inputs, geom, cfl):
        """1/dtau per cell: sum_f (|u.Sf| + c |Sf|) / (CFL V)."""
        topo = self.topo
        ni = topo.n_internal
        R, gamma = self._thermo(inputs)[:2]
        c = torch.sqrt(gamma * R * maximum(state["T"], 1.0))
        U = state["U"]
        lam_i = (abs_ad(_dot(0.5 * (cell_to_face_own(U, topo)
                                    + cell_to_face_nei(U, topo)),
                             geom.sf[:ni]))
                 + 0.5 * (cell_to_face_own(c, topo)
                          + cell_to_face_nei(c, topo)) * geom.magsf[:ni])
        lam_sum = face_sum_pair(lam_i, lam_i, topo)
        own_lam_b = abs_ad(_dot(boundary_gather(U, topo), geom.sf[ni:])) \
            + boundary_gather(c, topo) * geom.magsf[ni:]
        lam_sum = boundary_scatter_add(lam_sum, own_lam_b, topo)
        return lam_sum / (cfl * geom.vol)

    # -- the coupled block preconditioner ---------------------------------------
    @staticmethod
    def _euler_flux_jac(u, q2, H, s, gamma):
        """Batched inviscid flux Jacobian A = d(F(Q).S)/dQ, (n, 5, 5), in
        the conservative ordering Q = (rho, rhoU_x, rhoU_y, rhoU_z, rhoE);
        s is the directed face-area vector, so A carries |Sf|."""
        gm1 = gamma - 1.0
        un = _dot(u, s)
        z = torch.zeros_like(un)
        eye3 = torch.eye(3, dtype=u.dtype, device=u.device)
        row0 = torch.stack([z, s[:, 0], s[:, 1], s[:, 2], z], dim=-1)
        # A[1+i, 1+j] = u_i s_j + un delta_ij - (gamma - 1) u_j s_i
        mom_u = u[:, :, None] * s[:, None, :] \
            + un[:, None, None] * eye3 \
            - gm1 * (s[:, :, None] * u[:, None, :])
        mom = torch.cat([(0.5 * gm1 * q2[:, None] * s
                          - u * un[:, None])[:, :, None],
                         mom_u, (gm1 * s)[:, :, None]], dim=2)
        row4 = torch.cat([((0.5 * gm1 * q2 - H) * un)[:, None],
                          H[:, None] * s - gm1 * u * un[:, None],
                          (gamma * un)[:, None]], dim=1)
        return torch.cat([row0[:, None], mom, row4[:, None]], dim=1)

    def _block_jac(self, state, inputs, geom, inv_dt):
        """The first-order Rusanov flux Jacobian of the block PC: per
        internal face P = dF/dQ_own, N = dF/dQ_nei, and the per-cell
        diagonal blocks D = sum of the face blocks + V/dtau I, (nc, 5, 5).

        F_f = 0.5 (F_i + F_j).Sf - 0.5 lam (Q_j - Q_i), so dF/dQ_i =
        0.5 A_i + 0.5 lam I and dF/dQ_j = 0.5 A_j - 0.5 lam I."""
        topo = self.topo
        ni = topo.n_internal
        R, gamma, Cv = self._thermo(inputs)[:3]
        U, T = state["U"], state["T"]
        c = torch.sqrt(gamma * R * maximum(T, 1.0))
        q2 = (U * U).sum(-1)
        H = Cv * T + 0.5 * q2 + R * T          # total enthalpy per mass
        sf_i = geom.sf[:ni]
        own, nei = cell_to_face_own, cell_to_face_nei
        A_own = self._euler_flux_jac(own(U, topo), own(q2, topo),
                                     own(H, topo), sf_i, gamma)
        A_nei = self._euler_flux_jac(nei(U, topo), nei(q2, topo),
                                     nei(H, topo), sf_i, gamma)
        lam_i = self._spec_radius_faces(geom, state, c) \
            * geom.magsf[:ni]
        I5 = torch.eye(5, dtype=U.dtype, device=U.device)
        P = 0.5 * A_own + 0.5 * lam_i[:, None, None] * I5   # dF/dQ_own
        N = 0.5 * A_nei - 0.5 * lam_i[:, None, None] * I5   # dF/dQ_nei
        # diag: own += P, nei += -N (R = -div F; system = M/dtau - dR/dQ)
        diag = face_sum_pair(P.reshape(ni, 25), (-N).reshape(ni, 25), topo)
        # boundary faces: Rusanov-level owner coupling ~ 0.5 lam_b I
        lam_b = 0.5 * (abs_ad(_dot(boundary_gather(U, topo), geom.sf[ni:]))
                       + boundary_gather(c, topo) * geom.magsf[ni:])
        diag = boundary_scatter_add(diag, lam_b[:, None] * I5.reshape(25),
                                    topo).reshape(-1, 5, 5)
        return P, N, diag + (geom.vol * inv_dt)[:, None, None] * I5

    def _block_pc(self, state, inputs, geom, inv_dt, sweeps):
        """Coupled 5x5-block Rusanov-Jacobian preconditioner (the LU-SGS
        operator role of HiSA's JT-KIRK solver, as block-Jacobi sweeps):
        approximates (V/dtau I + d(div F)/dQ)^-1 in conservative variables
        (``_block_jac``). Returns (forward solve, transposed solve): (nc,
        5) integral-form residual -> (nc, 5) Q-increment."""
        topo = self.topo
        own, nei = cell_to_face_own, cell_to_face_nei
        P, N, diag = self._block_jac(state, inputs, geom, inv_dt)
        dinv = torch.linalg.inv(diag)

        def offdiag(x):
            """y[own] += N x[nei]; y[nei] += -P x[own]."""
            return face_sum_pair(_mv(N, nei(x, topo)),
                                 -_mv(P, own(x, topo)), topo)

        def offdiag_T(x):
            """y[own] += -P^T x[nei]; y[nei] += N^T x[own]."""
            return face_sum_pair(-_mv(P.transpose(-1, -2), nei(x, topo)),
                                 _mv(N.transpose(-1, -2), own(x, topo)),
                                 topo)

        def make(di, off):
            def solve(b):
                x = _mv(di, b)
                for _ in range(sweeps):
                    x = _mv(di, b - off(x))
                return x
            return solve

        return make(dinv, offdiag), make(dinv.transpose(-1, -2), offdiag_T)

    def _dQdW_blocks(self, state, inputs):
        """The conservative-primitive transform dQ/dW, (nc, 5, 5): rows
        Q = (rho, rhoU, rhoE), columns W = (p, Ux, Uy, Uz, T)."""
        R, gamma, Cv = self._thermo(inputs)[:3]
        U, p, T = state["U"], state["p"], state["T"]
        psi = 1.0 / (R * T)
        rho = p * psi
        E = Cv * T + 0.5 * (U * U).sum(-1)
        z = torch.zeros_like(rho)
        rT = rho / T
        row0 = torch.stack([psi, z, z, z, -rT], dim=-1)
        eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
        mom = torch.cat([(psi[:, None] * U)[:, :, None],
                         rho[:, None, None] * eye3,
                         (-rT[:, None] * U)[:, :, None]], dim=2)
        row4 = torch.cat([(psi * E)[:, None], rho[:, None] * U,
                          (rho * Cv - rho * E / T)[:, None]], dim=1)
        return torch.cat([row0[:, None], mom, row4[:, None]], dim=1)

    def _pc_parts(self, state, inputs):
        opt = self.option["adjEqnOption"]
        geom = self.geometry(inputs)
        inv_dt = self._inv_dtau(state, inputs, geom,
                                float(opt.get("pcCfl", 1e4)))
        pcs = self._block_pc(state, inputs, geom, inv_dt,
                             int(opt.get("pcInnerIters", 12)))
        return geom, pcs, self._dQdW_blocks(state, inputs)

    def make_adjoint_pc(self, state, inputs):
        """The adjoint GMRES PC: the transposed coupled block-Rusanov
        Jacobian (the operator the primal PTC preconditions with).

        The scaled adjoint operator is D_W J^T D_R^-1 with J = dR/dW =
        -(1/V) C dQdW (C the first-order flux Jacobian); its inverse is
        -D_R diag(V) C^-T dQdW^-T D_W^-1, applied with transposed
        block-Jacobi sweeps and a pseudo-time shift (pcCfl). Model states
        pass through. Built from the detached state."""
        with torch.no_grad():
            state = {k: v.detach() for k, v in state.items()}
            geom, (_, pc_T), dQdW = self._pc_parts(state, inputs)
            dQdW_T = dQdW.transpose(-1, -2)
            scales = self.state_scales(geom)

        def prec(v):
            u = _to_blocks(v["p"] / scales["p"], v["U"] / scales["U"],
                           v["T"] / scales["T"])
            w = torch.linalg.solve(dQdW_T, u[..., None])[..., 0]
            y = -pc_T(w) * geom.vol[:, None]
            return dict(v, p=y[:, 0] * scales["p"], U=y[:, 1:4] * scales["U"],
                        T=y[:, 4] * scales["T"])

        return prec

    def make_forward_pc(self, state, inputs):
        """PC of the forward linearized system dR/dW (the same operator,
        untransposed): J^-1 ~ -dQdW^-1 C^-1 diag(V)."""
        with torch.no_grad():
            state = {k: v.detach() for k, v in state.items()}
            geom, (pc_f, _), dQdW = self._pc_parts(state, inputs)

        def prec(r):
            v = geom.vol
            y = pc_f(_to_blocks(r["p"] * v, r["U"] * v[:, None],
                                r["T"] * v))
            dw = -torch.linalg.solve(dQdW, y[..., None])[..., 0]
            return dict(r, p=dw[:, 0], U=dw[:, 1:4], T=dw[:, 4])

        return prec

    # -- the pseudo-transient Newton-Krylov primal -------------------------------
    def solve_primal(self, state, inputs):
        geom = self.geometry(inputs)
        opt = self.option
        h = opt.get("hisa", {})
        cfl0 = float(h.get("cfl", 2.0))
        cfl_max = float(h.get("cflMax", 1e4))
        cfl_min = float(h.get("cflMin", 1.0))
        relax = float(h.get("relax", 1.0))
        # full (unrestarted) GMRES per Newton step: restarted GMRES
        # stagnates on the indefinite high-CFL PTC system
        inner_iters = int(h.get("innerIters", 200))
        inner_tol = float(h.get("innerRelTol", 1e-6))
        pc_iters = int(h.get("pcIters", 8))
        # revert-to-best threshold: reverting (instead of freezing) keeps
        # the state moving once the CFL reaches its floor
        revert = float(h.get("revertFactor", 4.0))
        debug = bool(h.get("debugPrint", False))
        tol = opt["primalMinResTol"]
        max_it, min_it = opt["primalMaxIters"], opt["primalMinIters"]
        tol_diff = float(opt["primalMinResTolDiff"])
        lin = opt["primalLinearSolver"]
        R_, gamma_, Cv_ = self._thermo(inputs)[:3]
        ns = opt["normalizeStates"]
        uref = float(ns.get("U", 1.0))
        pref = float(ns.get("p", 1.0))
        tref = float(ns.get("T", 1.0))
        eref = Cv_ * float(ns.get("T", 300.0)) + 0.5 * uref ** 2
        row_s = {"p": 1.0, "U": uref, "T": eref}
        tiny = guard_tiny(self.dtype)

        def res_flow(st, scheme=None):
            r = self._residuals_geom(st, inputs, geom, scheme=scheme)
            return {k: r[k] for k in FLOW_KEYS}

        def res_norm(r):
            return torch.sqrt((torch.sum((r["U"] / uref) ** 2)
                               + torch.sum((r["p"] / pref) ** 2)
                               + torch.sum((r["T"] / tref) ** 2))
                              / (5.0 * r["p"].shape[0]))

        def one_iter(st, cfl, scheme):
            flow = {k: st[k] for k in FLOW_KEYS}
            Rv = res_flow(st, scheme)
            inv_dt = self._inv_dtau(st, inputs, geom, cfl)
            # the diagonal of dQ/dW: d(rho)/dp = psi, d(rhoU)/dU = rho,
            # d(rhoE)/dT = rho Cv
            rho = st["p"] / (R_ * st["T"])
            mdiag = {"p": 1.0 / (R_ * st["T"]), "U": rho, "T": rho * Cv_}

            # implicit pseudo-time Euler on dQ/dtau = R(W):
            # (diag(dQ/dW)/dtau - dR/dW) dW = R(W), rows scaled to
            # comparable magnitude (rho / rhoU / rhoE units)
            def matvec(v):
                _, jv = adjsolver.jvp(
                    lambda f: res_flow({**st, **f}, scheme), flow, v)
                out = {}
                for k in v:
                    md = mdiag[k] * inv_dt
                    if v[k].ndim == 2:
                        md = md[:, None]
                    out[k] = (md * v[k] - jv[k]) / row_s[k]
                return out

            # coupled block PC in conservative variables, mapped back to
            # primitive with the full dQ/dW block
            pc_solve, _ = self._block_pc(st, inputs, geom, inv_dt, pc_iters)
            dQdW = self._dQdW_blocks(st, inputs)
            vol = geom.vol

            def prec(v):
                xq = pc_solve(_to_blocks(
                    v["p"] * row_s["p"] * vol,
                    v["U"] * row_s["U"] * vol[:, None],
                    v["T"] * row_s["T"] * vol))
                dw = torch.linalg.solve(dQdW, xq[..., None])[..., 0]
                return {"p": dw[:, 0], "U": dw[:, 1:4], "T": dw[:, 4]}

            rhs = {k: Rv[k] / row_s[k] for k in Rv}
            dW, ginfo = gmres(matvec, rhs, precond=prec, restart=inner_iters,
                              rel_tol=inner_tol, abs_tol=0.0,
                              max_iters=inner_iters)
            self._log_solve("ptc_gmres", ginfo)

            # backtracking line search over the Newton direction (the
            # JT-KIRK physicality/line-search role); the winner is picked
            # on the host after the three residual norms
            cands = []
            for a in (1.0, 0.5, 0.25):
                new_f = {k: self._bound(k, st[k] + relax * a * dW[k])
                         for k in FLOW_KEYS}
                cands.append((new_f, res_norm(res_flow({**st, **new_f},
                                                       scheme))))
            rs = torch.stack([r for _, r in cands])
            best = int(torch.argmin(rs))
            new = {**st, **cands[best][0]}
            rnew = rs[best]
            if self.turb.model_states:
                # the model's correct() runs outside the Newton step
                bcos = self._bcos(new, inputs, geom)
                (phi, _, _, U_b, _, _, rho, rho_b, _) = self._fluxes(
                    new, inputs, geom, bcos, scheme=scheme)
                rho_f = fvc.interpolate(geom, self.topo, rho, rho_b)
                new = self.turb.correct(
                    new, inputs, geom, phi / maximum(rho_f, 1e-36),
                    gradU=fvc.grad(geom, self.topo, new["U"], U_b),
                    rel_tol=lin["turbRelTol"],
                    max_iters=lin["turbMaxIters"], relax=0.7)
                rnew = res_norm(res_flow(new, scheme))
            return new, float(rnew)

        def ptc_loop(state0, scheme, cfl, stop_rel, loop_max, loop_min,
                     stop_abs=None):
            """SER-PTC with a best-so-far safeguard: each iteration takes
            the best line-search candidate, the CFL follows the residual
            ratio, and a blow-up beyond ``revert`` x best reverts to the
            best state with a 10x CFL cut. Stops at stop_rel x the loop's
            starting residual, or at stop_abs when given. Returns the best
            state seen."""
            res = float(res_norm(res_flow(state0, scheme)))
            stop_res = stop_rel * res if stop_abs is None else stop_abs
            st = best_st = state0
            best_res, it = res, 0
            while (it < loop_min or res > stop_res) and it < loop_max \
                    and self.states_valid(st):
                st2, rnew = one_iter(st, cfl, scheme)
                bad = rnew > revert * best_res or not self.states_valid(st2)
                ratio = res / max(rnew, tiny)
                cfl_ser = min(max(cfl * min(max(ratio, 0.3), 2.5), cfl_min),
                              cfl_max)
                if debug:
                    print(f"[{scheme}] it={it} res={res:.4e} "
                          f"rnew={rnew:.4e} cfl={cfl:.2e} "
                          f"best={best_res:.4e} bad={bad}", flush=True)
                if bad:
                    st, res, cfl = best_st, best_res, max(cfl * 0.1, cfl_min)
                else:
                    if rnew < best_res:
                        best_st, best_res = st2, rnew
                    st, res, cfl = st2, rnew, cfl_ser
                it += 1
            if best_res < res:
                st = best_st
            return st, cfl, min(best_res, res), it

        r0 = float(res_norm(res_flow(state)))
        # flux sequencing: drive the smooth first-order laxFriedrichs
        # residual into its Newton basin first, then polish with the
        # configured (AUSM/JST) flux warm-started from it
        it1, st, cfl_start = 0, state, cfl0
        if bool(h.get("sequenceFlux", True)) \
                and self.flux_scheme != "laxFriedrichs":
            st, _, _, it1 = ptc_loop(
                state, "laxFriedrichs", cfl0,
                float(h.get("stage1RelTol", 1e-4)),
                int(h.get("stage1MaxIters", 150)), 0)
            cfl_start = float(h.get("stage2Cfl", 50.0))
        st, cfl, res, it2 = ptc_loop(st, self.flux_scheme, cfl_start, tol,
                                     max_it, min_it, stop_abs=tol * r0)
        self.last_cfl = cfl
        ok = self.states_valid(st)
        rel = res / max(r0, 1e-30)
        failed = not ok or (tol > 0 and rel > tol * tol_diff)
        return st, PrimalInfo(it1 + it2, rel, rel <= tol and ok, failed)

    def init_state(self):
        st = super().init_state()
        if float(torch.max(torch.abs(st["T"]))) == 0.0:
            st["T"] = torch.full_like(st["T"], 300.0)
        if float(torch.max(torch.abs(st["p"]))) == 0.0:
            st["p"] = torch.full_like(st["p"], 1e5)
        return st

    # -- function context -----------------------------------------------------------
    def boundary_fields(self, state, inputs, geom):
        bcos = self._bcos(state, inputs, geom)
        return {k: bc.boundary_value(bcos[k], state[k], self.topo)
                for k in FLOW_KEYS}

    def aux_fields(self, state, inputs, geom):
        R, gamma, Cv = self._thermo(inputs)[:3]
        return {"rho": self.rho_of(state, inputs), "gamma": gamma,
                "Cp": Cv * gamma, "R": R}

    def rho_of(self, state, inputs):
        R = self._thermo(inputs)[0]
        return state["p"] / (R * state["T"])

    def function_ctx(self, state, inputs, with_residuals=False):
        ctx = super().function_ctx(state, inputs, with_residuals)
        geom = ctx["geom"]
        topo = self.topo
        ni = topo.n_internal
        bcos = self._bcos(state, inputs, geom)
        U_b = bc.boundary_value(bcos["U"], state["U"], topo)
        gradU = fvc.grad(geom, topo, state["U"], U_b)
        sng_b = bc.boundary_sngrad(bcos["U"], state["U"], topo)
        nhat = geom.sf[ni:] / maximum(geom.magsf[ni:], 1e-36)[:, None]
        gU = boundary_gather(gradU, topo)
        n_g = (nhat[:, :, None] * gU).sum(dim=1)
        ctx["gradU_b"] = gU + nhat[:, :, None] * (sng_b - n_g)[:, None, :]
        mu = self._thermo(inputs)[3]
        rho_b = boundary_gather(self.rho_of(state, inputs), topo)
        ctx["nu_eff_b"] = self.turb.nut_boundary(state, inputs, geom) \
            + mu / maximum(rho_b, 1e-36)
        ctx["rho_ref"] = rho_b
        ctx["rho_b"] = rho_b
        return ctx
