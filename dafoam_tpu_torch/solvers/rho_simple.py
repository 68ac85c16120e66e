"""Steady compressible SIMPLE solver (subsonic) and its transonic SIMPLEC
variant (port of ``dafoam_tpu.solvers.rho_simple``).

Reference: DARhoSimpleFoam (residual DAResidualRhoSimpleFoam.C),
DARhoSimpleCFoam (transonic SIMPLEC) and DATurboFoam (with MRF zones).
Perfect-gas thermo (rho = p/(R T), h = Cp T, constant mu), mass-flux
states:

    R_U   = (UEqn & U) + grad(p),  UEqn = div(phi,U) + divDevRhoReff(U)
    R_T   = (EEqn & T) with EEqn = Cp[div(phi,T) - laplacian(alphaEff, T)]
            + div(phi, K) (kinetic-energy transport, K = |U|^2/2)
    R_p   = pEqn & p,  pEqn = laplacian(rho rAU, p) == div(phiHbyA),
            phiHbyA = rho_f flux(HbyA)   [+ psi-convection for transonic]
    R_phi = phiHbyA - pEqn.flux() - phi          (phi = MASS flux)

Turbulence: laminar or a model on the volumetric flux phi/rho_f
(mut = rho nut). One SIMPLE iteration solves U (BiCGStab, K2), T
(BiCGStab, K1), p (CG through K1; BiCGStab for the non-symmetric
transonic equation) and the model states. The solver has no
``primal_step``: its adjoint is the residual form only.

The outer loop is Python; it carries the relaxed density of
``relaxationFactors.fields.rho`` from iteration to iteration and reads the
exit test (residual and state validity) in one host read per iteration.
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch import mrf as mrfm
from dafoam_tpu_torch.adjoint.precond import build_forward_pc, build_pc
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.mesh.walldist import compute_wall_distance
from dafoam_tpu_torch.models import (make_turbulence_model,
                                     turbulence_model_class)
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, clip, maximum
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo


def _divisor(rho_f):
    """rho_f as the divisor of a face flux: maximum(rho_f, 1e-36) as in
    dafoam_tpu, with a neutral 1 where rho_f is 0, the zero-area padded
    faces of the dense layout. There the flux is 0 either way, but a
    1e-36 divisor scales the rounding noise of the (exactly cancelling)
    cotangent by 1e36 (1e20 in the f64 vjp, an overflow risk in f32)."""
    return maximum(torch.where(rho_f > 0.0, rho_f, 1.0), 1e-36)


def FvScale(m, a):
    """The matrix times a scalar (diag, off-diagonals and source)."""
    return fvx.FvMatrix(diag=m.diag * a, lower=m.lower * a,
                        upper=m.upper * a, source=m.source * a)


class DARhoSimpleFoam(DASolverBase):
    transonic = False

    def __init__(self, option, topo, points, *, device, dtype):
        opt = option if isinstance(option, DAOption) else DAOption(option)
        turb_name = opt["turbulenceModel"]
        model_states = turbulence_model_class(turb_name).model_states
        self.state_info = StateInfo(vol_vector=("U",), vol_scalar=("p", "T"),
                                    model=tuple(model_states),
                                    surface_scalar=("phi",))
        super().__init__(opt, topo, points, device=device, dtype=dtype)
        geom0 = compute_geometry(self.points, topo)
        self.wall_dist = self._tensor(compute_wall_distance(
            geom0.cc.cpu().numpy(), points, topo))
        kw = {"bc_spec": self.bc_spec} \
            if turb_name not in ("None", "laminar") else {}
        self.turb = make_turbulence_model(turb_name, topo, self.option,
                                          wall_dist=self.wall_dist, **kw)
        self._user_bounds = (option.get("primalVarBounds", {})
                             if isinstance(option, dict) else {})
        self.turb.setup_wall_functions(self.bc_spec)
        # whether the last primal p solve ran as a symmetric (CG) system
        self.last_p_symmetric = None

    # -- thermo ----------------------------------------------------------
    def _thermo(self, inputs):
        p = inputs["params"]
        return (p.get("Cp", 1004.5), p.get("R", 287.0), p.get("mu", 1.8e-5),
                p.get("Pr", 0.7), p.get("Prt", 0.9))

    def rho_of(self, state, inputs):
        R = self._thermo(inputs)[1]
        return state["p"] / (R * state["T"])

    def _rho_f(self, rho, geom):
        return fvc.interpolate(geom, self.topo, rho,
                               boundary_gather(rho, self.topo))

    # -- BC helpers -------------------------------------------------------
    def _bco(self, name, field, inputs, geom, phi, rank):
        vals = inputs["bc"].get(name, {})
        if name == "U":
            mrf = self.option.get("MRF", {})
            if mrf.get("active") and mrf.get("rotatingPatches"):
                vals = dict(vals)
                vals.update(mrfm.rotating_wall_values(
                    mrf, geom, self.topo, mrf["rotatingPatches"], inputs))
        return bc.coeffs(self.bc_spec[name], vals, self.topo, geom, field,
                         rank=rank, phi_b=phi[self.topo.n_internal:])

    # -- momentum ----------------------------------------------------------
    def _ueqn(self, state, inputs, geom, is_pc=False):
        topo = self.topo
        U, phi = state["U"], state["phi"]
        mu = self._thermo(inputs)[2]
        rho = self.rho_of(state, inputs)
        U_bco = self._bco("U", U, inputs, geom, phi, 1)
        # dynamic effective viscosity
        mu_eff = mu + rho * self.turb.nut(state, inputs, geom)
        mu_eff_b = mu + boundary_gather(rho, topo) \
            * self.turb.nut_boundary(state, inputs, geom)
        mu_eff_f = fvc.interpolate(geom, topo, mu_eff, mu_eff_b)
        scheme = self.option["divSchemes"].get("div(phi,U)", "upwind")
        M = fvm.div(geom, topo, phi, U, U_bco, scheme=scheme, bounded=True) \
            - fvm.laplacian(geom, topo, mu_eff_f, U, U_bco)
        # explicit dev2 transpose term
        gradU = fvc.grad(geom, topo, U, bc.boundary_value(U_bco, U, topo))
        gt = torch.swapaxes(gradU, -1, -2)
        tr = torch.diagonal(gradU, dim1=-2, dim2=-1).sum(dim=-1)
        eye = torch.eye(3, dtype=U.dtype, device=U.device)
        Tc = mu_eff[:, None, None] * (gt - (2.0 / 3.0)
                                      * tr[..., None, None] * eye)
        # mu_eff_b * 0 keeps mu_eff_b in the graph, as dafoam_tpu does
        Tb = mu_eff_b[:, None, None] * 0.0 + boundary_gather(Tc, topo)
        M = M.add_source(fvc.div_tensor(geom, topo, Tc, Tb)
                         * geom.vol[:, None])
        mrf = self.option.get("MRF", {})
        if mrf.get("active"):
            # + rho (Omega x U) in the zone (compressible MRF.DDt)
            dd = rho[:, None] * mrfm.ddt_source(mrf, U, geom, inputs)
            M = M.add_source(-dd * geom.vol[:, None])
        alpha = self.option["relaxationFactors"]["equations"].get("U", 0.7)
        return fvx.relax(M, U, alpha, topo), U_bco

    # -- energy -------------------------------------------------------------
    def _teqn(self, state, inputs, geom):
        topo = self.topo
        U, T, phi = state["U"], state["T"], state["phi"]
        Cp, _, mu, Pr, Prt = self._thermo(inputs)
        rho = self.rho_of(state, inputs)
        T_bco = self._bco("T", T, inputs, geom, phi, 0)
        alpha_eff = mu / Pr + rho * self.turb.nut(state, inputs, geom) / Prt
        alpha_f = fvc.interpolate(geom, topo, alpha_eff,
                                  boundary_gather(alpha_eff, topo))
        M = fvm.div(geom, topo, phi, T, T_bco, scheme="upwind",
                    bounded=True) \
            - fvm.laplacian(geom, topo, alpha_f, T, T_bco)
        M = FvScale(M, Cp)
        # kinetic-energy transport div(phi, K), explicit
        K = 0.5 * (U * U).sum(dim=-1)
        U_b = bc.boundary_value(self._bco("U", U, inputs, geom, phi, 1), U,
                                topo)
        K_b = 0.5 * (U_b * U_b).sum(dim=-1)
        divK = fvc.div(geom, topo, phi, K, K_b)
        return M.add_source(-divK * geom.vol), T_bco

    # -- pressure/flux projection -------------------------------------------
    def _projection(self, state, inputs, geom, UEqn, U_bco, U_pred,
                    transonic=None, rho_override=None):
        """rAU, the face values of rho rAU, HbyA, phiHbyA, the pressure
        matrix, p's BC coefficients and the flux map p -> phi."""
        topo = self.topo
        if transonic is None:
            transonic = self.transonic
        p = state["p"]
        R = self._thermo(inputs)[1]
        rho = self.rho_of(state, inputs) if rho_override is None \
            else rho_override
        p_bco = self._bco("p", p, inputs, geom, state["phi"], 0)

        rAU = 1.0 / fvx.A(UEqn, geom)
        HbyA = rAU[:, None] * fvx.H(UEqn, U_pred, geom, topo)
        HbyA_b = bc.boundary_value(U_bco, U_pred, topo)  # constrained
        rho_f = self._rho_f(rho, geom)
        phiHbyA = rho_f * fvc.flux(geom, topo, HbyA, HbyA_b)
        mrf = self.option.get("MRF", {})
        if mrf.get("active"):
            # mass-flux makeRelative: phi -= rho_f (Omega x r).Sf
            phiHbyA = rho_f * mrfm.make_relative(
                mrf, phiHbyA / _divisor(rho_f), geom, topo, inputs)

        rho_rAU = rho * rAU
        rr_f = fvc.interpolate(geom, topo, rho_rAU,
                               boundary_gather(rho_rAU, topo))
        lapM = fvm.laplacian(geom, topo, rr_f, p, p_bco)

        if transonic:
            # the mass flux linearized in p through rho_f = psi_f p_f:
            # pEqn = div(phid, p) - laplacian(rho rAU, p) = 0,
            # phid = psi_f flux(HbyA); flux(p) = divflux - lapflux
            psi = 1.0 / (R * state["T"])
            psi_f = fvc.interpolate(geom, topo, psi,
                                    boundary_gather(psi, topo))
            phid = psi_f * (phiHbyA / _divisor(rho_f))
            pM = fvm.div(geom, topo, phid, p, p_bco, scheme="upwind") - lapM
            # OpenFOAM's transonic pEqn.relax() for diagonal dominance
            a_eq_p = self.option["relaxationFactors"]["equations"] \
                .get("p", 1.0)
            if a_eq_p < 1.0:
                pM = fvx.relax(pM, p, a_eq_p, topo)

            def flux_fn(p_new):
                return fvm.div_flux(geom, topo, phid, p_new, p_bco) \
                    - fvm.laplacian_flux(geom, topo, rr_f, p_new, p_bco)
        else:
            pM = lapM.add_source(
                fvc.div_surface(geom, topo, phiHbyA) * geom.vol)

            def flux_fn(p_new):
                return phiHbyA - fvm.laplacian_flux(geom, topo, rr_f, p_new,
                                                    p_bco)
        return rAU, rr_f, HbyA, phiHbyA, pM, p_bco, flux_fn

    # -- residuals ----------------------------------------------------------
    def residuals(self, state, inputs):
        geom = self.geometry(inputs)
        topo = self.topo
        U, p, T, phi = state["U"], state["p"], state["T"], state["phi"]
        UEqn, U_bco = self._ueqn(state, inputs, geom)
        p_b = bc.boundary_value(self._bco("p", p, inputs, geom, phi, 0), p,
                                topo)
        r_U = fvx.residual(UEqn, U, geom, topo) \
            + fvc.grad(geom, topo, p, p_b)
        _, _, _, _, pM, _, flux_fn = self._projection(state, inputs, geom,
                                                      UEqn, U_bco, U)
        TEqn, _ = self._teqn(state, inputs, geom)
        out = {"U": r_U, "p": fvx.residual(pM, p, geom, topo),
               "T": fvx.residual(TEqn, T, geom, topo),
               "phi": flux_fn(p) - phi}
        if self.turb.model_states:
            gradU = fvc.grad(geom, topo, U,
                             bc.boundary_value(U_bco, U, topo))
            rho_f = self._rho_f(self.rho_of(state, inputs), geom)
            out.update(self.turb.residuals(state, inputs, geom,
                                           phi / _divisor(rho_f),
                                           gradU=gradU))
        return out

    # -- primal ----------------------------------------------------------------
    def _bound(self, name, v):
        b = dict(self.option["primalVarBounds"])
        b.update(self._user_bounds)
        return clip(v, b.get(name + "Min", -math.inf),
                    b.get(name + "Max", math.inf))

    def init_state(self):
        st = super().init_state()
        geom = compute_geometry(self.points, self.topo)
        inputs = self.make_inputs()
        # phi_b = 0 at the start: every inletOutlet face is an inflow
        Ubco = bc.coeffs(self.bc_spec["U"], inputs["bc"].get("U", {}),
                         self.topo, geom, st["U"], rank=1,
                         phi_b=st["U"].new_zeros((self.topo.n_boundary,)))
        U_b = bc.boundary_value(Ubco, st["U"], self.topo)
        rho_f = self._rho_f(self.rho_of(st, inputs), geom)
        st["phi"] = rho_f * fvc.flux(geom, self.topo, st["U"], U_b)
        return st

    def _one_iter(self, state, inputs, geom, rho_prev, transonic):
        """One SIMPLE iteration: (new state, the relaxed density it used,
        max normalized residual as a 0-d tensor)."""
        topo = self.topo
        opt = self.option
        lin = opt["primalLinearSolver"]
        rf = opt["relaxationFactors"]
        alpha_p = rf["fields"].get("p", 0.3)
        alpha_rho = rf["fields"].get("rho", 1.0)
        U, p, T = state["U"], state["p"], state["T"]
        UEqn, U_bco = self._ueqn(state, inputs, geom)
        p_b = bc.boundary_value(self._bco("p", p, inputs, geom,
                                          state["phi"], 0), p, topo)
        rhs_U = -fvc.grad(geom, topo, p, p_b) * geom.vol[:, None]
        res_U = fvsolve.initial_residual_norm(UEqn, U, topo, rhs=rhs_U)
        U_pred, info = fvsolve.solve(UEqn, U, topo, symmetric=False,
                                     rel_tol=lin["uRelTol"],
                                     max_iters=lin["uMaxIters"], rhs=rhs_U)
        self._log_solve("U", info)
        st = dict(state, U=self._bound("U", U_pred))
        U_pred = st["U"]

        # energy
        TEqn, _ = self._teqn(st, inputs, geom)
        TEqn = fvx.relax(TEqn, T, rf["equations"].get("T", 0.7), topo)
        T_new, info = fvsolve.solve(TEqn, T, topo, symmetric=False,
                                    rel_tol=lin["turbRelTol"],
                                    max_iters=lin["turbMaxIters"])
        self._log_solve("T", info)
        st = dict(st, T=self._bound("T", T_new))

        # pressure, with the relaxed density in the mass flux
        rho_raw = self.rho_of(st, inputs)
        rho_used = rho_prev + alpha_rho * (rho_raw - rho_prev)
        rAU, _, HbyA, _, pM, _, flux_fn = self._projection(
            st, inputs, geom, UEqn, U_bco, U_pred, transonic=transonic,
            rho_override=rho_used)
        res_p = fvsolve.initial_residual_norm(pM, p, topo)
        p_new, info = fvsolve.solve(pM, p, topo, symmetric=not transonic,
                                    rel_tol=lin["pRelTol"],
                                    max_iters=lin["pMaxIters"])
        self._log_solve("p", info)
        self.last_p_symmetric = not transonic
        phi_new = flux_fn(p_new)
        p_rel = self._bound("p", p + alpha_p * (p_new - p))
        p_b3 = bc.boundary_value(self._bco("p", p_rel, inputs, geom, phi_new,
                                           0), p_rel, topo)
        U_new = self._bound(
            "U", HbyA - rAU[:, None] * fvc.grad(geom, topo, p_rel, p_b3))
        st = dict(st, U=U_new, p=p_rel, phi=phi_new)

        if self.turb.model_states:
            rho_f = self._rho_f(self.rho_of(st, inputs), geom)
            U_b = bc.boundary_value(
                self._bco("U", U_new, inputs, geom, phi_new, 1), U_new, topo)
            st = self.turb.correct(st, inputs, geom,
                                   phi_new / _divisor(rho_f),
                                   gradU=fvc.grad(geom, topo, U_new, U_b),
                                   rel_tol=lin["turbRelTol"],
                                   max_iters=lin["turbMaxIters"])
            for name, inf in self.turb.last_solve_info.items():
                self._log_solve(name, inf)
        return st, rho_used, torch.maximum(res_U, res_p)

    def _loop(self, state, inputs, geom, rho, keep, transonic):
        """Iterate while ``keep(it, res)`` holds and the state is valid;
        the residual and the validity come to the host in one read."""
        st, it, res = state, 0, math.inf
        valid = self.states_valid(st)
        while keep(it, res) and valid:
            st, rho, r = self._one_iter(st, inputs, geom, rho, transonic)
            res_h, ok = torch.stack(
                [r.to(torch.float64),
                 self.states_valid_t(st).to(torch.float64)]).tolist()
            res, valid, it = res_h, ok > 0.5, it + 1
        return st, rho, it, res

    def solve_primal(self, state, inputs):
        """SIMPLE iterations until max_res <= primalMinResTol (after at
        least primalMinIters, at most primalMaxIters) or the state turns
        invalid; the transonic subclass warm-starts first (``_pre_loop``)."""
        geom = self.geometry(inputs)
        opt = self.option
        tol = opt["primalMinResTol"]
        min_it, max_it = opt["primalMinIters"], opt["primalMaxIters"]
        state, rho0, it0 = self._pre_loop(state, inputs, geom)
        st, _, it, res = self._loop(
            state, inputs, geom, rho0,
            lambda i, r: (i < min_it or r > tol) and i < max_it,
            self.transonic)
        ok = self.states_valid(st)
        return st, PrimalInfo(it + it0, res, res <= tol and ok, not ok)

    def _pre_loop(self, state, inputs, geom):
        """Hook for formulation sequencing before the main loop (the
        transonic subclass warm-starts with the subsonic formulation)."""
        return state, self.rho_of(state, inputs), 0

    # -- adjoint preconditioner --------------------------------------------
    def _pc_matrices(self, state, inputs, geom):
        with torch.no_grad():
            UEqn, U_bco = self._ueqn(state, inputs, geom, is_pc=True)
            pM = self._projection(state, inputs, geom, UEqn, U_bco,
                                  state["U"])[4]
            TEqn, _ = self._teqn(state, inputs, geom)
        return {"U": (UEqn, False), "p": (pM, not self.transonic),
                "T": (TEqn, False)}

    def make_adjoint_pc(self, state, inputs):
        with torch.no_grad():
            geom = self.geometry(inputs)
            scales = self.state_scales(geom)
        return build_pc(self._pc_matrices(state, inputs, geom), self.topo,
                        geom, scales, self.option["adjEqnOption"])

    def make_forward_pc(self, state, inputs):
        """Untransposed block PC for forward_total_derivative's tangent
        GMRES (precond.build_forward_pc)."""
        with torch.no_grad():
            geom = self.geometry(inputs)
        return build_forward_pc(self._pc_matrices(state, inputs, geom),
                                self.topo, geom, self.option["adjEqnOption"])

    # -- functions --------------------------------------------------------------
    def boundary_fields(self, state, inputs, geom):
        out = {}
        for name, rank in (("U", 1), ("p", 0), ("T", 0)):
            bco = self._bco(name, state[name], inputs, geom, state["phi"],
                            rank)
            out[name] = bc.boundary_value(bco, state[name], self.topo)
        return out

    def function_ctx(self, state, inputs, with_residuals=False):
        ctx = super().function_ctx(state, inputs, with_residuals)
        geom = ctx["geom"]
        topo = self.topo
        ni = topo.n_internal
        rho_own = boundary_gather(self.rho_of(state, inputs), topo)
        ctx["rho_b"] = rho_own
        ctx["rho_ref"] = 1.0  # forces use dimensional p directly
        U = state["U"]
        U_bco = self._bco("U", U, inputs, geom, state["phi"], 1)
        gradU = fvc.grad(geom, topo, U, bc.boundary_value(U_bco, U, topo))
        sng_b = bc.boundary_sngrad(U_bco, U, topo)
        nhat = geom.sf[ni:] / maximum(geom.magsf[ni:], 1e-36)[:, None]
        gU = boundary_gather(gradU, topo)
        n_g = (nhat[:, :, None] * gU).sum(dim=1)
        ctx["gradU_b"] = gU + nhat[:, :, None] * (sng_b - n_g)[:, None, :]
        mu = self._thermo(inputs)[2]
        ctx["nu_eff_b"] = (mu + rho_own * self.turb.nut_boundary(
            state, inputs, geom)) / maximum(rho_own, 1e-36)
        return ctx


class DARhoSimpleCFoam(DARhoSimpleFoam):
    """Transonic SIMPLEC variant (reference DARhoSimpleCFoam).

    The psi-linearized implicit div(phid, p) pressure equation has no
    upstream pressure anchor on a cold uniform start, so the loop first
    runs the subsonic projection (transonicInitRelTol / MaxIters), then
    continues with the transonic one."""
    transonic = True

    def _pre_loop(self, state, inputs, geom):
        opt = self.option
        init_tol = float(opt.get("transonicInitRelTol", 1e-2))
        init_max = int(opt.get("transonicInitMaxIters", 500))
        rho0 = self.rho_of(state, inputs)
        if init_max <= 0:
            return state, rho0, 0
        st, rho_c, it, _ = self._loop(
            state, inputs, geom, rho0,
            lambda i, r: r > init_tol and i < init_max, False)
        return st, rho_c, it


class DATurboFoam(DARhoSimpleFoam):
    """Turbomachinery solver: compressible SIMPLE with MRF rotating zones
    (reference DATurboFoam). The MRF terms activate through option["MRF"]
    (``mrf.py``); the rotation speed is a differentiable input
    (inputs.params.MRF.omega)."""
