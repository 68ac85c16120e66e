"""Steady incompressible SIMPLE solver with turbulence (port of
``dafoam_tpu.solvers.simple``).

Reference: DASimpleFoam (src/adjoint/DASolver/DASimpleFoam/: UEqnSimple.H
momentum predictor, pEqnSimple.H pressure projection). One outer SIMPLE
iteration runs a BiCGStab momentum solve (component-major, K2; skipped
with momentumPredictor off), a pressure solve (K1; Jacobi-CG, or
BiCGStab with the line or multigrid PC), one BiCGStab solve per
turbulence-model state (K1) and, with a T field, one for the passive
temperature (K1). SIMPLEC (simple.consistent), an all-Neumann pressure
(adjustPhi and a reference cell), user U/p bounds, MRF zones
(``mrf.py``), fvSource momentum sources (``fvsource.py``), the
alphaPorosity sink and regression-model production multipliers
(``regression.py``) follow ``dafoam_tpu``.

The outer loop is Python: each iteration reads the max normalized
residual and the state validity on the host (and, with
primalFuncStdTol, the window statistics of the tracked functions).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dafoam_tpu_torch import mrf as mrfm
from dafoam_tpu_torch import regression
from dafoam_tpu_torch.adjoint.precond import build_forward_pc, build_pc
from dafoam_tpu_torch.fvsource import compute_fv_source
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.mesh.walldist import compute_wall_distance
from dafoam_tpu_torch.models import (make_turbulence_model,
                                     turbulence_model_class)
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, maximum, minimum
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo


def _window_stats(vals, n, frac):
    """(relative std, |relative least-squares slope|) of the last
    max(2, round(frac n)) of the first n entries of ``vals`` (reference
    DASolver calcFuncStd/calcFuncSlope), as masked sums over the whole
    row like dafoam_tpu; inf with fewer than two samples."""
    li = n - 1
    window = max(2, int(np.round(frac * (li + 1.0))))
    start = max(0, li - window + 1)
    idx = torch.arange(vals.shape[0], device=vals.device)
    m = ((idx >= start) & (idx <= li)).to(vals.dtype)
    cnt = torch.sum(m)
    mean = torch.sum(vals * m) / (cnt + 1e-16)
    var = torch.sum(m * (vals - mean) ** 2) / (cnt + 1e-16)
    std = torch.sqrt(var) / torch.abs(mean + 1e-16)
    x = (idx - start).to(vals.dtype) * m
    xmean = torch.sum(x * m) / (cnt + 1e-16)
    dx = (x - xmean) * m
    sxy = torch.sum(dx * (vals - mean) * m)
    sxx = torch.sum(dx * dx)
    slope = (sxy / (sxx + 1e-16)) / torch.abs(mean + 1e-16)
    big = torch.full_like(std, math.inf)
    return (torch.where(cnt >= 2, std, big),
            torch.abs(torch.where(cnt >= 2, slope, big)))


class DASimpleFoam(DASolverBase):

    def __init__(self, option, topo, points, *, device, dtype):
        opt = option if isinstance(option, DAOption) else DAOption(option)
        turb_name = opt["turbulenceModel"]
        model_states = turbulence_model_class(turb_name).model_states
        # optional passive temperature field (reference hasTField,
        # DAResidualSimpleFoam.C:50, :215-236)
        self.has_T = "T" in opt.get("boundaryConditions", {})
        self.state_info = StateInfo(
            vol_vector=("U",), vol_scalar=("p", "T") if self.has_T
            else ("p",), model=tuple(model_states),
            surface_scalar=("phi",))
        super().__init__(opt, topo, points, device=device, dtype=dtype)

        # frozen wall distance (meshWaveFrozen semantics), on the host
        geom0 = compute_geometry(self.points, topo)
        wd = compute_wall_distance(geom0.cc.cpu().numpy(), points, topo)
        self.wall_dist = self._tensor(wd)
        kw = {"bc_spec": self.bc_spec} \
            if turb_name not in ("None", "laminar") else {}
        self.turb = make_turbulence_model(turb_name, topo, self.option,
                                          wall_dist=self.wall_dist, **kw)

        self.div_u_scheme = self.option["divSchemes"].get(
            "div(phi,U)", "upwind")
        # an all-Neumann pressure needs adjustPhi and a reference cell
        self.p_needs_ref = not any(
            s["type"] == "fixedValue"
            for s in self.bc_spec.get("p", {}).values())
        # which boundary faces have a fixed (non-adjustable) velocity
        ni = topo.n_internal
        fixed = np.zeros((topo.n_faces - ni,))
        for p in topo.patches:
            s = self.bc_spec.get("U", {}).get(p.name, {"type": "zeroGradient"})
            if s["type"] in ("fixedValue", "noSlip", "empty") \
                    or p.kind == "empty":
                fixed[p.start - ni:p.start - ni + p.size] = 1.0
        self._fixed_flux_b = self._tensor(fixed)
        # U/p bounds apply only when the caller's own option dict gives
        # primalVarBounds (the defaults carry bounds for every field)
        self._user_bounds = (option.get("primalVarBounds", {})
                             if isinstance(option, dict) else {})
        self.turb.setup_wall_functions(self.bc_spec)
        # field inversion / data-driven turbulence: beta multiplier on the
        # SA production (betaFI field and/or regression models)
        if hasattr(self.turb, "beta_fn"):
            self.turb.beta_fn = self._compute_beta

    def regression_n_params(self, model_name):
        cfg = self.option["regressionModel"][model_name]
        if cfg.get("modelType", "neuralNetwork") == "neuralNetwork":
            return regression.nn_sizes(cfg["hiddenLayerNeurons"],
                                       len(cfg["inputNames"]))
        return 2 * cfg["nRBFs"] * len(cfg["inputNames"]) + cfg["nRBFs"]

    def _compute_beta(self, state, inputs, geom, gradU):
        """beta(W; theta): the product of an optional betaFI cell field and
        the active regression models (reference DARegression.compute);
        1.0 when neither is configured."""
        beta = inputs["params"].get("betaFI")
        rm = self.option.get("regressionModel", {})
        reg_par = inputs["params"].get("regressionPar", {})
        if rm.get("active"):
            p = state["p"]
            p_b = bc.boundary_value(
                self._bco_p(p, inputs, geom, state["phi"]), p, self.topo)
            fctx = {"U": state["U"], "gradU": gradU, "p": p,
                    "gradp": fvc.grad(geom, self.topo, p, p_b),
                    "nuTilda": state.get("nuTilda"),
                    "nut": self.turb.nut(state, inputs, geom),
                    "nu": inputs["params"]["nu"] * torch.ones_like(p),
                    "wall_dist": self.wall_dist,
                    "k": state.get("k")}
            for name, cfg in rm.items():
                if name == "active" or not isinstance(cfg, dict):
                    continue
                theta = reg_par.get(name)
                if theta is None:
                    continue
                b = regression.evaluate(cfg, theta, fctx)
                beta = b if beta is None else beta * b
        return 1.0 if beta is None else beta

    # ------------------------------------------------------------------
    # BC helpers
    # ------------------------------------------------------------------
    def _bco_U(self, U, inputs, geom, phi):
        vals = inputs["bc"].get("U", {})
        mrf = self.option.get("MRF", {})
        if mrf.get("active") and mrf.get("rotatingPatches"):
            vals = dict(vals)
            vals.update(mrfm.rotating_wall_values(
                mrf, geom, self.topo, mrf["rotatingPatches"], inputs))
        return bc.coeffs(self.bc_spec["U"], vals, self.topo, geom, U,
                         rank=1, phi_b=phi[self.topo.n_internal:],
                         t=inputs.get("t", 0.0))

    def _bco_p(self, p, inputs, geom, phi):
        return bc.coeffs(self.bc_spec["p"], inputs["bc"].get("p", {}),
                         self.topo, geom, p, rank=0,
                         phi_b=phi[self.topo.n_internal:],
                         t=inputs.get("t", 0.0))

    # ------------------------------------------------------------------
    # shared assembly: momentum eqn + pressure projection pieces
    # ------------------------------------------------------------------
    def _ueqn(self, state, inputs, geom, is_pc=False):
        """The relaxed momentum matrix (the adjoint PC's copy always uses
        upwind convection)."""
        U, phi = state["U"], state["phi"]
        U_bco = self._bco_U(U, inputs, geom, phi)
        scheme = "upwind" if is_pc else self.div_u_scheme
        M = fvm.div(geom, self.topo, phi, U, U_bco, scheme=scheme,
                    bounded=True) \
            + self.turb.divdevreff(U, state, inputs, geom, U_bco)
        mrf = self.option.get("MRF", {})
        if mrf.get("active"):
            # + MRF.DDt(U): contribution += (Omega x U) V in the zone
            M = M.add_source(-mrfm.ddt_source(mrf, U, geom, inputs)
                             * geom.vol[:, None])
        # porosity / topology-optimization sink fvm::Sp(alphaPorosity, U)
        # (the DATopoChtFoam design variable)
        alpha_por = inputs["params"].get("alphaPorosity")
        if alpha_por is not None:
            M = M + fvm.Sp(geom, self.topo, alpha_por, U)
        if self.option.get("fvSource"):
            src = compute_fv_source(self.option, inputs, geom)
            if src is not None:
                # UEqn: ... - fvSource (reference UEqnSimple.H)
                M = M.add_source(src * geom.vol[:, None])
        alpha = self.option["relaxationFactors"]["equations"].get("U", 0.7)
        return fvx.relax(M, U, alpha, self.topo), U_bco

    def _projection(self, state, inputs, geom, UEqn, U_bco, U_pred):
        """rAU, its face values, HbyA, phiHbyA and the pressure matrix. With
        SIMPLEC the first two are rAtU = 1/(1/rAU - H1) (reference
        simple.consistent()); with an all-Neumann pressure phiHbyA is
        adjusted (adjustPhi) and p is pinned in cell 0 to 0."""
        topo = self.topo
        p, phi = state["p"], state["phi"]
        p_bco = self._bco_p(p, inputs, geom, phi)

        rAU = 1.0 / fvx.A(UEqn, geom)
        HbyA = rAU[:, None] * fvx.H(UEqn, U_pred, geom, topo)
        # boundary HbyA: U's value on value-fixing patches (constrainHbyA),
        # else extrapolated
        U_b = bc.boundary_value(U_bco, U_pred, topo)
        HbyA_own = boundary_gather(HbyA, topo)
        if self.option["useConstrainHbyA"]:
            HbyA_b = torch.where(self._fixed_flux_b[:, None] > 0.5,
                                 U_b, HbyA_own)
        else:
            HbyA_b = HbyA_own
        phiHbyA = fvc.flux(geom, topo, HbyA, HbyA_b)
        mrf = self.option.get("MRF", {})
        if mrf.get("active"):
            phiHbyA = mrfm.make_relative(mrf, phiHbyA, geom, topo, inputs)
        if self.p_needs_ref:
            phiHbyA = self._adjust_phi(phiHbyA)
        if self.option["simple"]["consistent"]:
            # SIMPLEC: phiHbyA += interp(rAtU - rAU) snGrad(p) |Sf|,
            # HbyA -= (rAU - rAtU) grad(p)
            rAtU = 1.0 / (1.0 / rAU - fvx.H1(UEqn, geom, topo))
            drA = rAtU - rAU
            drA_f = fvc.interpolate(geom, topo, drA,
                                    boundary_gather(drA, topo))
            snp = fvc.snGrad(geom, topo, p, bc.boundary_sngrad(p_bco, p,
                                                               topo))
            phiHbyA = phiHbyA + drA_f * snp * geom.magsf
            gradp = fvc.grad(geom, topo, p, bc.boundary_value(p_bco, p, topo))
            HbyA = HbyA + drA[:, None] * gradp
            rAU = rAtU

        rAU_f = fvc.interpolate(geom, topo, rAU, boundary_gather(rAU, topo))
        pM = fvm.laplacian(geom, topo, rAU_f, p, p_bco)
        # pEqn: laplacian(rAU, p) == div(phiHbyA)
        pM = pM.add_source(fvc.div_surface(geom, topo, phiHbyA) * geom.vol)
        if self.p_needs_ref:
            pM = fvx.set_reference(pM, 0, 0.0)
        return rAU, rAU_f, HbyA, phiHbyA, pM, p_bco

    def _adjust_phi(self, phiHbyA):
        """Global mass conservation for an all-Neumann pressure (OpenFOAM
        adjustPhi, in the primal and the residual alike): the outflow of
        the adjustable boundary faces is scaled to balance the inflow."""
        ni = self.topo.n_internal
        phib = phiHbyA[ni:]
        fixed = self._fixed_flux_b
        adj = 1.0 - fixed
        outflow = (phib > 0.0).to(phib.dtype)
        mass_in = -torch.sum(phib * (1.0 - outflow))
        fixed_out = torch.sum(phib * outflow * fixed)
        adj_out = torch.sum(phib * outflow * adj)
        corr = (mass_in - fixed_out) / torch.where(
            torch.abs(adj_out) > 1e-36, adj_out, 1.0)
        phib = torch.where((outflow > 0.5) & (adj > 0.5), phib * corr, phib)
        return torch.cat([phiHbyA[:ni], phib])

    def _bound(self, name, v):
        """v clipped to the caller's primalVarBounds ``name``Min/Max."""
        lo = self._user_bounds.get(name + "Min")
        hi = self._user_bounds.get(name + "Max")
        if lo is None and hi is None:
            return v
        if lo is not None:
            v = maximum(v, lo)
        return v if hi is None else minimum(v, hi)

    def equations(self, state, inputs, geom=None):
        """The relaxed momentum, pressure and model matrices as the
        primal step assembles them at ``state`` (the pressure matrix with
        the momentum predictor taken as U itself): {name: FvMatrix}."""
        if geom is None:
            geom = self.geometry(inputs)
        UEqn, U_bco = self._ueqn(state, inputs, geom)
        out = {"U": UEqn, "p": self._projection(state, inputs, geom, UEqn,
                                                 U_bco, state["U"])[4]}
        if self.turb.model_states:
            U_b = bc.boundary_value(U_bco, state["U"], self.topo)
            gradU = fvc.grad(geom, self.topo, state["U"], U_b)
            relax_t = self.option["relaxationFactors"]["equations"].get(
                "nuTilda", 0.7)
            out.update(self.turb.equations(state, inputs, geom,
                                           state["phi"], gradU, relax_t))
        return out

    # ------------------------------------------------------------------
    # passive temperature
    # ------------------------------------------------------------------
    def _bco_T(self, T, inputs, geom, phi):
        return bc.coeffs(self.bc_spec["T"], inputs["bc"].get("T", {}),
                         self.topo, geom, T, rank=0,
                         phi_b=phi[self.topo.n_internal:],
                         t=inputs.get("t", 0.0))

    def _alpha_eff_b(self, state, inputs, geom):
        prm = inputs["params"]
        return prm["nu"] / prm.get("Pr", 0.7) \
            + self.turb.nut_boundary(state, inputs, geom) / prm.get("Prt",
                                                                   0.85)

    def _teqn_simple(self, state, inputs, geom):
        """Passive temperature transport div(phi,T) - laplacian(alphaEff,T)
        with alphaEff = nu/Pr + nut/Prt (reference
        DAResidualSimpleFoam.C:215-236)."""
        topo = self.topo
        T, phi = state["T"], state["phi"]
        prm = inputs["params"]
        T_bco = self._bco_T(T, inputs, geom, phi)
        alpha_eff = prm["nu"] / prm.get("Pr", 0.7) \
            + self.turb.nut(state, inputs, geom) / prm.get("Prt", 0.85)
        alpha_f = fvc.interpolate(geom, topo, alpha_eff,
                                  self._alpha_eff_b(state, inputs, geom))
        M = fvm.div(geom, topo, phi, T, T_bco, scheme="upwind",
                    bounded=True) \
            - fvm.laplacian(geom, topo, alpha_f, T, T_bco)
        return M, T_bco

    def thermal_conductance(self, state, inputs, geom):
        """(nb,) Cp*alphaEff at boundary owners: the kappa piece of the
        CHT protocol, incompressible side (DAOutputThermalCoupling.C:94)."""
        return inputs["params"].get("Cp", 1004.5) \
            * self._alpha_eff_b(state, inputs, geom)

    # ------------------------------------------------------------------
    # residuals (adjoint)
    # ------------------------------------------------------------------
    def residuals(self, state, inputs):
        """R(W) of DAResidualSimpleFoam (per volume): R_U = UEqn & U +
        grad(p), R_p = pEqn & p, R_phi = phiHbyA - pEqn.flux() - phi, and
        the turbulence rows."""
        geom = self.geometry(inputs)
        topo = self.topo
        U, p, phi = state["U"], state["p"], state["phi"]
        UEqn, U_bco = self._ueqn(state, inputs, geom)
        p_b = bc.boundary_value(self._bco_p(p, inputs, geom, phi), p, topo)
        gradp = fvc.grad(geom, topo, p, p_b)
        r_U = fvx.residual(UEqn, U, geom, topo) + gradp

        _, rAU_f, _, phiHbyA, pM, p_bco = self._projection(
            state, inputs, geom, UEqn, U_bco, U)
        r_p = fvx.residual(pM, p, geom, topo)
        r_phi = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f, p, p_bco) \
            - phi
        out = {"U": r_U, "p": r_p, "phi": r_phi}
        if self.has_T:
            TEqn, _ = self._teqn_simple(state, inputs, geom)
            out["T"] = fvx.residual(TEqn, state["T"], geom, topo)
        if self.turb.model_states:
            U_b = bc.boundary_value(U_bco, U, topo)
            gradU = fvc.grad(geom, topo, U, U_b)
            out.update(self.turb.residuals(state, inputs, geom, phi,
                                           gradU=gradU))
        return out

    def _pc_matrices(self, state, inputs, geom):
        """{state: (FvMatrix, symmetric)}: the momentum (upwind), pressure
        and model operators at ``state``, built without a graph."""
        with torch.no_grad():
            UEqn, U_bco = self._ueqn(state, inputs, geom, is_pc=True)
            pM = self._projection(state, inputs, geom, UEqn, U_bco,
                                  state["U"])[4]
            mats = {"U": (UEqn, False), "p": (pM, True)}
            if self.turb.model_states:
                U_b = bc.boundary_value(U_bco, state["U"], self.topo)
                gradU = fvc.grad(geom, self.topo, state["U"], U_b)
                mats.update(self.turb.pc_matrices(state, inputs, geom,
                                                  state["phi"], gradU))
        return mats

    def make_adjoint_pc(self, state, inputs):
        """The residual-form adjoint's preconditioner (precond.build_pc on
        the segregated operators)."""
        with torch.no_grad():
            geom = self.geometry(inputs)
            scales = self.state_scales(geom)
        return build_pc(self._pc_matrices(state, inputs, geom), self.topo,
                        geom, scales, self.option["adjEqnOption"])

    def make_forward_pc(self, state, inputs):
        """PC for the forward linearized system dR/dW (the untransposed
        twin of make_adjoint_pc; see precond.build_forward_pc)."""
        with torch.no_grad():
            geom = self.geometry(inputs)
        return build_forward_pc(self._pc_matrices(state, inputs, geom),
                                self.topo, geom, self.option["adjEqnOption"])

    # ------------------------------------------------------------------
    # primal
    # ------------------------------------------------------------------
    def init_state(self):
        st = super().init_state()
        geom = compute_geometry(self.points, self.topo)
        inputs = self.make_inputs()
        Ubco = bc.coeffs(self.bc_spec["U"], inputs["bc"].get("U", {}),
                         self.topo, geom, st["U"], rank=1,
                         phi_b=st["U"].new_zeros((self.topo.n_boundary,)))
        U_b = bc.boundary_value(Ubco, st["U"], self.topo)
        st["phi"] = fvc.flux(geom, self.topo, st["U"], U_b)
        return st

    def primal_step(self, state, inputs, geom=None):
        """ONE outer SIMPLE iteration w_{k+1} = G(w_k). Returns
        (new_state, max_normalized_residual as a 0-d tensor)."""
        if geom is None:
            geom = self.geometry(inputs)
        topo = self.topo
        opt = self.option
        lin = opt["primalLinearSolver"]
        alpha_p = opt["relaxationFactors"]["fields"].get("p", 0.3)

        U, p = state["U"], state["p"]
        UEqn, U_bco = self._ueqn(state, inputs, geom)
        p_bco = self._bco_p(p, inputs, geom, state["phi"])
        p_b = bc.boundary_value(p_bco, p, topo)
        gradp = fvc.grad(geom, topo, p, p_b)
        rhs_U = -gradp * geom.vol[:, None]
        res_U = fvsolve.initial_residual_norm(UEqn, U, topo, rhs=rhs_U)

        if opt["simple"]["momentumPredictor"]:
            U_pred, info = fvsolve.solve(
                UEqn, U, topo, symmetric=False, rel_tol=lin["uRelTol"],
                max_iters=lin["uMaxIters"], rhs=rhs_U)
            self._log_solve("U", info)
            U_pred = self._bound("U", U_pred)
        else:
            U_pred = U

        rAU, rAU_f, HbyA, phiHbyA, pM, p_bco = self._projection(
            state, inputs, geom, UEqn, U_bco, U_pred)
        res_p = fvsolve.initial_residual_norm(pM, p, topo)
        p_new, info = fvsolve.solve(pM, p, topo, symmetric=True,
                                    rel_tol=lin["pRelTol"],
                                    max_iters=lin["pMaxIters"],
                                    pc=lin.get("pPC", "jacobi"))
        self._log_solve("p", info)
        phi_new = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f, p_new,
                                               p_bco)
        # explicit pressure relaxation, then momentum corrector
        p_rel = self._bound("p", p + alpha_p * (p_new - p))
        p_bco2 = self._bco_p(p_rel, inputs, geom, phi_new)
        p_b2 = bc.boundary_value(p_bco2, p_rel, topo)
        gradp2 = fvc.grad(geom, topo, p_rel, p_b2)
        U_new = self._bound("U", HbyA - rAU[:, None] * gradp2)

        new_state = dict(state, U=U_new, p=p_rel, phi=phi_new)

        if self.turb.model_states:
            U_b = bc.boundary_value(U_bco, U_new, topo)
            gradU = fvc.grad(geom, topo, U_new, U_b)
            relax_t = opt["relaxationFactors"]["equations"].get(
                "nuTilda", 0.7)
            new_state = self.turb.correct(
                new_state, inputs, geom, phi_new, gradU=gradU,
                rel_tol=lin["turbRelTol"], max_iters=lin["turbMaxIters"],
                relax=relax_t)
            for name, info in self.turb.last_solve_info.items():
                self._log_solve(name, info)

        if self.has_T:
            TEqn, _ = self._teqn_simple(new_state, inputs, geom)
            alpha_T = opt["relaxationFactors"]["equations"].get("T", 0.7)
            TEqn = fvx.relax(TEqn, new_state["T"], alpha_T, topo)
            T_new, info = fvsolve.solve(TEqn, new_state["T"], topo,
                                        symmetric=False,
                                        rel_tol=lin["turbRelTol"],
                                        max_iters=lin["turbMaxIters"])
            self._log_solve("T", info)
            new_state = dict(new_state, T=self._bound("T", T_new))

        return new_state, torch.maximum(res_U, res_p)

    def solve_primal(self, state, inputs):
        """SIMPLE iterations until max_res <= primalMinResTol (after at
        least primalMinIters, at most primalMaxIters) or the state turns
        invalid; with primalFuncStdTol, also until the tracked functions'
        trailing-window relative std and slope both fall under their
        tolerances (reference DASolver::loop). useMeanStates replaces the
        final state by the running mean over the iterations from
        meanStateStart x primalMaxIters on (phi keeps its final value)."""
        opt = self.option
        geom = self.geometry(inputs)
        tol = opt["primalMinResTol"]
        max_it = int(opt["primalMaxIters"])
        min_it = opt["primalMinIters"]
        print_int = int(opt["printInterval"])
        do_print = bool(opt.get("printToScreen", False))

        use_mean = bool(opt["useMeanStates"])
        start_it = int(float(opt.get("meanStateStart", 0.5)) * max_it)
        mean = {k: torch.zeros_like(v) for k, v in state.items()} \
            if use_mean else None

        fscfg = opt["primalFuncStdTol"]
        std_tol = float(fscfg.get("stdTol", -1.0))
        slope_tol = float(fscfg.get("slopeTol", -1.0))
        if std_tol > 0 and slope_tol <= 0:
            slope_tol = std_tol      # reference DASolver.C:105
        func_names = [n for n in fscfg.get("funcNames", [])
                      if n in opt["function"]]
        track = std_tol > 0 and len(func_names) > 0
        frac = float(fscfg.get("nStepsFrac", 0.2))
        fvals = state["p"].new_zeros((len(func_names), max_it))
        fstd = fslope = math.inf

        def func_conv():
            return fstd < std_tol and fslope < slope_tol

        def unconverged():
            if track:
                return not (res <= tol or func_conv())
            return res > tol

        st, it, res = state, 0, math.inf
        while (it < min_it or unconverged()) and it < max_it \
                and self.states_valid(st):
            st, res_t = self.primal_step(st, inputs, geom)
            if use_mean and it >= start_it:
                cnt = it + 1 - start_it
                mean = {k: m + (st[k] - m) / cnt if k != "phi" else m
                        for k, m in mean.items()}
            if track:
                stats = []
                for j, name in enumerate(func_names):
                    fvals[j, it] = self.eval_function(name, st, inputs)
                    stats.append(_window_stats(fvals[j], it + 1, frac))
                stats = torch.stack([torch.stack(t) for t in stats])
                fstd, fslope = (float(v) for v in stats.max(dim=0).values)
            res = float(res_t)
            it += 1
            if do_print and it % print_int == 0:
                extra = f" funcStd={fstd:.6e} funcSlope={fslope:.6e}" \
                    if track else ""
                print(f"iter {it}: maxRes = {res:.6e}{extra}")
        if use_mean and it > start_it:
            st = {k: mean[k] if k != "phi" else v for k, v in st.items()}
        ok = self.states_valid(st)
        if track:
            # func-std mode never fails on the residual (DASolver.C:2730)
            conv = (res <= tol or func_conv()) and ok
            return st, PrimalInfo(it, res, conv, not ok)
        # checkPrimalFailure parity (reference DASolver.C:2721): fail when
        # the achieved residual misses primalMinResTol*TolDiff
        failed = not ok
        if tol > 0:
            failed = failed or res > tol * float(opt["primalMinResTolDiff"])
        return st, PrimalInfo(it, res, res <= tol and ok, failed)

    # ------------------------------------------------------------------
    # function context
    # ------------------------------------------------------------------
    def boundary_fields(self, state, inputs, geom):
        topo = self.topo
        U, p, phi = state["U"], state["p"], state["phi"]
        U_bco = self._bco_U(U, inputs, geom, phi)
        p_bco = self._bco_p(p, inputs, geom, phi)
        out = {"U": bc.boundary_value(U_bco, U, topo),
               "p": bc.boundary_value(p_bco, p, topo)}
        if self.has_T:
            out["T"] = bc.boundary_value(
                self._bco_T(state["T"], inputs, geom, phi), state["T"], topo)
        return out

    def function_ctx(self, state, inputs, with_residuals=False):
        ctx = super().function_ctx(state, inputs, with_residuals)
        geom = ctx["geom"]
        topo = self.topo
        ni = topo.n_internal
        U, phi = state["U"], state["phi"]
        U_bco = self._bco_U(U, inputs, geom, phi)
        U_b = bc.boundary_value(U_bco, U, topo)
        gradU = fvc.grad(geom, topo, U, U_b)
        sng_b = bc.boundary_sngrad(U_bco, U, topo)
        nhat = geom.sf[ni:] / torch.clamp_min(geom.magsf[ni:], 1e-36)[:, None]
        gU_own = boundary_gather(gradU, topo)
        n_g = (nhat[:, :, None] * gU_own).sum(dim=1)
        ctx["gradU_b"] = gU_own + nhat[:, :, None] * (sng_b - n_g)[:, None, :]
        nu = inputs["params"]["nu"]
        ctx["nu_eff_b"] = self.turb.nut_boundary(state, inputs, geom) + nu
        ctx["rho_ref"] = inputs["params"].get("rhoRef", 1.0)
        if "patchVelocity" in inputs.get("aoa", {}):
            ctx["aoa_rad"] = inputs["aoa"]["patchVelocity"][1] * math.pi \
                / 180.0
        return ctx
