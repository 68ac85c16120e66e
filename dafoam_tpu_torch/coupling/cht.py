"""Conjugate heat transfer (aerothermal) coupling.

Port of ``dafoam_tpu.coupling.cht``. Re-designs the reference's CHT path
(SURVEY.md §2.5 coupling protocol; MPhys components
DAFoamThermal/DAFoamFaceCoords, mphys_dafoam.py:862/954;
runRegTests_AeroThermal.py): each side exposes (T_nearwall, kappa/d) on
the coupling faces; the receiving side applies a mixed/Robin BC with
valueFraction = K_nei / (K_my + K_nei).

Instead of OpenMDAO's coupled-adjoint machinery, the two single-discipline
solvers are composed into ONE residual over the union state {fluid: W_f,
solid: W_s} with the exchange computed in-line, so the COUPLED adjoint is
one recorded residual graph re-walked by the port's GMRES, coupling
Jacobian blocks included exactly (``coupled_adjoint``, shared with
``coupling/fsi.py``).
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.adjoint.solver import _detached, _grad, \
    _requiring_grad, vjp
from dafoam_tpu_torch.linalg.krylov import gmres
from dafoam_tpu_torch.utils import tree


def _scale_tree(t, scales, invert=False):
    return {side: {k: (v / scales[side].get(k, 1.0) if invert
                       else v * scales[side].get(k, 1.0))
                   for k, v in sub.items()}
            for side, sub in t.items()}


def state_scales(fluid, solid, inputs_f, inputs_s):
    """The normalizeStates scales of the union state: the metric S in
    which the coupled adjoint solves S dR/dW^T S^-1 (S psi) = S dJ/dW."""
    with torch.no_grad():
        return {"fluid": fluid.state_scales(fluid.geometry(inputs_f)),
                "solid": solid.state_scales(solid.geometry(inputs_s))}


def coupled_adjoint(residuals, func, W, inputs_f, inputs_s, scales,
                    restart, rel_tol, max_iters, return_psi=False):
    """Totals of func(W, inputs_f, inputs_s) w.r.t. both inputs dicts
    through the coupled residual R(W, inputs_f, inputs_s) = 0 over the
    union state W = {"fluid": ..., "solid": ...}:

        dR/dW^T psi = dJ/dW (in the normalizeStates metric, by GMRES),
        dJ/dx = pJ/px - psi^T pR/px.

    Returns (totals w.r.t. inputs_f, totals w.r.t. inputs_s, SolveInfo),
    and psi after them with ``return_psi``.
    """
    xf, xs = _detached(inputs_f), _detached(inputs_s)
    w = _requiring_grad(W)
    with torch.enable_grad():
        J = func(w, xf, xs)
    dJdW = _grad(J, w)
    _, f_vjp = vjp(lambda ww: residuals(ww, xf, xs), W)

    def matT(ps):
        return _scale_tree(f_vjp(_scale_tree(ps, scales, invert=True)),
                           scales)

    psi_s, info = gmres(matT, _scale_tree(dJdW, scales), restart=restart,
                        rel_tol=rel_tol, max_iters=max_iters)
    del f_vjp                                    # frees the W graph
    psi = _scale_tree(psi_s, scales, invert=True)

    # totals w.r.t. both inputs dicts
    Wd = _detached(W)
    x = _requiring_grad({"f": inputs_f, "s": inputs_s})
    with torch.enable_grad():
        J = func(Wd, x["f"], x["s"])
    dJ = _grad(J, x)
    with torch.enable_grad():
        R = residuals(Wd, x["f"], x["s"])
    dR = _grad(R, x, psi)
    tot = tree.tmap(torch.sub, dJ, dR)
    if return_psi:
        return tot["f"], tot["s"], info, psi
    return tot["f"], tot["s"], info


class CHTCoupling:
    def __init__(self, fluid, solid, fluid_patch: str, solid_patch: str):
        """fluid: DASimpleFoam with T enabled; solid: DAHeatTransferFoam.
        The two patches must be geometrically coincident with faces in
        MATCHING ORDER (generate meshes accordingly or permute)."""
        self.fluid = fluid
        self.solid = solid
        self.fp = fluid_patch
        self.sp = solid_patch
        nf = fluid.topo.patch(fluid_patch).size
        ns = solid.topo.patch(solid_patch).size
        assert nf == ns, (nf, ns)

    # -- exchange data ----------------------------------------------------
    def _side_data(self, solver, state, inputs, patch):
        topo = solver.topo
        ni = topo.n_internal
        sl = topo.patch_bslice(patch)
        own = torch.as_tensor(topo.owner[ni:][sl].astype("int64"),
                              device=solver.device)
        geom = solver.geometry(inputs)
        T_near = state["T"][own]
        kappa = solver.thermal_conductance(state, inputs, geom)[sl]
        dc = geom.nonorth_dc[ni:][sl]
        return T_near, kappa * dc  # (T, K=kappa/d)

    def _apply_coupling(self, inputs_f, inputs_s, state_f, state_s):
        """Compute mixed-BC values for both sides from the other side."""
        Tf, Kf = self._side_data(self.fluid, state_f, inputs_f, self.fp)
        Ts, Ks = self._side_data(self.solid, state_s, inputs_s, self.sp)
        # fluid receives solid data
        bc_f = {"refValue": Ts, "refGrad": torch.zeros_like(Ts),
                "valueFraction": Ks / (Kf + Ks)}
        bc_s = {"refValue": Tf, "refGrad": torch.zeros_like(Tf),
                "valueFraction": Kf / (Kf + Ks)}
        inf = dict(inputs_f)
        inf["bc"] = {k: dict(v) for k, v in inputs_f["bc"].items()}
        inf["bc"].setdefault("T", {})[self.fp] = bc_f
        ins = dict(inputs_s)
        ins["bc"] = {k: dict(v) for k, v in inputs_s["bc"].items()}
        ins["bc"].setdefault("T", {})[self.sp] = bc_s
        return inf, ins

    # -- coupled primal (block Gauss-Seidel) --------------------------------
    def solve_primal(self, state_f, state_s, inputs_f, inputs_s,
                     n_outer=20):
        for _ in range(n_outer):
            with torch.no_grad():
                inf, ins = self._apply_coupling(inputs_f, inputs_s, state_f,
                                                state_s)
            state_f, info_f = self.fluid.run_primal(state_f, inf)
            state_s, info_s = self.solid.run_primal(state_s, ins)
        return state_f, state_s, (info_f, info_s)

    # -- coupled residual over the union state -------------------------------
    def residuals(self, W, inputs_f, inputs_s):
        inf, ins = self._apply_coupling(inputs_f, inputs_s, W["fluid"],
                                        W["solid"])
        rf = self.fluid._norm_residuals(W["fluid"], inf)
        rs = self.solid._norm_residuals(W["solid"], ins)
        return {"fluid": rf, "solid": rs}

    def interface_mismatch(self, state_f, state_s, inputs_f, inputs_s):
        """Diagnostics: interface temperature continuity."""
        with torch.no_grad():
            inf, ins = self._apply_coupling(inputs_f, inputs_s, state_f,
                                            state_s)
            bf_T = self.fluid.boundary_fields(state_f, inf,
                                              self.fluid.geometry(inf))["T"]
            bs_T = self.solid.boundary_fields(state_s, ins,
                                              self.solid.geometry(ins))["T"]
            Tf_b = bf_T[self.fluid.topo.patch_bslice(self.fp)]
            Ts_b = bs_T[self.solid.topo.patch_bslice(self.sp)]
            return torch.max(torch.abs(Tf_b - Ts_b))

    # -- coupled adjoint -----------------------------------------------------
    def eval_function(self, W, inputs_f, inputs_s, side, name):
        inf, ins = self._apply_coupling(inputs_f, inputs_s, W["fluid"],
                                        W["solid"])
        if side == "fluid":
            return self.fluid.eval_function(name, W["fluid"], inf)
        return self.solid.eval_function(name, W["solid"], ins)

    def solve_adjoint(self, state_f, state_s, inputs_f, inputs_s,
                      func_side: str, func_name: str,
                      restart=200, rel_tol=1e-9, max_iters=3000,
                      return_psi=False):
        """Total derivatives of one side's function w.r.t. BOTH sides'
        inputs through the coupled system (``coupled_adjoint``)."""
        return coupled_adjoint(
            self.residuals,
            lambda w, xf, xs: self.eval_function(w, xf, xs, func_side,
                                                 func_name),
            {"fluid": state_f, "solid": state_s}, inputs_f, inputs_s,
            state_scales(self.fluid, self.solid, inputs_f, inputs_s),
            restart, rel_tol, max_iters, return_psi)
