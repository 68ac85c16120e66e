"""Solid heat conduction with optional P1 radiation (port of
``dafoam_tpu.solvers.heat_transfer``).

Reference: DAHeatTransferFoam: steady laplacian(kappa, T) with optional
heat sources == 0; kappa may be a per-cell field (a differentiable input,
the reference's variable-kappa case). A "G" entry in boundaryConditions
adds the P1 incident-radiation field G as a second state (reference
DARadiationModel/DAP1): -laplacian(1/(3(a+sigma_s)), G) + a G = 4 e
sigma T^4, with a G - 4 e sigma T^4 in the energy balance. The primal
alternates a CG solve of T (K1) and a BiCGStab solve of G (K1).
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.fvsource import compute_heat_source
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, maximum
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo


class DAHeatTransferFoam(DASolverBase):
    state_info = StateInfo(vol_scalar=("T",))
    SIGMA_SB = 5.670374419e-8

    def __init__(self, option, topo, points, *, device, dtype):
        bcs = (option.get("boundaryConditions", {})
               if isinstance(option, dict) else option["boundaryConditions"])
        self.has_radiation = "G" in bcs
        if self.has_radiation:
            self.state_info = StateInfo(vol_scalar=("T", "G"))
        super().__init__(option, topo, points, device=device, dtype=dtype)

    def _rad_props(self, inputs):
        p = inputs["params"]
        a = p.get("radiationAbsorptivity", 0.5)
        return a, p.get("radiationScatter", 0.0), \
            p.get("radiationEmissivity", a)

    def _bco(self, name, field, inputs, geom):
        return bc.coeffs(self.bc_spec[name], inputs["bc"].get(name, {}),
                         self.topo, geom, field, rank=0)

    def _assemble_G(self, state, inputs, geom):
        a, sig_s, e = self._rad_props(inputs)
        G, T = state["G"], state["T"]
        gamma = 1.0 / maximum(torch.as_tensor(3.0 * (a + sig_s),
                                              dtype=G.dtype,
                                              device=G.device), 1e-12)
        gamma_f = torch.broadcast_to(gamma, (self.topo.n_faces,))
        M = -fvm.laplacian(geom, self.topo, gamma_f, G,
                           self._bco("G", G, inputs, geom)) \
            + fvm.Sp(geom, self.topo, torch.full_like(G, 1.0) * a, G)
        return M.add_source(4.0 * e * self.SIGMA_SB * T ** 4 * geom.vol)

    def _radiative_heat(self, state, inputs):
        a, _, e = self._rad_props(inputs)
        return a * state["G"] - 4.0 * e * self.SIGMA_SB * state["T"] ** 4

    def _kappa_f(self, inputs, geom):
        kappa = inputs["params"]["kappa"]
        if kappa.ndim == 0:
            return torch.broadcast_to(kappa, (self.topo.n_faces,))
        return fvc.interpolate(geom, self.topo, kappa,
                               boundary_gather(kappa, self.topo))

    def _assemble(self, T, inputs, geom, state=None):
        M = -fvm.laplacian(geom, self.topo, self._kappa_f(inputs, geom), T,
                           self._bco("T", T, inputs, geom))
        q = inputs["params"].get("heatSource")
        if q is not None:
            M = M.add_source(torch.broadcast_to(q, geom.vol.shape)
                             * geom.vol)
        if self.option.get("fvSource"):
            qs = compute_heat_source(self.option, inputs, geom)
            if qs is not None:
                M = M.add_source(qs * geom.vol)
        if self.has_radiation and state is not None:
            M = M.add_source(self._radiative_heat(dict(state, T=T), inputs)
                             * geom.vol)
        return M

    def residuals(self, state, inputs):
        geom = self.geometry(inputs)
        M = self._assemble(state["T"], inputs, geom, state=state)
        out = {"T": fvx.residual(M, state["T"], geom, self.topo)}
        if self.has_radiation:
            MG = self._assemble_G(state, inputs, geom)
            out["G"] = fvx.residual(MG, state["G"], geom, self.topo)
        return out

    def solve_primal(self, state, inputs):
        geom = self.geometry(inputs)
        tol = self.option["primalMinResTol"]
        # under-relax T when radiation couples T^4 back into the source
        alpha = 0.7 if self.has_radiation else 1.0
        st, it, res = state, 0, math.inf
        while it < 100 and res > tol:
            M = self._assemble(st["T"], inputs, geom, state=st)
            Tn, info = fvsolve.solve(M, st["T"], self.topo, symmetric=True,
                                     rel_tol=1e-14, max_iters=10000)
            self._log_solve("T", info)
            st = dict(st, T=st["T"] + alpha * (Tn - st["T"]))
            if self.has_radiation:
                MG = self._assemble_G(st, inputs, geom)
                Gn, info = fvsolve.solve(MG, st["G"], self.topo,
                                         symmetric=False, rel_tol=1e-12,
                                         max_iters=2000)
                self._log_solve("G", info)
                st = dict(st, G=Gn)
            r = self.residuals(st, inputs)
            res = float(torch.stack([torch.max(torch.abs(v))
                                     for v in r.values()]).max())
            it += 1
        return st, PrimalInfo(it, res, res <= tol,
                              not self.states_valid(st))

    def boundary_fields(self, state, inputs, geom):
        bco = self._bco("T", state["T"], inputs, geom)
        return {"T": bc.boundary_value(bco, state["T"], self.topo)}

    def aux_fields(self, state, inputs, geom):
        k = inputs["params"].get("kappa")
        return {"kappa": k} if k is not None and k.ndim > 0 else {}

    def thermal_conductance(self, state, inputs, geom):
        """(nb,) conductivity at boundary-face owners: the kappa part of
        the CHT protocol (reference DAOutputThermalCoupling.C:94-149)."""
        k = inputs["params"]["kappa"]
        if k.ndim == 0:
            return torch.broadcast_to(k, (self.topo.n_boundary,))
        return boundary_gather(k, self.topo)
