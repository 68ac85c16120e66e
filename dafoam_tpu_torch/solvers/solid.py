"""Linear-elasticity solid solver, displacement formulation (port of
``dafoam_tpu.solvers.solid``).

Reference: DASolidDisplacementFoam: steady div(sigma) = 0 with sigma =
mu (grad D + grad D^T) + lambda tr(grad D) I in OpenFOAM's segregated form,
implicit laplacian(2 mu + lambda, D) plus the explicit remainder
(divSigmaExp). D is an (nc, 3) state: its Picard solves run
component-major through K2 on a banded mesh. ``von_mises`` feeds the
vonMisesStressKS function.
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, maximum
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo


def _trace(t):
    return torch.diagonal(t, dim1=-2, dim2=-1).sum(dim=-1)


def _eye(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _sigma(gradD, mu, lam):
    gt = torch.swapaxes(gradD, -1, -2)
    return mu * (gradD + gt) + lam * _trace(gradD)[..., None, None] \
        * _eye(gradD)


def von_mises(sigma):
    s_dev = sigma - _trace(sigma)[..., None, None] * _eye(sigma) / 3.0
    return torch.sqrt(maximum(1.5 * (s_dev * s_dev).sum(dim=(-2, -1)),
                              1e-36))


class DASolidDisplacementFoam(DASolverBase):
    state_info = StateInfo(vol_vector=("D",))

    def _props(self, inputs):
        p = inputs["params"]
        E = p.get("E", 2e11)
        nu_p = p.get("nuPoisson", 0.3)
        rho = p.get("rhoSolid", 7854.0)
        mu = E / (2.0 * (1.0 + nu_p))
        lam = nu_p * E / ((1.0 + nu_p) * (1.0 - 2.0 * nu_p))
        # plane stress correction (OpenFOAM planeStress option)
        if self.option.get("solidProperties", {}).get("planeStress", False):
            lam = nu_p * E / ((1.0 + nu_p) * (1.0 - nu_p))
        # dimensional, as dafoam_tpu keeps it (mu / rho * rho)
        return mu / rho * rho, lam, rho

    def _bco(self, D, inputs, geom):
        return bc.coeffs(self.bc_spec["D"], inputs["bc"].get("D", {}),
                         self.topo, geom, D, rank=1)

    def _gradD(self, D, bco, geom):
        return fvc.grad(geom, self.topo, D,
                        bc.boundary_value(bco, D, self.topo))

    def _assemble(self, D, inputs, geom):
        topo = self.topo
        mu, lam, _ = self._props(inputs)
        bco = self._bco(D, inputs, geom)
        gamma_f = torch.broadcast_to(
            torch.as_tensor(2.0 * mu + lam, dtype=D.dtype, device=D.device),
            (topo.n_faces,))
        M = -fvm.laplacian(geom, topo, gamma_f, D, bco)
        # explicit: div(mu gradD^T + lam tr(gradD) I - (mu + lam) gradD)
        gradD = self._gradD(D, bco, geom)
        T_cell = mu * torch.swapaxes(gradD, -1, -2) \
            + lam * _trace(gradD)[..., None, None] * _eye(D) \
            - (mu + lam) * gradD
        expl = fvc.div_tensor(geom, topo, T_cell,
                              boundary_gather(T_cell, topo))
        # equation: -lap(c, D) - divSigmaExp = body force
        M = M.add_source(expl * geom.vol[:, None])
        q = inputs["params"].get("bodyForce")
        if q is not None:
            M = M.add_source(torch.broadcast_to(
                torch.as_tensor(q, dtype=D.dtype, device=D.device),
                (topo.n_cells, 3)) * geom.vol[:, None])
        return M

    def residuals(self, state, inputs):
        geom = self.geometry(inputs)
        M = self._assemble(state["D"], inputs, geom)
        return {"D": fvx.residual(M, state["D"], geom, self.topo)}

    def solve_primal(self, state, inputs):
        geom = self.geometry(inputs)
        tol = self.option["primalMinResTol"]
        max_it = self.option["primalMaxIters"]
        # the residuals are dimensional (E ~ 1e11): test them relative to
        # 2 mu + lambda
        mu, lam, _ = self._props(inputs)
        scale = 2.0 * mu + lam
        alpha = self.option["relaxationFactors"]["fields"].get("D", 0.9)
        D, it, res = state["D"], 0, math.inf
        while it < max_it and res > tol:
            M = self._assemble(D, inputs, geom)
            Dn, info = fvsolve.solve(M, D, self.topo, symmetric=False,
                                     rel_tol=1e-12, max_iters=2000)
            self._log_solve("D", info)
            # under-relaxed Picard update for the explicit coupling
            D = D + alpha * (Dn - D)
            M = self._assemble(D, inputs, geom)
            res = float(torch.max(torch.abs(
                fvx.residual(M, D, geom, self.topo))) / scale)
            it += 1
        state = dict(state, D=D)
        ok = self.states_valid(state)
        return state, PrimalInfo(it, res, res <= tol and ok, not ok)

    def aux_fields(self, state, inputs, geom):
        mu, lam, _ = self._props(inputs)
        D = state["D"]
        sig = _sigma(self._gradD(D, self._bco(D, inputs, geom), geom), mu,
                     lam)
        return {"vonMises": von_mises(sig), "sigma": sig}

    def boundary_fields(self, state, inputs, geom):
        D = state["D"]
        return {"D": bc.boundary_value(self._bco(D, inputs, geom), D,
                                       self.topo)}
