"""Passive-scalar convection-diffusion solver (port of
``dafoam_tpu.solvers.scalar_transport``).

Reference: DAScalarTransportFoam (residual
DAResidualScalarTransportFoam.C:57-84: TEqn = ddt(T) + div(phi,T) -
laplacian(DT,T)). The convecting velocity is a frozen input
(``inputs["params"]["U"]``); T is the only state. Steady mode drops ddt
and Picard-iterates the (linear up to the deferred non-orthogonal
correction) equation; the unsteady mode takes implicit Euler steps and
keeps their history. Every solve is BiCGStab through K1.

The residual-form adjoint honours ``adjEqnOption.pcType`` with the T
block (its transposed products through K3a), where dafoam_tpu runs this
solver's GMRES unpreconditioned; psi agrees at the GMRES tolerance.
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.adjoint.precond import build_forward_pc, build_pc
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.states import StateInfo


class DAScalarTransportFoam(DASolverBase):
    state_info = StateInfo(vol_scalar=("T",))

    def __init__(self, option, topo, points, *, device, dtype):
        super().__init__(option, topo, points, device=device, dtype=dtype)
        self.div_scheme = self.option["divSchemes"].get("div(phi,T)",
                                                        "upwind")
        self.steady = self.option["ddtScheme"] == "steadyState"

    # -- flux from the frozen convecting velocity ----------------------
    def _phi(self, inputs, geom):
        U = inputs["params"]["U"]          # (nc,3) frozen convecting field
        Ub = bc.coeffs(self.bc_spec.get("U", {}), inputs["bc"].get("U", {}),
                       self.topo, geom, U, rank=1)
        return fvc.flux(geom, self.topo, U,
                        bc.boundary_value(Ub, U, self.topo))

    def _assemble(self, T, inputs, geom, phi):
        bco = bc.coeffs(self.bc_spec["T"], inputs["bc"].get("T", {}),
                        self.topo, geom, T, rank=0,
                        phi_b=phi[self.topo.n_internal:])
        gamma_f = torch.broadcast_to(inputs["params"]["DT"],
                                     (self.topo.n_faces,))
        return fvm.div(geom, self.topo, phi, T, bco, scheme=self.div_scheme) \
            - fvm.laplacian(geom, self.topo, gamma_f, T, bco)

    def residuals(self, state, inputs):
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        T = state["T"]
        r = fvx.residual(self._assemble(T, inputs, geom, phi), T, geom,
                         self.topo)
        if not self.steady:
            r = r + (T - inputs["T_old"]) / self.option["deltaT"]
        return {"T": r}

    def solve_primal(self, state, inputs):
        if not self.steady:
            st, info, _ = self.solve_primal_history(state, inputs)
            return st, info
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        tol = self.option["primalMinResTol"]
        # Picard: assemble at the current T, solve, repeat until the
        # freshly assembled residual meets primalMinResTol (at most 50)
        T, it, res = state["T"], 0, math.inf
        while it < 50 and res > tol:
            M = self._assemble(T, inputs, geom, phi)
            T, info = fvsolve.solve(M, T, self.topo, symmetric=False,
                                    rel_tol=1e-14, max_iters=5000)
            self._log_solve("T", info)
            M = self._assemble(T, inputs, geom, phi)
            res = float(torch.max(torch.abs(
                fvx.residual(M, T, geom, self.topo))))
            it += 1
        state = dict(state, T=T)
        return state, PrimalInfo(it, res, res <= tol,
                                 not self.states_valid(state))

    def solve_primal_history(self, state, inputs):
        """The unsteady branch: round(endTime/deltaT) implicit Euler steps.
        Returns (final state, PrimalInfo, history (n_steps, nc) of T after
        each step)."""
        geom = self.geometry(inputs)
        phi = self._phi(inputs, geom)
        dt = self.option["deltaT"]
        n_steps = int(round(self.option["endTime"] / dt))
        v = geom.vol
        T, hist = state["T"], []
        for _ in range(n_steps):
            M = self._assemble(T, inputs, geom, phi)
            M = M._replace(diag=M.diag + v / dt, source=M.source + v / dt * T)
            T, info = fvsolve.solve(M, T, self.topo, symmetric=False,
                                    rel_tol=1e-12, max_iters=1000)
            self._log_solve("T", info)
            hist.append(T)
        state = dict(state, T=T)
        hist = torch.stack(hist) if hist else T.new_zeros((0,) + T.shape)
        return state, PrimalInfo(n_steps, 0.0, True,
                                 not self.states_valid(state)), hist

    # -- adjoint preconditioner ------------------------------------------
    def _pc_matrices(self, state, inputs, geom):
        """{"T": (dR/dT as an FvMatrix, symmetric)}: the transport matrix,
        plus V/deltaT on the diagonal in the unsteady mode."""
        with torch.no_grad():
            M = self._assemble(state["T"], inputs, geom,
                               self._phi(inputs, geom))
            if not self.steady:
                M = M._replace(diag=M.diag + geom.vol
                               / self.option["deltaT"])
        return {"T": (M, False)}

    def make_adjoint_pc(self, state, inputs):
        with torch.no_grad():
            geom = self.geometry(inputs)
            scales = self.state_scales(geom)
        return build_pc(self._pc_matrices(state, inputs, geom), self.topo,
                        geom, scales, self.option["adjEqnOption"])

    def make_forward_pc(self, state, inputs):
        with torch.no_grad():
            geom = self.geometry(inputs)
        return build_forward_pc(self._pc_matrices(state, inputs, geom),
                                self.topo, geom, self.option["adjEqnOption"])

    def boundary_fields(self, state, inputs, geom):
        phi = self._phi(inputs, geom)
        bco = bc.coeffs(self.bc_spec["T"], inputs["bc"].get("T", {}),
                        self.topo, geom, state["T"], rank=0,
                        phi_b=phi[self.topo.n_internal:])
        return {"T": bc.boundary_value(bco, state["T"], self.topo)}

    def function_ctx(self, state, inputs, with_residuals=False):
        ctx = super().function_ctx(state, inputs, with_residuals)
        ctx["phi"] = self._phi(inputs, ctx["geom"])
        return ctx
