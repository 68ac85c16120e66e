"""Turbulence-model family (port of ``dafoam_tpu.models.base``).

Models are plain objects whose methods are functions of the state dict.
Model states (nuTilda, ...) are ordinary extra keys of the state.

Each model provides:
  nut(state, inputs, geom)        eddy viscosity from model states
  nut_with_grad(..., gradU)       the same given the velocity gradient (the
                                  strain-limited SST form overrides it)
  divdevreff(U, ...)              the momentum-equation stress term
                                  -div(nuEff grad U) - div(nuEff dev2(gradU^T))
  correct(...)                    one primal update of the model states
  residuals(...), pc_matrices(...) the model rows of the adjoint's residual
                                  and their block-PC operators
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.models.wallfunctions import spalding_nut_wall
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, float_tensor, maximum


class TurbulenceModel:
    model_states: tuple[str, ...] = ()

    def __init__(self, topo, option, wall_dist=None):
        self.topo = topo
        self.option = option
        self.wall_dist = wall_dist  # (nc,) frozen (meshWaveFrozen)
        self.last_solve_info = {}    # {model state: SolveInfo}, correct()

    # -- eddy viscosity ------------------------------------------------
    def nut(self, state, inputs, geom):
        raise NotImplementedError

    def nu(self, inputs):
        return inputs["params"]["nu"]

    def nu_eff_faces(self, state, inputs, geom):
        """(nu + nut on every face, nu + nut per cell, nu + nut per
        boundary face)."""
        nu = self.nu(inputs)
        nu_eff = self.nut(state, inputs, geom) + nu
        nu_eff_b = self.nut_boundary(state, inputs, geom) + nu
        return (fvc.interpolate(geom, self.topo, nu_eff, nu_eff_b), nu_eff,
                nu_eff_b)

    def setup_wall_functions(self, full_bc_spec):
        """Spalding wall functions on the patches whose ``nut`` BC type is
        nutUSpaldingWallFunction (reference nutUSpaldingWallFunctionDF)."""
        spec = full_bc_spec.get("nut", {})
        ni = self.topo.n_internal
        m = np.zeros((self.topo.n_faces - ni,))
        for p in self.topo.patches:
            if spec.get(p.name, {}).get("type") == \
                    "nutUSpaldingWallFunction":
                m[p.start - ni:p.start - ni + p.size] = 1.0
        self._wf_mask = m if m.any() else None

    def nut_boundary(self, state, inputs, geom):
        """Boundary nut: owner value off-wall; at walls zero (low-Re) or,
        where configured, Spalding's wall-function value."""
        topo = self.topo
        nut = self.nut(state, inputs, geom)
        out = boundary_gather(nut, topo) * (1.0 - self._wall_mask(geom))
        wf = getattr(self, "_wf_mask", None)
        if wf is not None and "U" in state:
            ni = topo.n_internal
            nhat = geom.sf[ni:] / maximum(geom.magsf[ni:], 1e-36)[:, None]
            Uo = boundary_gather(state["U"], topo)
            Ut = Uo - (Uo * nhat).sum(dim=-1)[:, None] * nhat
            mag_ut = torch.sqrt(maximum((Ut * Ut).sum(dim=-1), 1e-36))
            y = 1.0 / maximum(geom.nonorth_dc[ni:], 1e-36)
            nut_wf = spalding_nut_wall(mag_ut, y, self.nu(inputs))
            mask = torch.as_tensor(wf, dtype=out.dtype, device=out.device)
            out = torch.where(mask > 0.5, nut_wf, out)
        return out

    def _wall_mask(self, geom):
        topo = self.topo
        ni = topo.n_internal

        def make():
            m = np.zeros((topo.n_faces - ni,))
            for p in topo.patches:
                if p.kind == "wall":
                    m[p.start - ni:p.start - ni + p.size] = 1.0
            return m

        return float_tensor(topo, "wall_mask", geom.vol.device,
                            geom.vol.dtype, make)

    # -- momentum stress term -----------------------------------------
    def nut_with_grad(self, state, inputs, geom, gradU):
        """nut given the velocity gradient (the default ignores gradU)."""
        return self.nut(state, inputs, geom)

    def divdevreff(self, U, state, inputs, geom, U_bco) -> fvx.FvMatrix:
        """-laplacian(nuEff, U) - div(nuEff dev2(T(grad U))) as an FvMatrix
        (implicit laplacian + explicit transpose/deviatoric part), matching
        the role of daTurb_->divDevReff(U) in DAResidualSimpleFoam.C:145."""
        topo = self.topo
        U_b = bc.boundary_value(U_bco, U, topo)
        gradU = fvc.grad(geom, topo, U, U_b)           # (nc,3,3) d_i U_j
        nu = self.nu(inputs)
        nu_eff = self.nut_with_grad(state, inputs, geom, gradU) + nu
        nu_eff_b = self.nut_boundary(state, inputs, geom) + nu
        nu_eff_f = fvc.interpolate(geom, topo, nu_eff, nu_eff_b)
        M = -fvm.laplacian(geom, topo, nu_eff_f, U, U_bco, grad_psi=gradU)
        # explicit: -div( nuEff * dev2(gradU^T) )
        ni = topo.n_internal
        # boundary gradient: replace normal component with BC snGrad
        sng_b = bc.boundary_sngrad(U_bco, U, topo)      # (nb,3)
        nhat = geom.sf[ni:] / torch.clamp_min(geom.magsf[ni:], 1e-36)[:, None]
        gU_own = boundary_gather(gradU, topo)
        n_g = (nhat[:, :, None] * gU_own).sum(dim=1)     # nhat . gradU
        gU_b = gU_own + nhat[:, :, None] * (sng_b - n_g)[:, None, :]

        def dev2T(g):
            # dev2(A) = A - (2/3) tr(A) I, applied to A = gradU^T
            gt = torch.swapaxes(g, -1, -2)
            tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(dim=-1)
            eye = torch.eye(3, dtype=g.dtype, device=g.device)
            return gt - (2.0 / 3.0) * tr[..., None, None] * eye

        T_cell = nu_eff[:, None, None] * dev2T(gradU)
        T_b = nu_eff_b[:, None, None] * dev2T(gU_b)
        expl = fvc.div_tensor(geom, topo, T_cell, T_b)  # (nc,3) per-volume
        # contribution must be -expl: add +expl*V to source
        return M.add_source(expl * geom.vol[:, None])

    # -- model transport ----------------------------------------------
    def equations(self, state, inputs, geom, phi, gradU, relax) -> dict:
        """{model state: relaxed transport FvMatrix} at ``state``."""
        return {}

    def residuals(self, state, inputs, geom, phi, gradU=None) -> dict:
        """{model state: its residual (per volume)} at ``state``."""
        return {}

    def pc_matrices(self, state, inputs, geom, phi, gradU) -> dict:
        """{model state: (FvMatrix, symmetric)} for the adjoint block PC."""
        return {}

    def correct(self, state, inputs, geom, phi, **kw):
        """One primal iteration of the model equations; returns the new
        state and leaves {model state: SolveInfo} in last_solve_info."""
        return state

    def _solve(self, name, M, state, rel_tol, max_iters):
        """The model equation ``name``'s inner BiCGStab solve (logged in
        last_solve_info)."""
        sol, self.last_solve_info[name] = fvsolve.solve(
            M, state[name], self.topo, symmetric=False, rel_tol=rel_tol,
            max_iters=max_iters)
        return sol


class Laminar(TurbulenceModel):
    """No model states; nut = 0."""

    def nut(self, state, inputs, geom):
        return torch.zeros_like(geom.vol)

    def nut_boundary(self, state, inputs, geom):
        return geom.vol.new_zeros((self.topo.n_boundary,))
