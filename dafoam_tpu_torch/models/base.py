"""Turbulence-model family (port of ``dafoam_tpu.models.base``).

Models are plain objects whose methods are functions of the state dict.
Model states (nuTilda, ...) are ordinary extra keys of the state.

Each model provides:
  nut(state, inputs, geom)        eddy viscosity from model states
  divdevreff(U, ...)              the momentum-equation stress term
                                  -div(nuEff grad U) - div(nuEff dev2(gradU^T))
  correct(...)                    one primal update of the model states
  residuals(...), pc_matrices(...) the model rows of the adjoint's residual
                                  and their block-PC operators
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, float_tensor


class TurbulenceModel:
    model_states: tuple[str, ...] = ()

    def __init__(self, topo, option, wall_dist=None):
        self.topo = topo
        self.option = option
        self.wall_dist = wall_dist  # (nc,) frozen (meshWaveFrozen)
        self.last_solve_info = None  # SolveInfo of the last correct()

    # -- eddy viscosity ------------------------------------------------
    def nut(self, state, inputs, geom):
        raise NotImplementedError

    def nu(self, inputs):
        return inputs["params"]["nu"]

    def setup_wall_functions(self, full_bc_spec):
        """Spalding wall functions (nut BC nutUSpaldingWallFunction) are
        not part of the ported slice."""
        for p in self.topo.patches:
            spec = full_bc_spec.get("nut", {}).get(p.name, {})
            if spec.get("type") == "nutUSpaldingWallFunction":
                raise NotImplementedError(
                    "nutUSpaldingWallFunction is not ported yet "
                    "(ROADMAP.md queue 1, P7: models/wallfunctions.py)")

    def nut_boundary(self, state, inputs, geom):
        """Boundary nut: owner value off-wall, zero at walls (low-Re)."""
        nut = self.nut(state, inputs, geom)
        return boundary_gather(nut, self.topo) * (1.0 - self._wall_mask(geom))

    def _wall_mask(self, geom):
        topo = self.topo
        ni = topo.n_internal

        def make():
            import numpy as np
            m = np.zeros((topo.n_faces - ni,))
            for p in topo.patches:
                if p.kind == "wall":
                    m[p.start - ni:p.start - ni + p.size] = 1.0
            return m

        return float_tensor(topo, "wall_mask", geom.vol.device,
                            geom.vol.dtype, make)

    # -- momentum stress term -----------------------------------------
    def divdevreff(self, U, state, inputs, geom, U_bco) -> fvx.FvMatrix:
        """-laplacian(nuEff, U) - div(nuEff dev2(T(grad U))) as an FvMatrix
        (implicit laplacian + explicit transpose/deviatoric part), matching
        the role of daTurb_->divDevReff(U) in DAResidualSimpleFoam.C:145."""
        topo = self.topo
        U_b = bc.boundary_value(U_bco, U, topo)
        gradU = fvc.grad(geom, topo, U, U_b)           # (nc,3,3) d_i U_j
        nu = self.nu(inputs)
        nu_eff = self.nut(state, inputs, geom) + nu
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
        """One primal iteration of the model equations; returns new state."""
        return state


class Laminar(TurbulenceModel):
    """No model states; nut = 0."""

    def nut(self, state, inputs, geom):
        return torch.zeros_like(geom.vol)

    def nut_boundary(self, state, inputs, geom):
        return geom.vol.new_zeros((self.topo.n_boundary,))
