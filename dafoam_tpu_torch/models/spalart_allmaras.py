"""Spalart–Allmaras one-equation model, low-Re (port of
``dafoam_tpu.models.spalart_allmaras``).

nuTilda is a model state; nut is recomputed from it (the reference's
correctNut). Wall distance is a frozen precomputed field (meshWaveFrozen).
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.models.base import TurbulenceModel
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx

# standard coefficients
SIGMA_NUT = 0.66666
KAPPA = 0.41
CB1 = 0.1355
CB2 = 0.622
CW1 = CB1 / KAPPA ** 2 + (1.0 + CB2) / SIGMA_NUT
CW2 = 0.3
CW3 = 2.0
CV1 = 7.1
CS = 0.3
CV2_FV3 = 5.0


def _fw_of_g(g):
    """fw(g) = g * ((1+cw3^6)/(g^6+cw3^6))^(1/6), with every intermediate
    O(1): fw = A / (1+(c/g)^6)^(1/6) for g >= c and
    A (g/c) / (1+(g/c)^6)^(1/6) for g < c, A = (1+c^6)^(1/6)."""
    c = CW3
    A = (1.0 + c ** 6) ** (1.0 / 6.0)
    hi = g >= c
    g_hi = torch.where(hi, g, c)         # >= c in the selected branch
    g_lo = torch.where(hi, c, g)         # <= c in the selected branch
    t_hi = (c / g_hi) ** 6               # <= 1
    t_lo = (g_lo / c) ** 6               # <= 1
    fw_hi = A / (1.0 + t_hi) ** (1.0 / 6.0)
    fw_lo = A * (g_lo / c) / (1.0 + t_lo) ** (1.0 / 6.0)
    return torch.where(hi, fw_hi, fw_lo)


def _vorticity(gradU):
    skew = 0.5 * (gradU - torch.swapaxes(gradU, -1, -2))
    return math.sqrt(2.0) * torch.sqrt(
        torch.clamp_min((skew * skew).sum(dim=(-2, -1)), 1e-36))


class SpalartAllmaras(TurbulenceModel):
    model_states = ("nuTilda",)

    def __init__(self, topo, option, wall_dist=None, bc_spec=None):
        super().__init__(topo, option, wall_dist)
        bc_spec = bc_spec or {}
        # accept either the full boundaryConditions spec or the nuTilda one
        self.bc_spec = bc_spec.get("nuTilda", bc_spec)
        # field-inversion production multiplier beta(W; theta), set by the
        # owning solver for a betaFI field or a regression model
        self.beta_fn = None

    # ------------------------------------------------------------------
    def _chi_fv1(self, nuTilda, nu):
        chi = nuTilda / nu
        chi3 = chi ** 3
        fv1 = chi3 / (chi3 + CV1 ** 3)
        return chi, fv1

    def nut(self, state, inputs, geom):
        _, fv1 = self._chi_fv1(state["nuTilda"], self.nu(inputs))
        return state["nuTilda"] * fv1

    # ------------------------------------------------------------------
    def _stilda_fw(self, state, inputs, geom, gradU):
        nu = self.nu(inputs)
        nuTilda = state["nuTilda"]
        d = torch.clamp_min(self.wall_dist, 1e-12)
        chi, fv1 = self._chi_fv1(nuTilda, nu)
        fv2 = 1.0 - chi / (1.0 + chi * fv1)
        omega = _vorticity(gradU)
        inv_kd2 = 1.0 / (KAPPA ** 2 * d ** 2)
        stilda = torch.maximum(omega + fv2 * nuTilda * inv_kd2, CS * omega)
        r = torch.clamp_max(
            nuTilda / torch.clamp_min(stilda, 1e-16) * inv_kd2, 10.0)
        g = r + CW2 * (r ** 6 - r)
        return stilda, _fw_of_g(g), d

    def _bco(self, state, inputs, geom, phi):
        return bc.coeffs(self.bc_spec, inputs["bc"].get("nuTilda", {}),
                         self.topo, geom, state["nuTilda"], rank=0,
                         phi_b=phi[self.topo.n_internal:])

    def _assemble(self, state, inputs, geom, phi, gradU):
        """nuTilda transport matrix + sources, destruction implicit via Sp
        (primal stabilization, OpenFOAM style)."""
        topo = self.topo
        nu = self.nu(inputs)
        nuTilda = state["nuTilda"]
        bco = self._bco(state, inputs, geom, phi)
        nuT_b = bc.boundary_value(bco, nuTilda, topo)
        d_eff = (nu + nuTilda) / SIGMA_NUT
        d_eff_b = (nu + nuT_b) / SIGMA_NUT
        d_eff_f = fvc.interpolate(geom, topo, d_eff, d_eff_b)

        M = fvm.div(geom, topo, phi, nuTilda, bco, scheme="upwind",
                    bounded=True) \
            - fvm.laplacian(geom, topo, d_eff_f, nuTilda, bco)

        gn = fvc.grad(geom, topo, nuTilda, nuT_b)
        cross = CB2 / SIGMA_NUT * (gn * gn).sum(dim=-1)
        stilda, fw, d = self._stilda_fw(state, inputs, geom, gradU)
        prod = CB1 * stilda * nuTilda
        if self.beta_fn is not None:
            prod = prod * self.beta_fn(state, inputs, geom, gradU)
        # sources on RHS: cross-diffusion + production
        M = M.add_source((cross + prod) * geom.vol)
        return M + fvm.Sp(geom, topo, CW1 * fw * nuTilda / d ** 2, nuTilda)

    def pc_matrices(self, state, inputs, geom, phi, gradU):
        return {"nuTilda": (self._assemble(state, inputs, geom, phi, gradU),
                            False)}

    def residuals(self, state, inputs, geom, phi, gradU=None):
        if gradU is None:
            raise ValueError("SA residuals need gradU")
        M = self._assemble(state, inputs, geom, phi, gradU)
        return {"nuTilda": fvx.residual(M, state["nuTilda"], geom, self.topo)}

    # ------------------------------------------------------------------
    def equations(self, state, inputs, geom, phi, gradU, relax):
        """{"nuTilda": the relaxed transport matrix} at ``state``."""
        M = self._assemble(state, inputs, geom, phi, gradU)
        return {"nuTilda": fvx.relax(M, state["nuTilda"], relax, self.topo)}

    def correct(self, state, inputs, geom, phi, gradU=None,
                rel_tol=0.1, max_iters=100, relax=0.7, dt=None, old=None):
        """One nuTilda solve; with ``dt`` the transport matrix gains the
        implicit Euler term against ``old`` (the unsteady solvers)."""
        M = self._assemble(state, inputs, geom, phi, gradU)
        if dt is not None:
            M = M + fvm.ddt(geom, self.topo, state["nuTilda"],
                            old["nuTilda"], dt)
        M = fvx.relax(M, state["nuTilda"], relax, self.topo)
        sol = self._solve("nuTilda", M, state, rel_tol, max_iters)
        bounds = self.option["primalVarBounds"]
        sol = torch.clamp(sol, bounds["nuTildaMin"], bounds["nuTildaMax"])
        return dict(state, nuTilda=sol)


class SpalartAllmarasFv3(SpalartAllmaras):
    """SA with the fv3 modification (reference DASpalartAllmarasFv3):
    fv2/fv3 replace the standard fv2 in Stilda."""

    def _stilda_fw(self, state, inputs, geom, gradU):
        nu = self.nu(inputs)
        nuTilda = state["nuTilda"]
        d = torch.clamp_min(self.wall_dist, 1e-12)
        chi, fv1 = self._chi_fv1(nuTilda, nu)
        chi_s = torch.clamp_min(chi, 1e-12)
        fv2 = (1.0 + chi_s / CV2_FV3) ** (-3.0)
        fv3 = (1.0 + chi_s * fv1) * (1.0 - fv2) / chi_s
        omega = _vorticity(gradU)
        inv_kd2 = 1.0 / (KAPPA ** 2 * d ** 2)
        stilda = torch.clamp_min(fv3 * omega + fv2 * nuTilda * inv_kd2, 1e-16)
        r = torch.clamp_max(nuTilda / stilda * inv_kd2, 10.0)
        g = r + CW2 * (r ** 6 - r)
        return stilda, _fw_of_g(g), d
