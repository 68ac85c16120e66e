"""Langtry-Menter k-omega-SST-LM transition model (gamma-ReThetat), port
of ``dafoam_tpu.models.komega_sst_lm``.

Reference: DAkOmegaSSTLM (src/adjoint/DAModel/DATurbulenceModel/). Two
more transport equations join the adjoint state (ReThetat, gammaInt); the
k production is multiplied by gammaIntEff, the k destruction by
min(max(gammaIntEff, 0.1), 1), and F1 gains the Ry term. The empirical
correlations (ReThetac, Flength, Fonset, Fthetat and the ReThetat0 Tu/
lambda correlation) follow the reference; the per-cell lambda fixed point
runs a FIXED 10 sweeps over all cells (the reference's maxLambdaIter), so
it needs no host read and autograd differentiates every sweep.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.models.komega_sst import (BETA1, BETA2, BETA_STAR,
                                                GAMMA1, GAMMA2, KOmegaSST,
                                                _blend, strain2)
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, clip, maximum, minimum

# LM constants (reference DAkOmegaSSTLM defaults)
CA1, CA2 = 2.0, 0.06
CE1, CE2 = 1.0, 50.0
C_THETAT = 0.03
SIGMA_THETAT = 2.0
MAX_LAMBDA_ITER = 10
SMALL_U = 1e-10


class KOmegaSSTLM(KOmegaSST):
    model_states = ("k", "omega", "ReThetat", "gammaInt")

    def __init__(self, topo, option, wall_dist=None, bc_spec=None):
        super().__init__(topo, option, wall_dist, bc_spec)
        self.bc_spec_ret = (bc_spec or {}).get("ReThetat", {})
        self.bc_spec_gam = (bc_spec or {}).get("gammaInt", {})

    # -- empirical correlations ------------------------------------------
    @staticmethod
    def _ReThetac(ret):
        low = (ret - 396.035e-2 + 120.656e-4 * ret - 868.230e-6 * ret ** 2
               + 696.506e-9 * ret ** 3 - 174.105e-12 * ret ** 4)
        high = ret - 593.11 - 0.482 * (ret - 1870.0)
        return torch.where(ret <= 1870.0, low, high)

    def _Flength(self, ret, nu, omega):
        y = self.wall_dist
        f1 = 398.189e-1 - 119.270e-4 * ret - 132.567e-6 * ret ** 2
        f2 = (263.404 - 123.939e-2 * ret + 194.548e-5 * ret ** 2
              - 101.695e-8 * ret ** 3)
        f3 = 0.5 - 3e-4 * (ret - 596.0)
        fl = torch.where(ret < 400.0, f1,
                         torch.where(ret < 596.0, f2,
                                     torch.where(ret < 1200.0, f3,
                                                 torch.full_like(f3,
                                                                 0.3188))))
        fsub = torch.exp(-((y ** 2 * omega / (200.0 * nu)) ** 2))
        return fl * (1.0 - fsub) + 40.0 * fsub

    @staticmethod
    def _Fonset(rev, rethetac, rt):
        f1 = rev / (2.193 * maximum(rethetac, 1e-10))
        f2 = minimum(torch.maximum(f1, f1 ** 4), 2.0)
        f3 = maximum(1.0 - (rt / 2.5) ** 3, 0.0)
        return maximum(f2 - f3, 0.0)

    @staticmethod
    def _ReThetat0(Tu, dUsds, nu, Us):
        """Empirical freestream correlation with the lambda fixed point,
        vectorized with a fixed sweep count."""

        def thetat_of(lam):
            fneg = 1.0 - (-12.986 * lam - 123.66 * lam ** 2
                          - 405.689 * lam ** 3) * torch.exp(
                              -((Tu / 1.5) ** 1.5))
            flam_lo = torch.where(
                dUsds <= 0.0, fneg,
                1.0 + 0.275 * (1.0 - torch.exp(-35.0 * lam))
                * torch.exp(-Tu / 0.5))
            flam_hi = torch.where(
                dUsds <= 0.0, fneg,
                1.0 + 0.275 * (1.0 - torch.exp(-35.0 * lam))
                * torch.exp(-2.0 * Tu))
            th_lo = (1173.51 - 589.428 * Tu + 0.2196 / Tu ** 2) \
                * flam_lo * nu / Us
            th_hi = 331.50 * maximum(Tu - 0.5658, 1e-6) ** (-0.671) \
                * flam_hi * nu / Us
            return torch.where(Tu <= 1.3, th_lo, th_hi)

        lam = torch.zeros_like(Tu)
        for _ in range(MAX_LAMBDA_ITER):
            th = thetat_of(lam)
            lam = clip(th ** 2 / nu * dUsds, -0.1, 0.1)
        return maximum(thetat_of(lam) * Us / nu, 20.0)

    def _Fthetat(self, Us, Omega, nu, ret, gam, omega):
        y = self.wall_dist
        delta = 375.0 * Omega * nu * ret * y / maximum(Us ** 2, 1e-36)
        re_om = y ** 2 * omega / nu
        fwake = torch.exp(-((re_om / 1e5) ** 2))
        a = fwake * torch.exp(-((y / maximum(delta, 1e-36)) ** 4))
        b = 1.0 - ((gam - 1.0 / CE2) / (1.0 - 1.0 / CE2)) ** 2
        return minimum(torch.maximum(a, b), 1.0)

    # -- LM kinematics -----------------------------------------------------
    def _lm_fields(self, state, inputs, geom, gradU):
        nu = self.nu(inputs) * torch.ones_like(state["k"])
        U = state["U"]
        k = maximum(state["k"], 1e-16)
        w = maximum(state["omega"], 1e-16)
        S = torch.sqrt(strain2(gradU))
        skew = 0.5 * (gradU - torch.swapaxes(gradU, -1, -2))
        Omega = torch.sqrt(2.0 * maximum((skew * skew).sum(dim=(-2, -1)),
                                         1e-36))
        Us = maximum(torch.linalg.vector_norm(U, dim=-1), SMALL_U)
        # dUs/ds = (U . (U . gradU)) / Us^2  (gradU[i,j] = dU_j/dx_i)
        UgU = (U[:, :, None] * gradU).sum(dim=1)
        dUsds = (U * UgU).sum(dim=-1) / Us ** 2
        Tu = maximum(100.0 * torch.sqrt((2.0 / 3.0) * k) / Us, 0.027)
        y = self.wall_dist
        Rev = y ** 2 * S / nu
        RT = k / (nu * w)
        return nu, k, w, S, Omega, Us, dUsds, Tu, Rev, RT

    def gamma_int_eff(self, state, inputs, geom, gradU):
        """gammaIntEff = max(gammaInt, gammaSep), the separation-induced
        transition."""
        nu, k, w, S, Omega, Us, dUsds, Tu, Rev, RT = self._lm_fields(
            state, inputs, geom, gradU)
        ret = maximum(state["ReThetat"], 20.0)
        rethetac = self._ReThetac(ret)
        fthetat = self._Fthetat(Us, Omega, nu, ret, state["gammaInt"], w)
        freattach = torch.exp(-((RT / 20.0) ** 4))
        gamma_sep = minimum(
            2.0 * maximum(Rev / (3.235 * maximum(rethetac, 1e-10)) - 1.0,
                          0.0) * freattach, 2.0) * fthetat
        return torch.maximum(state["gammaInt"], gamma_sep)

    # -- SST overrides: F1's Ry term, gammaIntEff in k's sources -------------
    def _f1_f2(self, state, inputs, geom, grads):
        f1, f2, cdkw = super()._f1_f2(state, inputs, geom, grads)
        k = maximum(state["k"], 1e-16)
        ry = self.wall_dist * torch.sqrt(k) / self.nu(inputs)
        f3 = torch.exp(-((ry / 120.0) ** 8))
        return torch.maximum(f1, f3), f2, cdkw

    def _assemble(self, state, inputs, geom, phi, gradU):
        """SST k/omega matrices with the LM coupling (Pk *= gammaIntEff,
        destruction *= min(max(gammaIntEff, 0.1), 1))."""
        f1, cdkw, S2, nut, kpos, wpos = self._k_omega_terms(
            state, inputs, geom, phi, gradU)
        g_eff = self.gamma_int_eff(state, inputs, geom, gradU)
        Pk = g_eff * torch.minimum(nut * S2, 10.0 * BETA_STAR * kpos * wpos)
        destr_k = clip(g_eff, 0.1, 1.0) * BETA_STAR * wpos
        gamma = _blend(f1, GAMMA1, GAMMA2)
        beta = _blend(f1, BETA1, BETA2)
        src_w = gamma * S2 + (1.0 - f1) * cdkw
        return self._transport_pair(state, inputs, geom, phi, f1, nut, Pk,
                                    destr_k, src_w, beta, wpos)

    # -- LM transport matrices --------------------------------------------
    def _assemble_lm(self, state, inputs, geom, phi, gradU):
        topo = self.topo
        nu, k, w, S, Omega, Us, dUsds, Tu, Rev, RT = self._lm_fields(
            state, inputs, geom, gradU)
        ret = state["ReThetat"]
        gam = state["gammaInt"]
        retpos = maximum(ret, 20.0)
        gampos = clip(gam, 1e-6, 1.0 + 1e-6)
        nut = self.nut_with_grad(state, inputs, geom, gradU)
        phi_b = phi[topo.n_internal:]
        b_ret = bc.coeffs(self.bc_spec_ret, inputs["bc"].get("ReThetat", {}),
                          topo, geom, ret, rank=0, phi_b=phi_b)
        b_gam = bc.coeffs(self.bc_spec_gam, inputs["bc"].get("gammaInt", {}),
                          topo, geom, gam, rank=0, phi_b=phi_b)

        # ReThetat equation
        fthetat = self._Fthetat(Us, Omega, nu, retpos, gampos, w)
        t_scale = 500.0 * nu / Us ** 2
        p_thetat = C_THETAT / t_scale * (1.0 - fthetat)
        d_ret = SIGMA_THETAT * (nut + nu)
        d_ret_f = fvc.interpolate(geom, topo, d_ret,
                                  boundary_gather(d_ret, topo))
        ret0 = self._ReThetat0(Tu, dUsds, nu, Us)
        M_ret = fvm.div(geom, topo, phi, ret, b_ret, scheme="upwind",
                        bounded=True) \
            - fvm.laplacian(geom, topo, d_ret_f, ret, b_ret)
        M_ret = M_ret.add_source(p_thetat * ret0 * geom.vol)
        M_ret = M_ret + fvm.Sp(geom, topo, p_thetat, ret)

        # gammaInt equation
        rethetac = self._ReThetac(retpos)
        fonset = self._Fonset(Rev, rethetac, RT)
        p_gamma = CA1 * self._Flength(retpos, nu, w) * S * torch.sqrt(
            gampos * fonset + 1e-30)
        fturb = torch.exp(-((0.25 * RT) ** 4))
        e_gamma = CA2 * Omega * fturb * gampos
        d_gam = nut + nu
        d_gam_f = fvc.interpolate(geom, topo, d_gam,
                                  boundary_gather(d_gam, topo))
        M_gam = fvm.div(geom, topo, phi, gam, b_gam, scheme="upwind",
                        bounded=True) \
            - fvm.laplacian(geom, topo, d_gam_f, gam, b_gam)
        M_gam = M_gam.add_source((p_gamma + e_gamma) * geom.vol)
        M_gam = M_gam + fvm.Sp(geom, topo, CE1 * p_gamma + CE2 * e_gamma,
                               gam)
        return M_ret, M_gam

    # -- framework hooks ----------------------------------------------------
    def pc_matrices(self, state, inputs, geom, phi, gradU):
        out = super().pc_matrices(state, inputs, geom, phi, gradU)
        M_ret, M_gam = self._assemble_lm(state, inputs, geom, phi, gradU)
        out["ReThetat"] = (M_ret, False)
        out["gammaInt"] = (M_gam, False)
        return out

    def residuals(self, state, inputs, geom, phi, gradU=None):
        out = super().residuals(state, inputs, geom, phi, gradU)
        M_ret, M_gam = self._assemble_lm(state, inputs, geom, phi, gradU)
        out["ReThetat"] = fvx.residual(M_ret, state["ReThetat"], geom,
                                       self.topo)
        out["gammaInt"] = fvx.residual(M_gam, state["gammaInt"], geom,
                                       self.topo)
        return out

    def equations(self, state, inputs, geom, phi, gradU, relax):
        out = super().equations(state, inputs, geom, phi, gradU, relax)
        M_ret, M_gam = self._assemble_lm(state, inputs, geom, phi, gradU)
        out["ReThetat"] = fvx.relax(M_ret, state["ReThetat"], relax,
                                    self.topo)
        out["gammaInt"] = fvx.relax(M_gam, state["gammaInt"], relax,
                                    self.topo)
        return out

    def correct(self, state, inputs, geom, phi, gradU=None,
                rel_tol=0.1, max_iters=100, relax=0.7, dt=None, old=None):
        """The reference order: ReThetat, gammaInt, then SST's omega and
        k (only those two take the unsteady ``dt`` term, as in
        dafoam_tpu)."""
        M_ret, _ = self._assemble_lm(state, inputs, geom, phi, gradU)
        M_ret = fvx.relax(M_ret, state["ReThetat"], relax, self.topo)
        ret_new = self._solve("ReThetat", M_ret, state, rel_tol, max_iters)
        st = dict(state, ReThetat=maximum(ret_new, 20.0))
        _, M_gam = self._assemble_lm(st, inputs, geom, phi, gradU)
        M_gam = fvx.relax(M_gam, st["gammaInt"], relax, self.topo)
        gam_new = self._solve("gammaInt", M_gam, st, rel_tol, max_iters)
        st = dict(st, gammaInt=clip(gam_new, 0.02, 1.0))
        return super().correct(st, inputs, geom, phi, gradU=gradU,
                               rel_tol=rel_tol, max_iters=max_iters,
                               relax=relax, dt=dt, old=old)
