"""Menter k-omega SST turbulence model, low-Re (port of
``dafoam_tpu.models.komega_sst``).

Reference: DAkOmegaSST (src/adjoint/DAModel/DATurbulenceModel/). k and
omega are model states and their transport residuals join R(W). Standard
2003 constants, F1/F2 blending from the frozen wall distance, the
strain-limited eddy viscosity a1 k / max(a1 omega, F2 S) in the momentum
stress (``nut_with_grad``), bounded upwind transport.

One difference from ``dafoam_tpu``: the k/omega boundary values behind
grad(k) and grad(omega) (the cross-diffusion CDkw and F1) are taken with
the face flux, so an inletOutlet k/omega patch works; the JAX model
assembles them without a flux and raises on inletOutlet. For the other BC
types the two are the same.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.models.base import TurbulenceModel
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, clip, maximum, minimum

A1 = 0.31
BETA_STAR = 0.09
SIGMA_K1, SIGMA_K2 = 0.85, 1.0
SIGMA_W1, SIGMA_W2 = 0.5, 0.856
BETA1, BETA2 = 0.075, 0.0828
GAMMA1 = BETA1 / BETA_STAR - SIGMA_W1 * 0.41 ** 2 / BETA_STAR ** 0.5
GAMMA2 = BETA2 / BETA_STAR - SIGMA_W2 * 0.41 ** 2 / BETA_STAR ** 0.5


def _blend(f1, a, b):
    return f1 * a + (1.0 - f1) * b


def strain2(gradU):
    """2 |symm(grad U)|^2 (floored at 2e-36)."""
    sym = 0.5 * (gradU + torch.swapaxes(gradU, -1, -2))
    return 2.0 * maximum((sym * sym).sum(dim=(-2, -1)), 1e-36)


class KOmegaSST(TurbulenceModel):
    model_states = ("k", "omega")

    def __init__(self, topo, option, wall_dist=None, bc_spec=None):
        super().__init__(topo, option, wall_dist)
        self.bc_spec_k = (bc_spec or {}).get("k", {})
        self.bc_spec_w = (bc_spec or {}).get("omega", {})

    # ------------------------------------------------------------------
    def _f1_f2(self, state, inputs, geom, grads):
        nu = self.nu(inputs)
        k = maximum(state["k"], 1e-16)
        w = maximum(state["omega"], 1e-16)
        d = maximum(self.wall_dist, 1e-12)
        gk, gw = grads
        cdkw = maximum(2.0 * SIGMA_W2 / w * (gk * gw).sum(dim=-1), 1e-10)
        arg1 = torch.minimum(
            torch.maximum(torch.sqrt(k) / (BETA_STAR * w * d),
                          500.0 * nu / (d ** 2 * w)),
            4.0 * SIGMA_W2 * k / (cdkw * d ** 2))
        f1 = torch.tanh(minimum(arg1, 20.0) ** 4)
        arg2 = torch.maximum(2.0 * torch.sqrt(k) / (BETA_STAR * w * d),
                             500.0 * nu / (d ** 2 * w))
        f2 = torch.tanh(minimum(arg2, 20.0) ** 2)
        return f1, f2, cdkw

    def nut_with_grad(self, state, inputs, geom, gradU):
        """The strain-limited eddy viscosity a1 k / max(a1 omega, F2 S)."""
        k = maximum(state["k"], 1e-16)
        w = maximum(state["omega"], 1e-16)
        if gradU is None:
            return k / w
        S = torch.sqrt(strain2(gradU))
        _, f2, _ = self._f1_f2(state, inputs, geom,
                               self._grads(state, inputs, geom))
        return A1 * k / torch.maximum(A1 * w, f2 * S)

    def nut(self, state, inputs, geom):
        # without the velocity gradient: the plain k/omega (bounded)
        return maximum(state["k"], 1e-16) / maximum(state["omega"], 1e-16)

    def _bcos(self, state, inputs, geom, phi=None):
        topo = self.topo
        phi = state["phi"] if phi is None else phi
        phi_b = phi[topo.n_internal:]
        bk = bc.coeffs(self.bc_spec_k, inputs["bc"].get("k", {}), topo,
                       geom, state["k"], rank=0, phi_b=phi_b)
        bw = bc.coeffs(self.bc_spec_w, inputs["bc"].get("omega", {}), topo,
                       geom, state["omega"], rank=0, phi_b=phi_b)
        return bk, bw

    def _grads(self, state, inputs, geom, phi=None):
        topo = self.topo
        bk, bw = self._bcos(state, inputs, geom, phi)
        k_b = bc.boundary_value(bk, state["k"], topo)
        w_b = bc.boundary_value(bw, state["omega"], topo)
        return (fvc.grad(geom, topo, state["k"], k_b),
                fvc.grad(geom, topo, state["omega"], w_b))

    # ------------------------------------------------------------------
    def _k_omega_terms(self, state, inputs, geom, phi, gradU):
        """F1, CDkw, S^2, the strain-limited nut and the bounded k, omega
        (shared with the LM model)."""
        grads = self._grads(state, inputs, geom, phi)
        f1, f2, cdkw = self._f1_f2(state, inputs, geom, grads)
        S2 = strain2(gradU)
        kpos = maximum(state["k"], 1e-16)
        wpos = maximum(state["omega"], 1e-16)
        nut = A1 * kpos / torch.maximum(A1 * wpos, f2 * torch.sqrt(S2))
        return f1, cdkw, S2, nut, kpos, wpos

    def _transport_pair(self, state, inputs, geom, phi, f1, nut, Pk,
                        destr_k, src_w, beta, wpos):
        """The k and omega matrices: bounded upwind convection, blended
        diffusion, explicit production and implicit destruction."""
        topo = self.topo
        nu = self.nu(inputs)
        k, w = state["k"], state["omega"]
        bk, bw = self._bcos(state, inputs, geom, phi)
        dk = nu + _blend(f1, SIGMA_K1, SIGMA_K2) * nut
        dw = nu + _blend(f1, SIGMA_W1, SIGMA_W2) * nut
        dk_f = fvc.interpolate(geom, topo, dk, boundary_gather(dk, topo))
        dw_f = fvc.interpolate(geom, topo, dw, boundary_gather(dw, topo))

        Mk = fvm.div(geom, topo, phi, k, bk, scheme="upwind", bounded=True) \
            - fvm.laplacian(geom, topo, dk_f, k, bk)
        Mk = Mk.add_source(Pk * geom.vol)
        Mk = Mk + fvm.Sp(geom, topo, destr_k, k)

        Mw = fvm.div(geom, topo, phi, w, bw, scheme="upwind", bounded=True) \
            - fvm.laplacian(geom, topo, dw_f, w, bw)
        Mw = Mw.add_source(src_w * geom.vol)
        Mw = Mw + fvm.Sp(geom, topo, beta * wpos, w)
        return Mk, Mw

    def _assemble(self, state, inputs, geom, phi, gradU):
        f1, cdkw, S2, nut, kpos, wpos = self._k_omega_terms(
            state, inputs, geom, phi, gradU)
        Pk = torch.minimum(nut * S2, 10.0 * BETA_STAR * kpos * wpos)
        gamma = _blend(f1, GAMMA1, GAMMA2)
        beta = _blend(f1, BETA1, BETA2)
        # incompressible omega production gamma S^2 and cross diffusion
        src_w = gamma * S2 + (1.0 - f1) * cdkw
        return self._transport_pair(state, inputs, geom, phi, f1, nut, Pk,
                                    BETA_STAR * wpos, src_w, beta, wpos)

    def pc_matrices(self, state, inputs, geom, phi, gradU):
        Mk, Mw = self._assemble(state, inputs, geom, phi, gradU)
        return {"k": (Mk, False), "omega": (Mw, False)}

    def residuals(self, state, inputs, geom, phi, gradU=None):
        Mk, Mw = self._assemble(state, inputs, geom, phi, gradU)
        return {"k": fvx.residual(Mk, state["k"], geom, self.topo),
                "omega": fvx.residual(Mw, state["omega"], geom, self.topo)}

    def equations(self, state, inputs, geom, phi, gradU, relax):
        Mk, Mw = self._assemble(state, inputs, geom, phi, gradU)
        return {"k": fvx.relax(Mk, state["k"], relax, self.topo),
                "omega": fvx.relax(Mw, state["omega"], relax, self.topo)}

    def correct(self, state, inputs, geom, phi, gradU=None,
                rel_tol=0.1, max_iters=100, relax=0.7, dt=None, old=None):
        """omega first, then k with the new omega (the reference order);
        with ``dt`` each matrix gains the implicit Euler term against
        ``old`` (the unsteady solvers)."""
        bounds = self.option["primalVarBounds"]
        _, Mw = self._assemble(state, inputs, geom, phi, gradU)
        if dt is not None:
            Mw = Mw + fvm.ddt(geom, self.topo, state["omega"],
                              old["omega"], dt)
        Mw = fvx.relax(Mw, state["omega"], relax, self.topo)
        w_new = self._solve("omega", Mw, state, rel_tol, max_iters)
        st = dict(state, omega=clip(w_new, bounds["omegaMin"],
                                    bounds["omegaMax"]))
        Mk, _ = self._assemble(st, inputs, geom, phi, gradU)
        if dt is not None:
            Mk = Mk + fvm.ddt(geom, self.topo, st["k"], old["k"], dt)
        Mk = fvx.relax(Mk, st["k"], relax, self.topo)
        k_new = self._solve("k", Mk, st, rel_tol, max_iters)
        return dict(st, k=clip(k_new, bounds["kMin"], bounds["kMax"]))
