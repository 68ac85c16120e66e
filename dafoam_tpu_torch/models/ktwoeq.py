"""Standard k-epsilon and Wilcox k-omega models, low-Re variants without
wall damping (port of ``dafoam_tpu.models.ktwoeq``).

Reference: DAkEpsilon and DAkOmega (src/adjoint/DAModel/
DATurbulenceModel/): two model states each, transport residuals in R(W),
semi-implicit destruction for the primal. Use wall functions for high-Re
runs.
"""

from __future__ import annotations

from dafoam_tpu_torch.models.base import TurbulenceModel
from dafoam_tpu_torch.models.komega_sst import strain2
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import boundary_gather, clip, maximum


class _TwoEq(TurbulenceModel):
    """Shared machinery: ``_mats`` gives the (first, second) transport
    matrices; the second state is solved first, then k with it."""

    def __init__(self, topo, option, wall_dist=None, bc_spec=None):
        super().__init__(topo, option, wall_dist)
        spec = bc_spec or {}
        self.bc_specs = {n: spec.get(n, {}) for n in self.model_states}

    def _bco(self, name, state, inputs, geom, phi):
        return bc.coeffs(self.bc_specs[name], inputs["bc"].get(name, {}),
                         self.topo, geom, state[name], rank=0,
                         phi_b=phi[self.topo.n_internal:])

    def _transport(self, name, state, inputs, geom, phi, gamma, src_expl,
                   sp_coef):
        """div(phi, q) - laplacian(gamma, q) == src_expl - Sp(sp_coef, q)"""
        topo = self.topo
        q = state[name]
        bco = self._bco(name, state, inputs, geom, phi)
        g_f = fvc.interpolate(geom, topo, gamma, boundary_gather(gamma, topo))
        M = fvm.div(geom, topo, phi, q, bco, scheme="upwind", bounded=True) \
            - fvm.laplacian(geom, topo, g_f, q, bco)
        M = M.add_source(src_expl * geom.vol)
        return M + fvm.Sp(geom, topo, sp_coef, q)

    def pc_matrices(self, state, inputs, geom, phi, gradU):
        mats = self._mats(state, inputs, geom, phi, gradU)
        return {n: (M, False) for n, M in zip(self.model_states, mats)}

    def residuals(self, state, inputs, geom, phi, gradU=None):
        mats = self._mats(state, inputs, geom, phi, gradU)
        return {n: fvx.residual(M, state[n], geom, self.topo)
                for n, M in zip(self.model_states, mats)}

    def equations(self, state, inputs, geom, phi, gradU, relax):
        mats = self._mats(state, inputs, geom, phi, gradU)
        return {n: fvx.relax(M, state[n], relax, self.topo)
                for n, M in zip(self.model_states, mats)}

    def _solve_one(self, name, M, state, relax, rel_tol, max_iters):
        b = self.option["primalVarBounds"]
        M = fvx.relax(M, state[name], relax, self.topo)
        sol = self._solve(name, M, state, rel_tol, max_iters)
        return clip(sol, b[name + "Min"], b[name + "Max"])

    def correct(self, state, inputs, geom, phi, gradU=None, rel_tol=0.1,
                max_iters=100, relax=0.7, dt=None, old=None):
        """The second state, then k; with ``dt`` each matrix gains the
        implicit Euler term against ``old`` (the unsteady solvers)."""
        second = self.model_states[1]
        _, M2 = self._mats(state, inputs, geom, phi, gradU)
        if dt is not None:
            M2 = M2 + fvm.ddt(geom, self.topo, state[second], old[second],
                              dt)
        st = dict(state, **{second: self._solve_one(
            second, M2, state, relax, rel_tol, max_iters)})
        Mk, _ = self._mats(st, inputs, geom, phi, gradU)
        if dt is not None:
            Mk = Mk + fvm.ddt(geom, self.topo, st["k"], old["k"], dt)
        return dict(st, k=self._solve_one("k", Mk, st, relax, rel_tol,
                                          max_iters))


class KEpsilon(_TwoEq):
    model_states = ("k", "epsilon")
    CMU, C1, C2, SK, SE = 0.09, 1.44, 1.92, 1.0, 1.3

    def nut(self, state, inputs, geom):
        k = maximum(state["k"], 1e-16)
        return self.CMU * k * k / maximum(state["epsilon"], 1e-16)

    def _mats(self, state, inputs, geom, phi, gradU):
        nu = self.nu(inputs)
        k = maximum(state["k"], 1e-16)
        e = maximum(state["epsilon"], 1e-16)
        nut = self.nut(state, inputs, geom)
        G = nut * strain2(gradU)
        Mk = self._transport("k", state, inputs, geom, phi,
                             nu + nut / self.SK, G, e / k)
        Me = self._transport("epsilon", state, inputs, geom, phi,
                             nu + nut / self.SE, self.C1 * G * e / k,
                             self.C2 * e / k)
        return Mk, Me


class KOmega(_TwoEq):
    model_states = ("k", "omega")
    BSTAR, ALPHA, BETA, SK, SW = 0.09, 5.0 / 9.0, 3.0 / 40.0, 0.5, 0.5

    def nut(self, state, inputs, geom):
        return maximum(state["k"], 1e-16) / maximum(state["omega"], 1e-16)

    def _mats(self, state, inputs, geom, phi, gradU):
        nu = self.nu(inputs)
        k = maximum(state["k"], 1e-16)
        w = maximum(state["omega"], 1e-16)
        nut = k / w
        G = nut * strain2(gradU)
        Mk = self._transport("k", state, inputs, geom, phi,
                             nu + self.SK * nut, G, self.BSTAR * w)
        Mw = self._transport("omega", state, inputs, geom, phi,
                             nu + self.SW * nut,
                             self.ALPHA * w / k * G, self.BETA * w)
        return Mk, Mw
