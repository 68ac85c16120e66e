"""Unsteady incompressible PIMPLE on a moving mesh, ALE (port of
``dafoam_tpu.solvers.pimple_dym``).

Reference: DAPimpleDyMFoam (src/adjoint/DASolver/DAPimpleDyMFoam/
DAPimpleDyMFoam.C, DASolver.C:4166 initDynamicMesh): per-step mesh
motion, convection by the flux relative to the mesh (fvc::makeRelative),
moving-wall velocities, and the unsteady adjoint over the per-step mesh
positions. The reference re-reads those from disk (pyDAFoam.py:1288);
here points(t) is an analytic function of the motion parameters, so
dJ/d(motion) comes out of the same reverse sweep.

Mesh flux (space conservation): faces are fan-triangulated about their
vertex mean, as in ``mesh.geometry``; for vertex paths linear in time the
swept volume of each triangle is exact by Simpson's rule,
V_swept = (A(0) + 4 A(1/2) + A(1))/6 . (cbar1 - cbar0), since A(t) is
quadratic. meshPhi = V_swept/dt. The padded faces of the dense-DIA layout
(every vertex point 0) sweep exactly nothing.

Motion (option "dynamicMesh"): "translation",
disp(t) = amp sin(2 pi f t) dir, differentiable in
``inputs["params"]["dyMeshAmp"]``. Every step rebuilds the geometry at
both ends of the step (two ``compute_geometry`` calls); U solves run
through K2 and p solves through K1. With ``adjEqnOption.pcType`` the
reverse sweep takes the parent's segregated PC assembled on step n's
geometry, where dafoam_tpu runs this sweep unpreconditioned.
"""

from __future__ import annotations

import math

import torch

from dafoam_tpu_torch.adjoint.unsteady import at, unsteady_adjoint_totals
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.ops import bc, fvc, fvm
from dafoam_tpu_torch.ops import fvmatrix as fvx
from dafoam_tpu_torch.ops.core import (boundary_scatter_add, face_sum_pair,
                                       float_tensor, index_tensor,
                                       surface_sum)
from dafoam_tpu_torch.solvers.base import PrimalInfo
from dafoam_tpu_torch.solvers.pimple import DAPimpleFoam, stack_history
from dafoam_tpu_torch.timeops import time_op


class DAPimpleDyMFoam(DAPimpleFoam):

    def __init__(self, option, topo, points, *, device, dtype):
        super().__init__(option, topo, points, device=device, dtype=dtype)
        self.dym = self.option.get("dynamicMesh", {}) or {}
        if not self.dym.get("active", False):
            raise ValueError("DAPimpleDyMFoam needs dynamicMesh.active")
        self.moving_patches = tuple(self.dym.get("movingPatches", []))

    # -- motion ------------------------------------------------------------
    def make_inputs(self):
        x = super().make_inputs()
        x["params"]["dyMeshAmp"] = self._tensor(self.dym.get("amplitude",
                                                             0.0))
        return x

    def motion(self, inputs, t):
        """(point displacement (np, 3), point velocity (np, 3)) at time t."""
        mtype = self.dym.get("motionType", "translation")
        if mtype != "translation":
            raise NotImplementedError(mtype)
        amp = inputs["params"]["dyMeshAmp"]
        d = self._tensor(self.dym.get("direction", [0.0, 1.0, 0.0]))
        w = 2.0 * math.pi * self.dym.get("frequency", 1.0)
        disp = amp * math.sin(w * t) * d
        vel = amp * w * math.cos(w * t) * d
        n = self.points.shape[0]
        return disp.expand(n, 3), vel.expand(n, 3)

    def points_at(self, inputs, t):
        return inputs["points"] + self.motion(inputs, t)[0]

    # -- swept-volume mesh flux ---------------------------------------------
    def mesh_phi(self, pts_old, pts_new, dt):
        """(nf,) swept-volume flux of every face between two
        configurations."""
        topo = self.topo
        dev, dtype = pts_new.device, pts_new.dtype
        fv = index_tensor(topo, "face_verts", dev, lambda: topo.face_verts)
        maxnv = topo.face_verts.shape[1]
        nvf = float_tensor(topo, "face_nverts", dev, dtype,
                           lambda: topo.face_nverts.astype("float64"))
        pad = float_tensor(topo, "face_pad", dev, dtype,
                           lambda: (maxnv - topo.face_nverts)
                           .astype("float64"))

        def tri_areas(pts):
            P = pts[fv]                                # (nf, K, 3)
            # padding repeats vertex 0: subtract its overcount
            ctr = (P.sum(dim=1) - pad[:, None] * pts[fv[:, 0]]) \
                / nvf[:, None]
            a = P - ctr[:, None, :]
            b = torch.roll(P, -1, dims=1) - ctr[:, None, :]
            # padded slots give degenerate (zero-area) triangles
            return 0.5 * torch.linalg.cross(a, b, dim=-1), ctr, P

        A0, c0, P0 = tri_areas(pts_old)
        A1, c1, P1 = tri_areas(pts_new)
        Pm = 0.5 * (P0 + P1)
        cm = 0.5 * (c0 + c1)
        Am = 0.5 * torch.linalg.cross(
            Pm - cm[:, None, :], torch.roll(Pm, -1, dims=1) - cm[:, None, :],
            dim=-1)
        # per-triangle mean velocity * dt: displacement of the tri mean
        tbar0 = (P0 + torch.roll(P0, -1, dims=1) + c0[:, None, :]) / 3.0
        tbar1 = (P1 + torch.roll(P1, -1, dims=1) + c1[:, None, :]) / 3.0
        swept = ((A0 + 4.0 * Am + A1) / 6.0 * (tbar1 - tbar0)).sum(dim=(1, 2))
        return swept / dt

    def scl_residual(self, pts_old, pts_new, dt):
        """The discrete space conservation law's defect under a motion that
        keeps every cell volume: max over cells of |sum of the cell's
        mesh fluxes| / (sum of their magnitudes)."""
        topo = self.topo
        ni = topo.n_internal
        mphi = self.mesh_phi(pts_old, pts_new, dt)
        net = surface_sum(mphi[:ni], mphi[ni:], topo)
        a = torch.abs(mphi)
        mag = boundary_scatter_add(face_sum_pair(a[:ni], a[:ni], topo),
                                   a[ni:], topo)
        return float(torch.max(torch.abs(net)
                               / torch.where(mag > 0.0, mag, 1.0)))

    # -- per-step inputs (moving-wall BC) ------------------------------------
    def _inputs_at(self, inputs, t):
        """The moving-wall velocity in the U BC values."""
        if not self.moving_patches:
            return inputs
        _, vel = self.motion(inputs, t)
        out = dict(inputs)
        out["bc"] = {k: dict(v) for k, v in inputs["bc"].items()}
        ub = dict(out["bc"].get("U", {}))
        for pname in self.moving_patches:
            ub[pname] = vel[0]        # rigid: same velocity everywhere
        out["bc"]["U"] = ub
        return out

    def _geoms(self, inputs, n):
        """(geometry at step n, at step n-1, mesh flux, step-n inputs)."""
        t_new, t_old = n * self.dt, (n - 1) * self.dt
        pts_old = self.points_at(inputs, t_old)
        pts_new = self.points_at(inputs, t_new)
        return (compute_geometry(pts_new, self.topo),
                compute_geometry(pts_old, self.topo),
                self.mesh_phi(pts_old, pts_new, self.dt),
                self._inputs_at(inputs, t_new))

    # -- ALE momentum matrix -------------------------------------------------
    def _ueqn_ale(self, state, W_old, inputs_t, geom, geom_old, mesh_phi):
        U, phi = state["U"], state["phi"]
        U_bco = self._bco_U(U, inputs_t, geom, phi)
        ni = self.topo.n_internal
        M = fvm.div(geom, self.topo, phi - mesh_phi, U, U_bco,
                    scheme=self.div_u_scheme) \
            + self.turb.divdevreff(U, state, inputs_t, geom, U_bco)
        # ALE Euler ddt: (V_new U - V_old U_old)/dt
        rdt = 1.0 / self.dt
        return M + fvx.FvMatrix(
            diag=torch.broadcast_to((geom.vol * rdt)[:, None], U.shape),
            lower=U.new_zeros((ni,)), upper=U.new_zeros((ni,)),
            source=(geom_old.vol * rdt)[:, None] * W_old["U"]), U_bco

    # -- one ALE time step ----------------------------------------------------
    def _step_ale(self, state_old, inputs, n):
        lin = self.option["primalLinearSolver"]
        topo = self.topo
        geom, geom_old, mesh_phi, inp_t = self._geoms(inputs, n)
        st = state_old
        for _ in range(self.n_outer):
            UEqn, U_bco = self._ueqn_ale(st, state_old, inp_t, geom,
                                         geom_old, mesh_phi)
            p = st["p"]
            p_b = bc.boundary_value(self._bco_p(p, inp_t, geom, st["phi"]),
                                    p, topo)
            rhs_U = -fvc.grad(geom, topo, p, p_b) * geom.vol[:, None]
            U_pred, info = fvsolve.solve(UEqn, st["U"], topo,
                                         symmetric=False,
                                         rel_tol=lin["uRelTol"],
                                         max_iters=lin["uMaxIters"],
                                         rhs=rhs_U)
            self._log_solve("U", info)
            st = dict(st, U=U_pred)
            for _ in range(self.n_corr):
                rAU, rAU_f, HbyA, phiHbyA, pM, p_bco2 = self._projection(
                    st, inp_t, geom, UEqn, U_bco, st["U"])
                p_new, info = fvsolve.solve(pM, st["p"], topo,
                                            symmetric=True,
                                            rel_tol=lin["pRelTol"],
                                            max_iters=lin["pMaxIters"])
                self._log_solve("p", info)
                phi_new = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f,
                                                       p_new, p_bco2)
                p_b2 = bc.boundary_value(
                    self._bco_p(p_new, inp_t, geom, phi_new), p_new, topo)
                U_new = HbyA - rAU[:, None] * fvc.grad(geom, topo, p_new,
                                                       p_b2)
                st = dict(st, U=U_new, p=p_new, phi=phi_new)
            if self.turb.model_states:
                U_b = bc.boundary_value(
                    self._bco_U(st["U"], inp_t, geom, st["phi"]), st["U"],
                    topo)
                gradU = fvc.grad(geom, topo, st["U"], U_b)
                st = self.turb.correct(st, inp_t, geom, st["phi"],
                                       gradU=gradU,
                                       rel_tol=lin["turbRelTol"],
                                       max_iters=lin["turbMaxIters"],
                                       relax=1.0, dt=self.dt, old=state_old)
                for name, inf in self.turb.last_solve_info.items():
                    self._log_solve(name, inf)
        return st

    # -- time loop --------------------------------------------------------------
    def solve_primal_history(self, state0, inputs):
        states = [state0]
        for n in range(1, self.n_steps + 1):
            states.append(self._step_ale(states[-1], inputs, n))
        return states[-1], stack_history(states)

    def solve_primal_checkpoints(self, state0, inputs, seg_len):
        raise NotImplementedError(
            "DAPimpleDyMFoam has the in-memory reverse sweep only")

    # -- time-dependent residual --------------------------------------------
    def residuals_unsteady_n(self, W, W_old, W_oldold, inputs, n):
        """The normalized residual of ALE step n, on its own geometry."""
        geom, geom_old, mesh_phi, inp_t = self._geoms(inputs, n)
        topo = self.topo
        U, p, phi = W["U"], W["p"], W["phi"]
        UEqn, U_bco = self._ueqn_ale(W, W_old, inp_t, geom, geom_old,
                                     mesh_phi)
        p_b = bc.boundary_value(self._bco_p(p, inp_t, geom, phi), p, topo)
        r_U = fvx.residual(UEqn, U, geom, topo) \
            + fvc.grad(geom, topo, p, p_b)
        _, rAU_f, _, phiHbyA, pM, p_bco = self._projection(
            W, inp_t, geom, UEqn, U_bco, U)
        r_p = fvx.residual(pM, p, geom, topo)
        r_phi = phiHbyA - fvm.laplacian_flux(geom, topo, rAU_f, p, p_bco) \
            - phi
        out = {"U": r_U, "p": r_p, "phi": r_phi}
        if self.turb.model_states:
            U_b = bc.boundary_value(U_bco, U, topo)
            gradU = fvc.grad(geom, topo, U, U_b)
            res_t = self.turb.residuals(W, inp_t, geom, phi, gradU=gradU)
            for k in self.turb.model_states:
                res_t[k] = res_t[k] + (W[k] - W_old[k]) / self.dt
            out.update(res_t)
        return self._apply_res_norm(out, geom)

    def solve_primal(self, state, inputs):
        stT, hist = self.solve_primal_history(state, inputs)
        ok = self.states_valid(stT)
        W_old = at(hist, -2)
        res = self.residuals_unsteady_n(stT, W_old, W_old, inputs,
                                        self.n_steps)
        mx = float(torch.stack([torch.max(torch.abs(v))
                                for v in res.values()]).max())
        return stT, PrimalInfo(self.n_steps, mx, ok, not ok)

    # -- per-step function on the step-n geometry -----------------------------
    def eval_function_n(self, name, W, inputs, n):
        inp_t = dict(self._inputs_at(inputs, n * self.dt))
        inp_t["points"] = self.points_at(inputs, n * self.dt)
        return self.eval_function(name, W, inp_t)

    def eval_function_history(self, name, hist, inputs):
        cfg = self.option["function"][name]
        vals = torch.stack([self.eval_function_n(name, at(hist, n), inputs, n)
                            for n in range(1, self.n_steps + 1)])
        return time_op(vals, cfg.get("timeOp", "final"), cfg), vals

    # -- unsteady adjoint PC on step n's geometry -----------------------------
    def unsteady_pc_assemble(self, W, W1, W2, inputs, n=None):
        with torch.no_grad():
            geom, geom_old, mesh_phi, inp_t = self._geoms(inputs, n)
            UEqn, U_bco = self._ueqn_ale(W, W1, inp_t, geom, geom_old,
                                         mesh_phi)
            pM = self._projection(W, inp_t, geom, UEqn, U_bco, W["U"])[4]
            mats = {"U": UEqn, "p": pM}
            if self.turb.model_states:
                U_b = bc.boundary_value(U_bco, W["U"], self.topo)
                gradU = fvc.grad(geom, self.topo, W["U"], U_b)
                for k, (m, _sym) in self.turb.pc_matrices(
                        W, inp_t, geom, W["phi"], gradU).items():
                    mats[k] = m + fvm.ddt(geom, self.topo, W[k], W1[k],
                                          self.dt)
        return mats

    def solve_unsteady_adjoint(self, hist, inputs, func_name):
        """(totals, the per-step adjoint residuals, step T first)."""
        with torch.no_grad():
            _, vals = self.eval_function_history(func_name, hist, inputs)
        return unsteady_adjoint_totals(
            self.residuals_unsteady_n,
            lambda W, x, n: self.eval_function_n(func_name, W, x, n),
            hist, **self._sweep_kw(inputs, func_name, vals))
