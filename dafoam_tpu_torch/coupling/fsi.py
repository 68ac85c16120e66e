"""Aerostructural (FSI) coupling: flexible wall under flow loading.

Port of ``dafoam_tpu.coupling.fsi``. Re-designs the reference's
aerostructural path (MPhys DAFoamForces mphys_dafoam.py:1004 +
DAFoamWarper :804 + TACS, exercised by tests/runRegTests_AeroStruct.py)
with the in-house solid solver:

  fluid wall loads (pressure + viscous)  ->  solid traction BC
  solid interface displacement           ->  fluid volume-mesh warp (IDW)

and ONE residual over the union state, so the coupled adjoint (including
the load- and displacement-transfer Jacobian blocks) is the same recorded
graph + GMRES machinery as single physics (``cht.coupled_adjoint``).

Assumes matching interface discretizations (fluid patch faces and solid
patch faces in the same order, true for meshes from box_hex_mesh with
equal nx; the dense-DIA face layout keeps the boundary faces in order).
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.coupling.cht import coupled_adjoint, state_scales
from dafoam_tpu_torch.functions.registry import _wall_force
from dafoam_tpu_torch.mdo.warp import IDWarp


class FSICoupling:
    def __init__(self, fluid, solid, fluid_patch: str, solid_patch: str,
                 warp_k: int = 12):
        self.fluid = fluid
        self.solid = solid
        self.fp = fluid_patch
        self.sp = solid_patch
        tf, ts = fluid.topo, solid.topo
        n_if = tf.patch(fluid_patch).size
        assert n_if == ts.patch(solid_patch).size

        # fluid surface points on the interface + face->point average map
        pts0 = fluid.points.detach().cpu().numpy()
        fsl = tf.patch_slice(fluid_patch)
        surf_pts = sorted({int(v) for f in range(fsl.start, fsl.stop)
                           for v in tf.face_verts[f, :tf.face_nverts[f]]})
        self.surf_ids = np.asarray(surf_pts)
        pid_of = {p: i for i, p in enumerate(surf_pts)}
        rows, cols = [], []
        for j, f in enumerate(range(fsl.start, fsl.stop)):
            k = int(tf.face_nverts[f])
            for v in tf.face_verts[f, :k]:
                rows.append(pid_of[int(v)])
                cols.append(j)
        Wm = np.zeros((len(surf_pts), n_if))
        np.add.at(Wm, (rows, cols), 1.0)
        Wm /= np.maximum(Wm.sum(axis=1, keepdims=True), 1.0)
        self._face2pt = torch.as_tensor(Wm, dtype=fluid.dtype,
                                        device=fluid.device)
        self.n_if = n_if

        # IDW warp of the fluid volume points driven by the surface points;
        # all other boundary points held fixed
        boundary_pts = set()
        for p in tf.patches:
            if p.name == fluid_patch or p.kind == "empty":
                continue
            for f in range(p.start, p.start + p.size):
                for v in tf.face_verts[f, :tf.face_nverts[f]]:
                    boundary_pts.add(int(v))
        fixed = np.asarray(sorted(boundary_pts - set(surf_pts)))
        self.warp = IDWarp(pts0, self.surf_ids, fixed, k=warp_k,
                           device=fluid.device, dtype=fluid.dtype)

    # -- transfers ---------------------------------------------------------
    def _solid_disp_b(self, state_s, inputs_s):
        """Interface face displacements of the solid (nb_if, 3)."""
        geom_s = self.solid.geometry(inputs_s)
        Db = self.solid.boundary_fields(state_s, inputs_s, geom_s)["D"]
        return Db[self.solid.topo.patch_bslice(self.sp)]

    def _warped_fluid_inputs(self, inputs_f, state_s, inputs_s):
        disp_face = self._solid_disp_b(state_s, inputs_s)   # (n_if, 3)
        disp_pt = self._face2pt @ disp_face                 # (n_surf_pts, 3)
        out = dict(inputs_f)
        out["points"] = self.warp(inputs_f["points"], disp_pt)
        return out

    def _traction(self, state_f, inputs_f_warped):
        """Fluid traction on the interface faces (n_if, 3), force/area."""
        ctx = self.fluid.function_ctx(state_f, inputs_f_warped)
        f_face = _wall_force({"patches": [self.fp]}, ctx)
        sl = self.fluid.topo.patch_bslice(self.fp)
        area = ctx["geom"].magsf[self.fluid.topo.n_internal:][sl]
        return f_face[sl] / area[:, None]

    def _solid_inputs_with_load(self, inputs_s, state_f, inputs_f_warped):
        t = self._traction(state_f, inputs_f_warped)        # (n_if, 3)
        # approximate traction BC: snGrad(D) = -t / (2 mu + lambda)
        # (fluid traction acts on the solid surface with opposite normal)
        mu, lam, _ = self.solid._props(inputs_s)
        g = -t / (2.0 * mu + lam)
        out = dict(inputs_s)
        out["bc"] = {k: dict(v) for k, v in inputs_s["bc"].items()}
        out["bc"].setdefault("D", {})[self.sp] = g
        return out

    def interface_displacement(self, state_s, inputs_s):
        """Diagnostics: max |D| over the solid's interface faces."""
        with torch.no_grad():
            return torch.max(torch.abs(self._solid_disp_b(state_s,
                                                          inputs_s)))

    # -- coupled primal ------------------------------------------------------
    def solve_primal(self, state_f, state_s, inputs_f, inputs_s,
                     n_outer=10):
        for _ in range(n_outer):
            with torch.no_grad():
                inf = self._warped_fluid_inputs(inputs_f, state_s, inputs_s)
            state_f, info_f = self.fluid.run_primal(state_f, inf)
            with torch.no_grad():
                ins = self._solid_inputs_with_load(inputs_s, state_f, inf)
            state_s, info_s = self.solid.run_primal(state_s, ins)
        return state_f, state_s, (info_f, info_s)

    # -- coupled residual ------------------------------------------------------
    def residuals(self, W, inputs_f, inputs_s):
        inf = self._warped_fluid_inputs(inputs_f, W["solid"], inputs_s)
        rf = self.fluid._norm_residuals(W["fluid"], inf)
        ins = self._solid_inputs_with_load(inputs_s, W["fluid"], inf)
        rs = self.solid._norm_residuals(W["solid"], ins)
        return {"fluid": rf, "solid": rs}

    def eval_function(self, W, inputs_f, inputs_s, side, name):
        inf = self._warped_fluid_inputs(inputs_f, W["solid"], inputs_s)
        if side == "fluid":
            return self.fluid.eval_function(name, W["fluid"], inf)
        ins = self._solid_inputs_with_load(inputs_s, W["fluid"], inf)
        return self.solid.eval_function(name, W["solid"], ins)

    # -- coupled adjoint ---------------------------------------------------------
    def solve_adjoint(self, state_f, state_s, inputs_f, inputs_s, side,
                      name, restart=200, rel_tol=1e-9, max_iters=3000,
                      return_psi=False):
        return coupled_adjoint(
            self.residuals,
            lambda w, xf, xs: self.eval_function(w, xf, xs, side, name),
            {"fluid": state_f, "solid": state_s}, inputs_f, inputs_s,
            state_scales(self.fluid, self.solid, inputs_f, inputs_s),
            restart, rel_tol, max_iters, return_psi)
