"""Typed, differentiable output extraction (DAOutput family).

Port of ``dafoam_tpu.outputs``: each type maps (state, inputs) -> a flat
output tensor. Because these are plain torch functions, dOutput/dW and
dOutput/dX transposed products (calcJacTVecProduct, reference
DASolver.C:1727-1737) are one backward pass each.

Layout conventions preserved (SURVEY.md §2.5):
- forceCouplingOutput: NODAL (mesh-point) forces over the named patches,
  size 3*nPatchPoints, layout [fX..., fY..., fZ...]
  (DAOutputForceCoupling.C:45-68), consumed as f_aero by MPhys load
  transfer;
- thermalCouplingOutput: 2*nCouplingFaces, first half near-wall
  temperature, second half interface conductance kappa/d
  (DAOutputThermalCoupling.C:42-66).
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.functions.registry import _wall_force


def patch_face_ids(topo, patches):
    ids = []
    for name in patches:
        sl = topo.patch_slice(name)
        ids.extend(range(sl.start, sl.stop))
    return np.asarray(ids, dtype=np.int64)


def patch_point_ids(topo, patches):
    """Unique mesh-point ids on the named patches (sorted)."""
    fids = patch_face_ids(topo, patches)
    pts = set()
    for f in fids:
        k = topo.face_nverts[f]
        pts.update(topo.face_verts[f, :k].tolist())
    return np.asarray(sorted(pts), dtype=np.int64)


class OutputRegistry:
    def __init__(self, solver, output_info: dict):
        self.solver = solver
        self.info = output_info

    def size(self, name: str) -> int:
        cfg = self.info[name]
        t = cfg["type"]
        if t == "function":
            return 1
        if t == "residual":
            return self.solver.layout.n_states
        if t == "forceCouplingOutput":
            return 3 * len(patch_point_ids(self.solver.topo, cfg["patches"]))
        if t == "thermalCouplingOutput":
            return 2 * len(patch_face_ids(self.solver.topo, cfg["patches"]))
        raise NotImplementedError(t)

    def evaluate(self, name: str, state, inputs):
        cfg = self.info[name]
        t = cfg["type"]
        solver = self.solver
        if t == "function":
            return torch.atleast_1d(
                solver.eval_function(cfg["functionName"], state, inputs))
        if t == "residual":
            return solver.layout.pack(solver._norm_residuals(state, inputs))
        if t == "forceCouplingOutput":
            return self.force_coupling(cfg, state, inputs)
        if t == "thermalCouplingOutput":
            return self.thermal_coupling(cfg, state, inputs)
        raise NotImplementedError(t)

    # ------------------------------------------------------------------
    def force_coupling(self, cfg, state, inputs):
        """Nodal surface forces [fX..., fY..., fZ...] (FSI f_aero): each
        face force is shared equally by its vertices."""
        solver = self.solver
        topo = solver.topo
        ctx = solver.function_ctx(state, inputs)
        f_face = _wall_force({"patches": cfg["patches"]}, ctx)  # (nb,3)
        pids = patch_point_ids(topo, cfg["patches"])
        pid_of = {int(p): i for i, p in enumerate(pids)}
        fids = patch_face_ids(topo, cfg["patches"])
        ni = topo.n_internal
        rows, cols, w = [], [], []
        for f in fids:
            k = int(topo.face_nverts[f])
            for v in topo.face_verts[f, :k]:
                rows.append(pid_of[int(v)])
                cols.append(f - ni)
                w.append(1.0 / k)
        dev = f_face.device
        rows = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        cols = torch.as_tensor(cols, dtype=torch.int64, device=dev)
        w = torch.as_tensor(w, dtype=f_face.dtype, device=dev)
        f_nodal = f_face.new_zeros((len(pids), 3)).index_add(
            0, rows, w[:, None] * f_face[cols])
        return f_nodal.T.reshape(-1)  # [fX..., fY..., fZ...]

    def thermal_coupling(self, cfg, state, inputs):
        """[T_nearwall..., kappa/d...] over the coupling faces (CHT)."""
        solver = self.solver
        topo = solver.topo
        ni = topo.n_internal
        geom = solver.geometry(inputs)
        fids = patch_face_ids(topo, cfg["patches"])
        bidx = torch.as_tensor(fids - ni, device=geom.vol.device)
        own = torch.as_tensor(topo.owner[ni:][fids - ni].astype(np.int64),
                              device=geom.vol.device)
        T = state.get("T")
        if T is None:
            raise KeyError("thermalCouplingOutput needs a T state")
        T_near = T[own]
        dc = geom.nonorth_dc[ni:][bidx]
        kappa = solver.thermal_conductance(state, inputs, geom)  # (nb,)
        return torch.cat([T_near, kappa[bidx] * dc])
