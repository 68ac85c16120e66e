"""Surface VTK writer for sensitivity maps and boundary fields.

Port of ``dafoam_tpu.utils.vtkio``: host-side numpy writers; tensors
(points, fields, totals) are read back from their device first.

Observability parity with the reference's writeSensMapSurface /
writeAdjointFields ParaView dumps (DASolver.C:3840, :4055): write boundary
patches as legacy-VTK PolyData with per-face cell data (e.g. dJ/dXs
sensitivity maps, pressure, wall shear).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def write_surface_vtk(path, points, topo, patches, cell_data=None):
    """Write the boundary faces of `patches` as legacy VTK POLYDATA.

    cell_data: {name: (n_patch_faces,) or (n_patch_faces,3) arrays in the
    concatenated patch-face order}.
    """
    pts = _host(points)
    fids = []
    for name in patches:
        sl = topo.patch_slice(name)
        fids.extend(range(sl.start, sl.stop))

    used = sorted({int(v) for f in fids
                   for v in topo.face_verts[f, :topo.face_nverts[f]]})
    remap = {p: i for i, p in enumerate(used)}

    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n"
                 "dafoam_tpu_torch surface output\nASCII\nDATASET POLYDATA\n")
        fh.write(f"POINTS {len(used)} double\n")
        for p in used:
            fh.write("%.10g %.10g %.10g\n" % tuple(pts[p]))
        total = sum(int(topo.face_nverts[f]) + 1 for f in fids)
        fh.write(f"POLYGONS {len(fids)} {total}\n")
        for f in fids:
            k = int(topo.face_nverts[f])
            ids = [remap[int(v)] for v in topo.face_verts[f, :k]]
            fh.write(str(k) + " " + " ".join(map(str, ids)) + "\n")
        if cell_data:
            fh.write(f"CELL_DATA {len(fids)}\n")
            for name, arr in cell_data.items():
                a = _host(arr)
                if a.ndim == 1:
                    fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    for v in a:
                        fh.write("%.10g\n" % v)
                else:
                    fh.write(f"VECTORS {name} double\n")
                    for v in a:
                        fh.write("%.10g %.10g %.10g\n" % tuple(v))
    return path


def write_volume_vtk(path, points, topo, cell_data=None):
    """Write the full cell volume as legacy VTK UNSTRUCTURED_GRID.

    Cells are emitted as VTK_CONVEX_POINT_SET (type 41): each cell lists
    the union of its faces' vertices — exact for the convex FV cells this
    framework uses, with no per-shape case analysis. `cell_data` maps
    field name -> (n_cells,) or (n_cells,3) arrays.

    Observability parity with the reference's volume-field ParaView dumps
    (writeSensMapField / writeAdjointFields, DASolver.C:3962, :4055).
    """
    pts = _host(points)
    nc = topo.n_cells
    own = np.asarray(topo.owner)
    nei = np.asarray(topo.neighbour)
    cell_verts = [set() for _ in range(nc)]
    fv, fn = np.asarray(topo.face_verts), np.asarray(topo.face_nverts)
    for f in range(topo.n_faces):
        vs = fv[f, :fn[f]].tolist()
        cell_verts[own[f]].update(vs)
        if f < len(nei) and nei[f] >= 0:
            cell_verts[nei[f]].update(vs)
    with open(path, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n"
                 "dafoam_tpu_torch volume output\nASCII\nDATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {len(pts)} double\n")
        for p in pts:
            fh.write("%.10g %.10g %.10g\n" % tuple(p))
        total = sum(len(cv) + 1 for cv in cell_verts)
        fh.write(f"CELLS {nc} {total}\n")
        for cv in cell_verts:
            ids = sorted(cv)
            fh.write(str(len(ids)) + " " + " ".join(map(str, ids)) + "\n")
        fh.write(f"CELL_TYPES {nc}\n")
        fh.write("41\n" * nc)
        if cell_data:
            fh.write(f"CELL_DATA {nc}\n")
            for name, arr in cell_data.items():
                a = _host(arr)
                if a.ndim == 1:
                    fh.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                    for v in a:
                        fh.write("%.10g\n" % v)
                else:
                    fh.write(f"VECTORS {name} double\n")
                    for v in a:
                        fh.write("%.10g %.10g %.10g\n" % tuple(v))
    return path


def write_adjoint_fields(path, solver, psi):
    """Dump the adjoint solution psi as volume fields for ParaView
    (reference writeAdjointFields role, DASolver.C:4055): every cell-based
    adjoint state becomes a cell-data field named psi_<state>; the face
    state (phi) is reduced to its cell-wise incident mean psi_phi."""
    topo = solver.topo
    data = {}
    for name, kind in solver.layout.info.ordered:
        a = _host(psi[name])
        if kind == "face":
            acc = np.zeros(topo.n_cells)
            cnt = np.zeros(topo.n_cells)
            own = np.asarray(topo.owner)
            nei = np.asarray(topo.neighbour)
            np.add.at(acc, own, a[:len(own)])
            np.add.at(cnt, own, 1.0)
            ni = len(nei)
            np.add.at(acc, nei[nei >= 0], a[:ni][nei >= 0])
            np.add.at(cnt, nei[nei >= 0], 1.0)
            data["psi_" + name] = acc / np.maximum(cnt, 1.0)
        else:
            data["psi_" + name] = a
    return write_volume_vtk(path, _host(solver.points), topo, data)


def write_sens_map_field(path, solver, field, name="dJdField"):
    """Volume sensitivity map (e.g. dJ/dbeta for field inversion) ->
    VTK cell data (reference writeSensMapField role, DASolver.C:3962)."""
    return write_volume_vtk(path, _host(solver.points), solver.topo,
                            {name: _host(field)})


def write_sens_map_surface(path, solver, totals, patches):
    """dJ/dXs sensitivity map on wall patches -> VTK (reference
    writeSensMapSurface role): nodal point gradients averaged to faces."""
    topo = solver.topo
    g = _host(totals["points"])
    fids = []
    for name in patches:
        sl = topo.patch_slice(name)
        fids.extend(range(sl.start, sl.stop))
    face_sens = np.zeros((len(fids), 3))
    for i, f in enumerate(fids):
        k = int(topo.face_nverts[f])
        face_sens[i] = g[topo.face_verts[f, :k]].mean(axis=0)
    return write_surface_vtk(path, _host(solver.points), topo, patches,
                             {"dJdXs": face_sens})
