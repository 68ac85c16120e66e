"""Pre/post-processing utilities: DAFoam's src/utilities programs.

Port of ``dafoam_tpu.utils.prepost``. DAFoam's counterparts:
  preProcessing/deformDynMesh/deformDynMesh.C        -> deform_dyn_mesh
  preProcessing/setBoundaryLayerPatch/...C           -> set_boundary_layer_patch
  preProcessing/setProbeData/setProbeData.C          -> set_probe_data
  postProcessing/getProbeTimeSeries/...C             -> probe_time_series
  postProcessing/getFieldRMSETimeSeries/...C         -> field_rmse_time_series
  postProcessing/calcForcePerS{In,}compressible/...C -> calc_force_per_s

DAFoam builds each as a standalone OpenFOAM application that reads and
writes time directories. Here they are host-side float64 numpy functions
over a solver's fields (histories are stacked arrays, meshes are (points,
topo)); tensors are read back from their device first. The CLI
subcommands in ``dafoam_tpu_torch.scripts.cli`` apply them to checkpoint
archives. The solver-based ones work on either face layout: the dense-DIA
layout keeps the boundary faces, their order and their owners, so
per-patch and per-boundary-face results are the canonical ones.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a):
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# probe helpers
# ---------------------------------------------------------------------------
def find_cell(cell_centres, coord, mode="findNearestCell", max_dist=None):
    """Cell index for a probe coordinate.

    Reference setProbeData.C mode option {findCell, findNearestCell}:
    OpenFOAM's findCell does exact containment; on our cell-centre data
    'findCell' means nearest centre within `max_dist` (local cell size),
    returning -1 outside — 'findNearestCell' never fails."""
    cc = _host(cell_centres)
    d2 = np.sum((cc - _host(coord)[None, :]) ** 2, axis=1)
    i = int(np.argmin(d2))
    if mode == "findCell":
        if max_dist is None:
            # heuristic containment radius: distance to nearest other centre
            d2i = np.sum((cc - cc[i]) ** 2, axis=1)
            d2i[i] = np.inf
            max_dist = np.sqrt(d2i.min())
        if np.sqrt(d2[i]) > max_dist:
            return -1
    return i


def probe_time_series(hist_var, cell_centres, coord, mode="findNearestCell"):
    """Extract the value time series at a probe point.

    hist_var : (T, nc) or (T, nc, k) stacked history of one variable
    -> (T,) or (T, k) array.  Reference getProbeTimeSeries.C:70-152 reads
    each time directory and writes var[probeCellI] per step."""
    i = find_cell(cell_centres, coord, mode=mode)
    if i < 0:
        raise ValueError(f"probe point {coord} is not inside a cell")
    return _host(hist_var)[:, i]


def set_probe_data(field, cell_centres, coord, value, mode="findCell"):
    """Set `value` at the probe cell of `field` (returns a copy).

    Reference setProbeData.C: writes the prescribed value into the cell
    containing probeCoord (scalar fields take value[0])."""
    f = np.array(_host(field), copy=True)
    i = find_cell(cell_centres, coord, mode=mode)
    if i < 0:
        raise ValueError(f"probe point {coord} is not inside a cell")
    v = np.asarray(_host(value), dtype=f.dtype)
    f[i] = v if f.ndim > 1 else v.reshape(-1)[0]
    return f


# ---------------------------------------------------------------------------
# time-series metrics
# ---------------------------------------------------------------------------
def field_rmse_time_series(hist_a, hist_b):
    """Per-step RMSE between two field histories.

    Reference getFieldRMSETimeSeries.C: for each time step computes
    sqrt(sum((var - varData)^2) / nCells) (vector fields sum over the
    3 components before dividing by nCells).
    hist_* : (T, nc) or (T, nc, 3) -> (T,)."""
    a = _host(hist_a).astype(np.float64)
    b = _host(hist_b).astype(np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    d2 = (a - b) ** 2
    n_cells = a.shape[1]
    axes = tuple(range(1, a.ndim))
    return np.sqrt(d2.sum(axis=axes) / n_cells)


# ---------------------------------------------------------------------------
# mesh pre-processing
# ---------------------------------------------------------------------------
def deform_dyn_mesh(points, origin, omega, dt, n_steps):
    """Rigid x-y rotation time series of the mesh points.

    Reference deformDynMesh.C:106-132: per step rotate the CURRENT points
    by theta = omega*dt about `origin` in the x-y plane (cumulative), and
    write points into each time directory.
    -> (n_steps, n_points, 3) array (step i holds t=(i+1)*dt points)."""
    pts = _host(points).astype(np.float64)
    o = np.asarray(origin, np.float64)
    th = omega * dt
    c, s = np.cos(th), np.sin(th)
    out = np.empty((n_steps,) + pts.shape, np.float64)
    for i in range(n_steps):
        x = pts[:, 0] - o[0]
        y = pts[:, 1] - o[1]
        pts = pts.copy()
        pts[:, 0] = c * x - s * y + o[0]
        pts[:, 1] = s * x + c * y + o[1]
        out[i] = pts
    return out


def set_boundary_layer_patch(solver, u_patch, patch, bl_height, U0,
                             flow_axis=0, mode="parabolic"):
    """Parabolic boundary-layer inflow profile on a patch.

    Reference setBoundaryLayerPatch.C:158-186: for faces with wall
    distance y <= blHeight set
        U[comp] = 2 U0/L^2 (L y - y^2/2),
    else U0, leaving the other components.  Wall distance at patch faces
    is the zeroGradient extrapolation of the cell field (reference builds
    y with zeroGradient BCs and correctBoundaryConditions), i.e. the
    owner-cell value.

    u_patch : (n_faces_on_patch, 3) current BC value array -> new array.
    """
    if mode != "parabolic":
        raise NotImplementedError(f"mode {mode!r} (options: parabolic)")
    topo = solver.topo
    p = next(pp for pp in topo.patches if pp.name == patch)
    own_b = np.asarray(topo.owner[p.start:p.start + p.size])
    y = _host(solver.wall_dist).astype(np.float64)[own_b]
    L = float(bl_height)
    prof = np.where(y <= L, (2.0 * U0 / L ** 2) * (L * y - 0.5 * y * y), U0)
    out = np.array(_host(u_patch), copy=True, dtype=np.float64)
    out[:, flow_axis] = prof
    return out


# ---------------------------------------------------------------------------
# surface force distribution
# ---------------------------------------------------------------------------
def calc_force_per_s(solver, state, inputs, patches, vtk_path=None):
    """Per-face traction (force per unit area) on wall patches.

    Reference calcForcePerS{In,}compressible.C: forcePerS = (pressure +
    viscous traction)/|Sf| per face, written as a surface field.  Reuses
    the solver's force-function assembly (functions/registry._wall_force:
    fp = Sf rho (p-pRef), fv = -rho nuEff (gradU+gradU^T).Sf) so the
    numbers match the force/moment objectives exactly.

    -> (n_boundary, 3) numpy array, zero off the selected patches; also
    writes a VTK surface file when vtk_path is given."""
    from dafoam_tpu_torch.functions.registry import _wall_force
    with torch.no_grad():
        ctx = solver.function_ctx(state, inputs)
        f = _host(_wall_force({"patches": list(patches)}, ctx)).astype(
            np.float64)
    ni = solver.topo.n_internal
    mags = np.maximum(_host(ctx["geom"].magsf[ni:]).astype(np.float64),
                      1e-300)
    fps = f / mags[:, None]
    if vtk_path is not None:
        from dafoam_tpu_torch.utils.vtkio import write_surface_vtk
        rows = np.concatenate(
            [fps[solver.topo.patch_slice(p).start - ni:
                 solver.topo.patch_slice(p).stop - ni] for p in patches])
        write_surface_vtk(vtk_path, solver.points, solver.topo,
                          list(patches), cell_data={"forcePerS": rows})
    return fps
