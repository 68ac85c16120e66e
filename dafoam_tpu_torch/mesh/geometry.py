"""Mesh geometry on the device: a torch function of the point coordinates.

Port of ``dafoam_tpu.mesh.geometry``: OpenFOAM's
``primitiveMeshFaceCentresAndAreas`` / ``primitiveMeshCellCentresAndVols``
(triangle decomposition about the estimated face centre, pyramid
decomposition about the estimated cell centre) and the
``surfaceInterpolation`` weights and delta coefficients, vectorized over
static shapes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dafoam_tpu_torch.mesh.topology import MeshTopology
from dafoam_tpu_torch.ops.core import (boundary_gather, boundary_scatter_add,
                                       cell_to_face_nei, cell_to_face_own,
                                       face_sum_pair, float_tensor,
                                       index_tensor)


class MeshGeometry(NamedTuple):
    """All geometric mesh quantities (tensors on one device).

    Face-indexed arrays cover ALL faces (internal first, then boundary).
    """

    cf: torch.Tensor            # (nf, 3) face centres
    sf: torch.Tensor            # (nf, 3) face area vectors, owner -> nei
    magsf: torch.Tensor         # (nf,)   face areas
    cc: torch.Tensor            # (nc, 3) cell centres
    vol: torch.Tensor           # (nc,)   cell volumes
    weights: torch.Tensor       # (nf,)   linear interp weight of OWNER value
    delta_coeffs: torch.Tensor  # (nf,)   1/|d|; boundary: 1/|cf - cc_own|
    nonorth_dc: torch.Tensor    # (nf,)   non-orthogonal-corrected delta coeffs
    corr_vec: torch.Tensor      # (nf, 3) non-orth correction vectors


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _norm(v):
    return torch.sqrt(_dot(v, v))


def _safe_norm(v):
    """|v|, exactly 0 at v = 0 (kept in the double-where form so that a
    later autograd pass has a zero, not NaN, gradient there)."""
    s2 = _dot(v, v)
    pos = s2 > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, s2, 1.0)), 0.0)


def _face_centres_areas(points, topo: MeshTopology):
    """Face centres/areas by triangle decomposition about the average point.

    Padded vertices repeat the first vertex, so their triangles are
    degenerate and contribute exactly zero to both area and centroid sums.
    """
    dev, dtype = points.device, points.dtype
    fv = index_tensor(topo, "face_verts", dev, lambda: topo.face_verts)
    maxnv = topo.face_verts.shape[1]
    nv = float_tensor(topo, "face_nverts", dev, dtype,
                      lambda: topo.face_nverts.astype(np.float64))
    pad_count = float_tensor(
        topo, "face_pad", dev, dtype,
        lambda: (maxnv - topo.face_nverts).astype(np.float64))
    pts = points[fv]                                   # (nf, maxnv, 3)

    # estimated centre: average of the true vertices (padding repeats
    # vertex 0 -> subtract the overcount)
    sum_pts = pts.sum(dim=1) - pad_count[:, None] * points[fv[:, 0]]
    c_est = sum_pts / nv[:, None]

    nxt = pts[:, list(range(1, maxnv)) + [0], :]       # next vertex, cyclic
    # triangle (p_i, p_{i+1}, c_est)
    t_sf = 0.5 * torch.linalg.cross(nxt - pts, c_est[:, None, :] - pts,
                                    dim=-1)
    t_c = (pts + nxt + c_est[:, None, :]) / 3.0

    sf = t_sf.sum(dim=1)
    magsf_t = _safe_norm(t_sf)                          # (nf, maxnv)
    sum_a = magsf_t.sum(dim=1)
    cf = (t_c * magsf_t[..., None]).sum(dim=1) \
        / torch.clamp_min(sum_a, 1e-36)[:, None]
    # degenerate (zero-area) faces of the dense layout fall back to the
    # estimated centre
    cf = torch.where(sum_a[:, None] > 1e-14, cf, c_est)
    magsf = _safe_norm(sf)
    return cf, sf, magsf


def _cell_faces_static(topo: MeshTopology):
    """Per-cell REAL-face count + internal-face validity mask (numpy).

    Degenerate padding faces of the dense-DIA layout are excluded from the
    estimated-cell-centre average. Cached on the topology.
    """
    cached = getattr(topo, "_cell_faces_static", None)
    if cached is not None:
        return cached
    nc, ni = topo.n_cells, topo.n_internal
    dd = topo.dia_dense()
    if dd is not None:
        valid = dd[1].reshape(-1).astype(np.float64)
    else:
        valid = np.ones((ni,), dtype=np.float64)
    m = valid > 0.5
    nfc = np.zeros((nc,), dtype=np.float64)
    np.add.at(nfc, topo.owner[:ni][m], 1.0)
    np.add.at(nfc, topo.neighbour[m], 1.0)
    np.add.at(nfc, topo.owner[ni:], 1.0)
    out = (nfc, valid)
    object.__setattr__(topo, "_cell_faces_static", out)
    return out


def _cell_centres_vols(cf, sf, topo: MeshTopology):
    """Cell centres/volumes by pyramid decomposition about the estimated
    centre."""
    ni = topo.n_internal
    dev, dtype = cf.device, cf.dtype
    wf = float_tensor(topo, "face_valid", dev, dtype,
                      lambda: _cell_faces_static(topo)[1])[:, None]
    nfc = float_tensor(topo, "cell_nfaces", dev, dtype,
                       lambda: _cell_faces_static(topo)[0])

    # estimated cell centre: average of REAL face centres
    cf_i = cf[:ni] * wf
    c_est = face_sum_pair(cf_i, cf_i, topo)
    c_est = boundary_scatter_add(c_est, cf[ni:], topo)
    c_est = c_est / nfc[:, None]

    ce_own_i = cell_to_face_own(c_est, topo)           # (ni, 3)
    ce_nei_i = cell_to_face_nei(c_est, topo)
    ce_own_b = boundary_gather(c_est, topo)

    def pyr(faces_cf, faces_sf, ce, sign):
        # pyramid volume = sign * (Sf . (Cf - Cest)) / 3
        pv = sign * _dot(faces_sf, faces_cf - ce) / 3.0
        pc = 0.75 * faces_cf + 0.25 * ce
        return pv, pc

    pv_oi, pc_oi = pyr(cf[:ni], sf[:ni], ce_own_i, 1.0)
    pv_ni, pc_ni = pyr(cf[:ni], sf[:ni], ce_nei_i, -1.0)
    pv_ob, pc_ob = pyr(cf[ni:], sf[ni:], ce_own_b, 1.0)

    vol = face_sum_pair(pv_oi, pv_ni, topo)
    vol = boundary_scatter_add(vol, pv_ob, topo)
    ctr = face_sum_pair(pc_oi * pv_oi[:, None], pc_ni * pv_ni[:, None], topo)
    ctr = boundary_scatter_add(ctr, pc_ob * pv_ob[:, None], topo)

    cc = ctr / torch.clamp_min(vol, 1e-36)[:, None]
    cc = torch.where(vol[:, None] > 1e-36, cc, c_est)
    return cc, vol


def compute_geometry(points: torch.Tensor, topo: MeshTopology) -> MeshGeometry:
    """points (n_points, 3) -> full geometry, on the points' device/dtype."""
    dtype = points.dtype
    cf, sf, magsf = _face_centres_areas(points, topo)
    cc, vol = _cell_centres_vols(cf, sf, topo)
    ni = topo.n_internal

    nhat = sf / torch.clamp_min(magsf, 1e-36)[:, None]

    # ---- internal faces --------------------------------------------------
    cc_own_i = cell_to_face_own(cc, topo)
    cc_nei_i = cell_to_face_nei(cc, topo)
    d_i = cc_nei_i - cc_own_i                          # owner -> neighbour
    sfd_own = _dot(nhat[:ni], cf[:ni] - cc_own_i)
    sfd_nei = _dot(nhat[:ni], cc_nei_i - cf[:ni])
    # OpenFOAM surfaceInterpolation::makeWeights: w = SfdNei/(SfdOwn+SfdNei),
    # weight applied to the OWNER value
    den = sfd_own + sfd_nei
    w_i = sfd_nei / torch.where(torch.abs(den) > 1e-36, den, 1.0)
    dist_i = _norm(d_i)
    dc_i = 1.0 / torch.clamp_min(dist_i, 1e-36)
    # nonOrthDeltaCoeffs: 1 / max(nhat.d, 0.05 |d|)
    nd = _dot(nhat[:ni], d_i)
    nodc_i = 1.0 / torch.maximum(nd, 0.05 * dist_i)
    corr_i = nhat[:ni] - nodc_i[:, None] * d_i        # correction vectors

    # ---- boundary faces ----------------------------------------------------
    d_b = cf[ni:] - boundary_gather(cc, topo)
    dist_b = _norm(d_b)
    dc_b = 1.0 / torch.clamp_min(dist_b, 1e-36)
    nd_b = _dot(nhat[ni:], d_b)
    nodc_b = 1.0 / torch.maximum(nd_b, 0.05 * dist_b)
    corr_b = nhat[ni:] - nodc_b[:, None] * d_b
    w_b = torch.ones((topo.n_faces - ni,), dtype=dtype, device=points.device)

    return MeshGeometry(
        cf=cf, sf=sf, magsf=magsf, cc=cc, vol=vol,
        weights=torch.cat([w_i, w_b]),
        delta_coeffs=torch.cat([dc_i, dc_b]),
        nonorth_dc=torch.cat([nodc_i, nodc_b]),
        corr_vec=torch.cat([corr_i, corr_b]),
    )
