"""Wall distance (host side, numpy + scipy).

A copy of ``dafoam_tpu.mesh.walldist``; the port computes the field once
on the host and moves it to the device. The reference forces a frozen
meshWave wall distance for adjoint accuracy (option forceMeshWaveFrozen
/ wallDist method, src/adjoint/DAMisc/meshWaveFrozen, DASolver.C:4433): d
is computed once and NOT differentiated.
Here the frozen field is the EXACT nearest distance from each cell centre
to the triangulated wall surface (not just to face centres, which
overestimates d next to large faces and biases y+ / SA destruction),
computed at preprocessing with a KD-tree candidate search — O(nc log nw),
scaling to 10^6+ cells.
"""

from __future__ import annotations

import numpy as np


def wall_face_mask(topo, kinds=("wall",), names=()):
    m = np.zeros((topo.n_faces - topo.n_internal,), dtype=bool)
    for p in topo.patches:
        if p.kind in kinds or p.name in names:
            s = p.start - topo.n_internal
            m[s:s + p.size] = True
    return m


def _point_triangle_distance(p, a, b, c):
    """Vectorized exact point-to-triangle distance.

    p, a, b, c: (..., 3). Interior: plane distance; else nearest edge.
    """
    ab, ac, ap = b - a, c - a, p - a
    n = np.cross(ab, ac)
    nn = np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-36)
    nh = n / nn
    dist_plane = np.abs(np.einsum("...i,...i->...", ap, nh))
    # barycentric coords of the in-plane projection
    d00 = np.einsum("...i,...i->...", ab, ab)
    d01 = np.einsum("...i,...i->...", ab, ac)
    d11 = np.einsum("...i,...i->...", ac, ac)
    d20 = np.einsum("...i,...i->...", ap, ab)
    d21 = np.einsum("...i,...i->...", ap, ac)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-36)
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    inside = (v >= 0.0) & (w >= 0.0) & (v + w <= 1.0)

    def seg(p, s0, s1):
        d = s1 - s0
        t = np.einsum("...i,...i->...", p - s0, d) / np.maximum(
            np.einsum("...i,...i->...", d, d), 1e-36)
        t = np.clip(t, 0.0, 1.0)
        q = s0 + t[..., None] * d
        return np.linalg.norm(p - q, axis=-1)

    d_edge = np.minimum(np.minimum(seg(p, a, b), seg(p, b, c)),
                        seg(p, c, a))
    return np.where(inside, dist_plane, d_edge)


def _wall_triangles(points, topo, mask):
    """Fan-triangulate the masked wall faces about their centroids ->
    (ntri, 3, 3) vertex arrays + (ntri,) face index map."""
    ni = topo.n_internal
    fids = np.nonzero(mask)[0] + ni
    pts = np.asarray(points)
    tris, owner_face = [], []
    for f in fids:
        k = int(topo.face_nverts[f])
        vs = pts[topo.face_verts[f, :k]]
        centroid = vs.mean(axis=0)
        for i in range(k):
            tris.append((centroid, vs[i], vs[(i + 1) % k]))
            owner_face.append(f)
    if not tris:
        return (np.zeros((0, 3, 3)), np.zeros((0,), dtype=np.int64))
    return np.asarray(tris), np.asarray(owner_face, dtype=np.int64)


def nearest_wall_distance(cc, points, topo, mask, k=12, chunk=8192):
    """Exact nearest distance from each cell centre to the triangulated
    wall surface. KD-tree over triangle centroids picks k candidate
    triangles per cell; exact point-triangle distance decides."""
    from scipy.spatial import cKDTree

    cc = np.asarray(cc)
    tris, _ = _wall_triangles(points, topo, mask)
    if tris.shape[0] == 0:
        return np.full((cc.shape[0],), 1e10)
    cen = tris.mean(axis=1)
    tree = cKDTree(cen)
    k = min(k, tris.shape[0])
    out = np.empty((cc.shape[0],))
    for s in range(0, cc.shape[0], chunk):
        blk = cc[s:s + chunk]                        # (m, 3)
        _, idx = tree.query(blk, k=k)                # (m, k)
        idx = np.atleast_2d(idx.reshape(blk.shape[0], -1))
        cand = tris[idx]                             # (m, k, 3, 3)
        p = np.broadcast_to(blk[:, None, :], cand[..., 0, :].shape)
        d = _point_triangle_distance(p, cand[..., 0, :], cand[..., 1, :],
                                     cand[..., 2, :])
        out[s:s + chunk] = d.min(axis=1)
    return out


def compute_wall_distance(cc, points, topo, kinds=("wall",), names=()):
    """Frozen wall-distance field (nc,) as numpy, from host cell centres
    ``cc`` (nc, 3) and mesh ``points`` (exact surface distance)."""
    mask = wall_face_mask(topo, kinds, names)
    return nearest_wall_distance(np.asarray(cc), np.asarray(points), topo,
                                 mask)
