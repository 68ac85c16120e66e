"""Volume mesh warping from surface displacements (IDWarp equivalent).

Port of ``dafoam_tpu.mdo.warp``. The reference uses the external IDWarp
(USMesh) for this (mphys_dafoam.py:76, DAFoamWarper :804). Here: inverse-
distance weighting from moving-surface points to volume points over the K
nearest surface points per volume point: one gather and one weighted sum
on the device at warp time, exactly differentiable.

The neighbour table is built on the host in float64 numpy with the same
expressions as ``dafoam_tpu`` (squared distances, ``np.argsort`` of each
row), but in blocks of rows spread over a few threads (numpy's sort
releases the GIL) instead of one (n_points, n_surf) matrix: rows are
independent, so every row gets exactly the neighbours the reference picks,
ties included, at a memory cost of one block per thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROWS_PER_BLOCK = 1024


def _block(pts, surf, fixed_pts, k, lo, hi):
    """nn, nearest-surface distance and nearest-fixed distance of rows
    [lo, hi)."""
    p = pts[lo:hi]
    d2 = ((p[:, None, :] - surf[None, :, :]) ** 2).sum(-1)
    nn = np.argsort(d2, axis=1)[:, :k]
    nd2 = np.take_along_axis(d2, nn, axis=1)
    dist_surf = np.sqrt(d2.min(axis=1))
    del d2
    dist_fix = None
    if fixed_pts is not None:
        dfix2 = ((p[:, None, :] - fixed_pts[None, :, :]) ** 2).sum(-1)
        dist_fix = np.sqrt(dfix2.min(axis=1)) + 1e-12
    return nn, nd2, dist_surf, dist_fix


class IDWarp:
    """points0: (np,3) rest volume points; surf_ids: indices of the moving
    surface points; fixed_ids: indices that must not move (outer
    boundaries). Volume points follow IDW of surface displacements with a
    decay that clamps to zero at the fixed set."""

    def __init__(self, points0, surf_ids, fixed_ids=None, k: int = 20,
                 power: float = 3.0, *, device="cuda", dtype=torch.float32):
        pts = np.asarray(points0, dtype=np.float64)
        surf_ids = np.asarray(surf_ids)
        self.surf_ids = surf_ids
        npts = pts.shape[0]
        surf = pts[surf_ids]
        k = min(k, surf.shape[0])
        fixed_pts = pts[fixed_ids] if fixed_ids is not None \
            and len(fixed_ids) else None

        # K nearest surface points per volume point, block by block
        bounds = [(lo, min(lo + ROWS_PER_BLOCK, npts))
                  for lo in range(0, npts, ROWS_PER_BLOCK)]
        n_thr = max(1, min(os.cpu_count() or 1, 8, len(bounds)))
        with ThreadPoolExecutor(n_thr) as ex:
            parts = list(ex.map(
                lambda b: _block(pts, surf, fixed_pts, k, *b), bounds))
        nn = np.concatenate([q[0] for q in parts])
        nd = np.sqrt(np.concatenate([q[1] for q in parts])) + 1e-12
        dist_surf = np.concatenate([q[2] for q in parts])

        w = 1.0 / nd ** power
        w = w / w.sum(axis=1, keepdims=True)

        # blend factor: 1 on the surface, 0 at/beyond the fixed boundary
        if fixed_pts is not None:
            dist_fix = np.concatenate([q[3] for q in parts])
            blend = dist_fix ** 2 / (dist_fix ** 2 + dist_surf ** 2)
        else:
            blend = np.ones(npts)
        blend[surf_ids] = 1.0

        self.nn = nn
        self.w = w * blend[:, None]
        self._nn = torch.as_tensor(nn, dtype=torch.int64, device=device)
        self._w = torch.as_tensor(self.w, dtype=dtype, device=device)
        self._sid = torch.as_tensor(surf_ids.astype(np.int64), device=device)
        self._npts = npts

    def __call__(self, points0: torch.Tensor, surf_disp: torch.Tensor):
        """surf_disp: (n_surf, 3) displacements of the surface points ->
        new volume points (np,3). Surface points get EXACTLY surf_disp."""
        d = torch.einsum("pk,pki->pi", self._w, surf_disp[self._nn])
        d = d.index_put((self._sid,), surf_disp)
        return points0 + d
