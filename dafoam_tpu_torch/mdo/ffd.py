"""Free-form deformation (FFD) geometry parametrization.

Port of ``dafoam_tpu.mdo.ffd``. Plays the role of pyGeo's DVGeometry (the
reference composes with it at the Python level: mphys_dafoam.py:321,
pyDAFoam.py:1376-1415): a Bernstein tensor-product control lattice embeds
points; moving control points moves them smoothly. The embedding matrix
is built on the host in float64 numpy, exactly as ``dafoam_tpu`` builds
it, then moved to the caller's device and dtype; ``displace`` is one
matmul, so dXs/dDV^T products (DVGeo.totalSensitivity) come from autograd.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch


def _bernstein_matrix(u: np.ndarray, n: int) -> np.ndarray:
    """(npts, n) Bernstein basis values at parameters u in [0,1]."""
    u = np.clip(u, 0.0, 1.0)[:, None]
    i = np.arange(n)[None, :]
    c = np.array([comb(n - 1, k) for k in range(n)])[None, :]
    return c * u ** i * (1.0 - u) ** (n - 1 - i)


class FFDBox:
    """Axis-aligned Bernstein FFD box around a set of embedded points.

    nx, ny, nz: control points per axis. DVs are control-point
    displacements (or user-defined reductions of them, e.g. shape modes).
    """

    def __init__(self, points, nx=6, ny=4, nz=2, margin=0.05, bounds=None,
                 *, device="cuda", dtype=torch.float32):
        pts = np.asarray(points)
        if bounds is None:
            lo = pts.min(axis=0)
            hi = pts.max(axis=0)
            pad = (hi - lo) * margin + 1e-12
            lo, hi = lo - pad, hi + pad
        else:
            lo, hi = map(np.asarray, bounds)
        self.lo, self.hi = lo, hi
        self.shape = (nx, ny, nz)

        uvw = (pts - lo) / (hi - lo)
        self.inside = np.all((uvw >= -1e-9) & (uvw <= 1 + 1e-9), axis=1)
        Bu = _bernstein_matrix(uvw[:, 0], nx)
        Bv = _bernstein_matrix(uvw[:, 1], ny)
        Bw = _bernstein_matrix(uvw[:, 2], nz)
        # embedding operator: (npts, nx*ny*nz), rows of outside points
        # zeroed so they don't move
        B = np.einsum("pi,pj,pk->pijk", Bu, Bv, Bw).reshape(pts.shape[0], -1)
        B[~self.inside] = 0.0
        self._B = torch.as_tensor(B, dtype=dtype, device=device)
        # lattice rest positions (kept for writing/debugging)
        gx = np.linspace(lo[0], hi[0], nx)
        gy = np.linspace(lo[1], hi[1], ny)
        gz = np.linspace(lo[2], hi[2], nz)
        self.lattice0 = np.stack(np.meshgrid(gx, gy, gz, indexing="ij"),
                                 axis=-1)  # (nx,ny,nz,3)

    @property
    def n_controls(self) -> int:
        return int(np.prod(self.shape)) * 3

    def displace(self, dcp: torch.Tensor) -> torch.Tensor:
        """Control-point displacements (nx,ny,nz,3) or flat -> point
        displacements (npts, 3)."""
        return self._B @ dcp.reshape(-1, 3)

    def __call__(self, points0: torch.Tensor, dcp: torch.Tensor):
        return points0 + self.displace(dcp)
