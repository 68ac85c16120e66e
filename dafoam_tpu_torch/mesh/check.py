"""Mesh-quality gate (reference DACheckMesh, src/adjoint/DACheckMesh/).

Port of ``dafoam_tpu.mesh.check``: aspect ratio, non-orthogonality,
skewness and face orientation against ``checkMeshThreshold`` (reference
DACheckMesh.H:61-70, pyDAFoam.py:611-616). Called before each MPhys primal
so the optimizer can backtrack on a tangled mesh (mphys_dafoam.py:325-330
raises AnalysisError).

On the dense-DIA face layout the zero-area padded faces (cell pairs that
the mesh does not connect) are left out: they are no faces of the mesh,
and their zero normal would count as incorrectly oriented. On the
canonical layout every internal face counts, as in ``dafoam_tpu``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class MeshQuality(NamedTuple):
    max_aspect_ratio: torch.Tensor
    max_non_orth_deg: torch.Tensor
    max_skewness: torch.Tensor
    n_incorrect_oriented: torch.Tensor


def _dot(a, b):
    return (a * b).sum(dim=-1)


def mesh_quality(geom, topo) -> MeshQuality:
    ni = topo.n_internal
    dev = geom.vol.device
    faces = np.arange(ni)
    dense = topo.dia_dense()
    if dense is not None:
        faces = faces[np.asarray(dense[1]).reshape(-1) > 0]
    fidx = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    own = torch.as_tensor(topo.owner[faces].astype(np.int64), device=dev)
    nei = torch.as_tensor(topo.neighbour[faces].astype(np.int64), device=dev)

    cc = geom.cc
    d = cc[nei] - cc[own]
    magd = torch.linalg.norm(d, dim=-1)
    sf, cf = geom.sf[fidx], geom.cf[fidx]
    nhat = sf / torch.clamp(geom.magsf[fidx], min=1e-36)[:, None]

    # non-orthogonality: angle between face normal and cell-centre vector
    cosang = _dot(nhat, d) / torch.clamp(magd, min=1e-36)
    non_orth = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))

    # skewness (OpenFOAM definition): |Cf - intersection| / |d|
    t = _dot(cf - cc[own], nhat) / torch.clamp(_dot(d, nhat), min=1e-36)
    xi = cc[own] + t[:, None] * d
    skew = torch.linalg.norm(cf - xi, dim=-1) / torch.clamp(magd, min=1e-36)

    # orientation: owner->neighbour must align with Sf
    n_bad = torch.sum(cosang <= 0.0)

    # aspect ratio (approx): per-cell max/min of the face deltas
    length = 1.0 / geom.delta_coeffs[fidx]
    nc = topo.n_cells
    big = length.new_zeros((nc,)).scatter_reduce(
        0, own, length, "amax").scatter_reduce(0, nei, length, "amax")
    small = length.new_full((nc,), math.inf).scatter_reduce(
        0, own, length, "amin").scatter_reduce(0, nei, length, "amin")
    ok = torch.isfinite(small) & (small > 0)
    ar = torch.where(ok, big / torch.where(ok, small, 1.0), 1.0)

    zero = length.new_zeros(())
    return MeshQuality(
        max_aspect_ratio=torch.max(ar),
        max_non_orth_deg=torch.max(non_orth) if len(faces) else zero,
        max_skewness=torch.max(skew) if len(faces) else zero,
        n_incorrect_oriented=n_bad,
    )


def check_mesh(geom, topo, thresholds: dict) -> tuple[bool, dict]:
    with torch.no_grad():
        q = mesh_quality(geom, topo)
    rep = {
        "maxAspectRatio": float(q.max_aspect_ratio),
        "maxNonOrth": float(q.max_non_orth_deg),
        "maxSkewness": float(q.max_skewness),
        "incorrectlyOrientedFaces": int(q.n_incorrect_oriented),
    }
    ok = (rep["maxAspectRatio"] <= thresholds["maxAspectRatio"]
          and rep["maxNonOrth"] <= thresholds["maxNonOrth"]
          and rep["maxSkewness"] <= thresholds["maxSkewness"]
          and rep["incorrectlyOrientedFaces"]
          <= thresholds["maxIncorrectlyOrientedFaces"])
    return ok, rep
