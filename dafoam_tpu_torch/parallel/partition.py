"""Mesh partitioning for the halo-exchange route.

Port of ``dafoam_tpu.parallel.partition``: recursive coordinate bisection
(RCB) on the cell centres into equal parts, and the relabelling that
gives part p the contiguous cell block p. Host set-up, like the rest of
``mesh/``: numpy, with the cell centres from the port's
``compute_geometry`` in float64 on the CPU. The stable argsorts decide
ties, so the parts and the permutation are exactly dafoam_tpu's.
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.mesh.topology import MeshTopology, apply_cell_permutation


def partition_cells(cc: np.ndarray, n_parts: int) -> np.ndarray:
    """Recursive coordinate bisection on cell centres -> part id per cell.

    Each bisection splits the longer extent of its cells at the size
    ratio of the two halves' part counts, so the parts are of equal size
    (within one cell when ``n_parts`` does not divide the cell count)."""
    nc = cc.shape[0]
    part = np.zeros(nc, dtype=np.int32)

    def rec(idx, pid0, np_):
        if np_ == 1:
            part[idx] = pid0
            return
        ext = cc[idx].max(axis=0) - cc[idx].min(axis=0)
        ax = int(np.argmax(ext))
        order = idx[np.argsort(cc[idx, ax], kind="stable")]
        nleft = (len(order) * (np_ // 2)) // np_
        rec(order[:nleft], pid0, np_ // 2)
        rec(order[nleft:], pid0 + np_ // 2, np_ - np_ // 2)

    rec(np.arange(nc), 0, n_parts)
    return part


def cell_centres(topo: MeshTopology, points: np.ndarray) -> np.ndarray:
    """(nc, 3) float64 cell centres of the port's geometry, on the CPU."""
    from dafoam_tpu_torch.mesh.geometry import compute_geometry
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float64)
    return compute_geometry(pts, topo).cc.numpy()


def reorder_for_partitions(topo: MeshTopology, points: np.ndarray,
                           n_parts: int):
    """Relabel cells so partition p owns the contiguous index block p.

    Returns (new_topo, perm) with perm[new] = old. The internal faces of
    new_topo are canonical again (owner-sorted, upper-triangular), which
    the halo plan needs. Pad n_cells to a multiple of n_parts upstream if
    needed.
    """
    part = partition_cells(cell_centres(topo, points), n_parts)
    perm = np.argsort(part, kind="stable").astype(np.int64)  # perm[new]=old
    return apply_cell_permutation(topo, perm), perm


def cut_statistics(topo: MeshTopology, part: np.ndarray) -> dict:
    """Internal faces whose two cells lie in different parts."""
    own = topo.owner[: topo.n_internal]
    nei = topo.neighbour
    cut = int((part[own] != part[nei]).sum())
    return {"n_cut_faces": cut, "cut_fraction": cut / max(topo.n_internal, 1)}
