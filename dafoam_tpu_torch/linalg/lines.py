"""Line directions of the dense-DIA layout.

Port of ``dafoam_tpu.linalg.lines.line_directions`` only: the fixed-point
step map's smoother fall-through ("mg" -> "line" -> "linear" in
``fvsolve.solve_fixed``) needs to know whether a mesh has line directions.
The ADI line solves themselves (``build_line_solves``, ``line_solver``)
are not ported yet (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np


def line_directions(topo):
    """Detect the mesh's line directions from the dense-DIA layout.

    Returns a list of dicts, one per solvable direction:
      {"stride": s, "band": k, "ring": L or None, "seam_band": k2 or None}
    A direction is a band offset s whose stride-s lines tile the flat index
    (s divides n_cells). If another band s2 couples only ring-start cells
    and s + s2 == L with L | n_cells, the stride-s direction is a PERIODIC
    ring of length L and the seam band joins it as cyclic corners. None
    when there is no dense layout or no direction.
    """
    dd = topo.dia_dense()
    if dd is None:
        return None
    offs, valid = dd
    valid = np.asarray(valid)
    nc = topo.n_cells
    dirs = []
    used_as_seam = set()
    for k, s in enumerate(offs):
        if nc % int(s) != 0:
            continue
        d = {"stride": int(s), "band": k, "ring": None, "seam_band": None}
        for k2, s2 in enumerate(offs):
            L = int(s) + int(s2)
            if k2 == k or L > nc or nc % L != 0 or int(s2) < int(s):
                continue
            idx = np.nonzero(valid[k2] > 0)[0]
            if idx.size and np.all(idx % L == 0):
                d["ring"] = L
                d["seam_band"] = k2
                used_as_seam.add(k2)
                break
        dirs.append(d)
    dirs = [d for d in dirs if d["band"] not in used_as_seam]
    # stiffest (largest-stride, wall-normal) direction first
    dirs.sort(key=lambda d: -d["stride"])
    return dirs or None
