"""Line-implicit (ADI) approximate inverses on the dense-DIA banded layout.

Port of ``dafoam_tpu.linalg.lines``: exact tridiagonal solves along every
detected mesh direction (batched PCR, ``linalg/tridiag.py``), combined
ADI-style. The primal's pressure preconditioner (``pPC: "line"``), the
adjoint's line-implicit PC blocks (``adjoint/precond.py``) and the
fixed-point step map's ``"line"`` smoother are built on it.

``line_solver(m, topo)`` returns r -> z ~= M^-1 r for the VOLUME-INTEGRATED
operator M. Right-hand sides are cell-major, (nc,) or (nc, C); the defect
matvecs between directions run through the DIA kernels (K1 for scalar
fields, K2 component-major for vector fields, or K3a when the caller
passes the transposed product). PCR itself is plain torch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from dafoam_tpu_torch.linalg.tridiag import pcr_solve, pcr_solve_periodic


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


def build_line_solves(m, topo):
    """Per-direction tridiagonal restrictions of the (volume-integrated)
    operator M in the dense-DIA layout: a list of entries for
    ``apply_line_solve``, or None without a dense layout.

    Dense-layout convention (``mesh/topology.to_dia_dense``): face k*nc + c
    connects cell c -> c + offs[k]; m.upper[k*nc+c] is the coefficient of
    x[c+s] in row c, m.lower[k*nc+c] the coefficient of x[c] in row c+s.
    """
    dirs = line_directions(topo)
    if not dirs:
        return None
    nc = topo.n_cells
    up_k = m.upper.reshape(-1, nc)
    lo_k = m.lower.reshape(-1, nc)

    solves = []
    for d in dirs:
        s, k = d["stride"], d["band"]
        sup = up_k[k]                              # coef of x[i+s] in row i
        sub = F.pad(lo_k[k], (s, 0))[:nc]          # coef of x[i-s] in row i
        if d["ring"] is not None:
            L, k2 = d["ring"], d["seam_band"]
            nrings = nc // L
            # rings are contiguous runs of length L with stride s == 1;
            # cyclic corners from the seam band: row ring*L carries the
            # coef of x[ring*L + L-1] (= upper[k2] at ring starts), row
            # ring*L + L-1 the coef of x[ring*L] (= lower[k2])
            a = sub.reshape(nrings, L).t()          # (L, nrings)
            c = sup.reshape(nrings, L).t()
            a = torch.cat([up_k[k2].reshape(nrings, L)[:, 0][None], a[1:]])
            c = torch.cat([c[:-1], lo_k[k2].reshape(nrings, L)[:, 0][None]])
            solves.append(("ring", L, nrings, a, c, pcr_solve_periodic))
        else:
            nlines = nc // s
            a = sub.reshape(nlines, s)             # axis 0 = along the line
            c = sup.reshape(nlines, s)
            solves.append(("line", s, nlines, a, c, pcr_solve))
    return solves


def apply_line_solve(entry, diag, r):
    """Solve one direction's tridiagonal restriction (diag + that
    direction's bands) for a cell-major RHS r (nc,) or (nc, C); diag (nc,)
    or (nc, C)."""
    kind, s, n0, a, c, fn = entry
    extra = tuple(r.shape[1:])
    dextra = tuple(diag.shape[1:])
    if kind == "ring":
        L, nrings = s, n0
        b = torch.movedim(diag.reshape((nrings, L) + dextra), 1, 0)
        d_ = torch.movedim(r.reshape((nrings, L) + extra), 1, 0)
        z = fn(a, b, c, d_)
        return torch.movedim(z, 0, 1).reshape(r.shape)
    nlines = n0
    b = diag.reshape((nlines, s) + dextra)
    d_ = r.reshape((nlines, s) + extra)
    return fn(a, b, c, d_).reshape(r.shape)


def cell_major_matvec(m, topo, make):
    """x (nc,) or (nc, C) -> the product of ``make(m, topo,
    component_major=...)`` (``fvmatrix.matvec_fn`` or ``matvec_t_fn``):
    scalar fields through the scalar kernel, vector fields transposed to
    component-major (C, nc) and back, so their (nc, C) diagonal reaches
    K2/K3a as a per-component one."""
    closures = {}

    def mv(x):
        if x.ndim == 1:
            if 1 not in closures:
                closures[1] = make(m, topo)
            return closures[1](x)
        if 2 not in closures:
            closures[2] = make(m, topo, component_major=True)
        return closures[2](x.t().contiguous()).t()

    return mv


def line_solver(m, topo, adi_sweeps: int = 1, matvec=None):
    """Approximate inverse r -> z ~= M^-1 r by ADI line sweeps.

    The first (stiffest-direction) solve is exact on its tridiagonal
    restriction; each further direction solves the UPDATED defect
    r - M z. adi_sweeps > 1 re-cycles all directions. ``matvec`` (cell-
    major, default M's own DIA matvec) computes the defects. Returns None
    when the mesh has no dense-DIA layout (the caller falls back).

    The multi-direction sweep is a NONSYMMETRIC operator even for
    symmetric M: pair it with BiCGStab/FGMRES, not plain CG.
    """
    solves = build_line_solves(m, topo)
    if not solves:
        return None
    diag = m.diag
    if matvec is None:
        from dafoam_tpu_torch.ops.fvmatrix import matvec_fn
        matvec = cell_major_matvec(m, topo, matvec_fn)

    def solve(r):
        z = apply_line_solve(solves[0], diag, r)
        for _ in range(adi_sweeps):
            for entry in (solves[1:] +
                          (solves[:1] if adi_sweeps > 1 else [])):
                rho = r - matvec(z)
                z = z + apply_line_solve(entry, diag, rho)
        return z

    return solve
