"""Geometric (Galerkin) multigrid on the dense-DIA grid form.

Port of ``dafoam_tpu.linalg.mg``: on meshes whose
dense-DIA layout is logically a 2-D structured grid (band offsets (1, L),
or the periodic O-mesh triple (1, L-1, L)) the operator is re-expressed as
five (nr, L) coefficient planes and coarsened 2x2 by piecewise-constant
Galerkin aggregation. The smoother is alternating-direction exact line
solves (batched PCR, ``linalg/tridiag.py``). Everything is LINEAR in the
right-hand side with matrix-only coefficients, so a V-cycle is a smooth
approximate inverse for the fixed-point adjoint's step map
(``fvsolve.solve_fixed``, smoother "mg") and a Krylov preconditioner
(``fvsolve.solve``, ``pc="mg"``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dafoam_tpu_torch.linalg.tridiag import pcr_solve, pcr_solve_periodic


class GridOp(NamedTuple):
    """Scalar 5-point operator on an (nr, L) logical grid.

    D[r,i]   diagonal of row (r,i)
    Wup[r,i] coef of x[r, (i+1) mod L] in row (r,i)  (wrap +)
    Wdn[r,i] coef of x[r, (i-1) mod L] in row (r,i)  (wrap -)
    Rup[r,i] coef of x[r+1, i] in row (r,i)          (radial +)
    Rdn[r,i] coef of x[r-1, i] in row (r,i)          (radial -)
    periodic: wrap direction is a closed ring (O-mesh).
    """
    D: torch.Tensor
    Wup: torch.Tensor
    Wdn: torch.Tensor
    Rup: torch.Tensor
    Rdn: torch.Tensor
    periodic: bool


def grid_structure(topo):
    """Detect the logical (nr, L) grid of the dense-DIA layout.

    Returns (L, nr, periodic, band_wrap, band_seam, band_radial) or None.
    Accepts offset sets (1, L) and (1, L-1, L) (periodic wrap ring of
    length L, seam band L-1).
    """
    dd = topo.dia_dense()
    if dd is None:
        return None
    offs = tuple(int(o) for o in dd[0])
    nc = topo.n_cells
    if len(offs) == 2 and offs[0] == 1:
        L = offs[1]
        if L > 1 and nc % L == 0:
            return L, nc // L, False, 0, None, 1
    if len(offs) == 3 and offs[0] == 1 and offs[1] + 1 == offs[2]:
        L = offs[2]
        if L > 2 and nc % L == 0:
            valid = np.asarray(dd[1])
            idx = np.nonzero(valid[1] > 0)[0]
            if idx.size and np.all(idx % L == 0):
                return L, nc // L, True, 0, 1, 2
    return None


def _set_col(x, i, v):
    """x with column i replaced by v (out of place)."""
    return torch.cat([x[:, :i], v[:, None], x[:, i + 1:]], dim=1)


def grid_form(m, topo):
    """Re-express an FvMatrix on the dense-DIA layout as a GridOp (face
    k*nc + c connects cell c -> c + offs[k]; m.upper[k*nc+c] is the coef of
    x[c+s] in row c, m.lower[k*nc+c] the coef of x[c] in row c+s). None
    when the layout is not a recognized 2-D grid."""
    gs = grid_structure(topo)
    if gs is None:
        return None
    L, nr, periodic, kw, ks, krad = gs
    nc = topo.n_cells
    up = m.upper.reshape(-1, nc)
    lo = m.lower.reshape(-1, nc)
    D = m.diag.reshape(nr, L)
    Wup = up[kw].reshape(nr, L)
    Wdn = torch.roll(lo[kw].reshape(nr, L), 1, dims=1)
    if periodic:
        ups = up[ks].reshape(nr, L)[:, 0]   # row (r,0) -> (r,L-1)
        los = lo[ks].reshape(nr, L)[:, 0]   # row (r,L-1) -> (r,0)
        Wup = _set_col(Wup, L - 1, los)
        Wdn = _set_col(Wdn, 0, ups)
    else:
        Wup = _set_col(Wup, L - 1, torch.zeros_like(Wup[:, 0]))
        Wdn = _set_col(Wdn, 0, torch.zeros_like(Wdn[:, 0]))
    upr = up[krad].reshape(nr, L)
    lor = lo[krad].reshape(nr, L)
    Rup = torch.cat([upr[:-1], torch.zeros_like(upr[:1])])
    Rdn = torch.cat([torch.zeros_like(lor[:1]), lor[:-1]])
    return GridOp(D, Wup, Wdn, Rup, Rdn, periodic)


def _shift0(x, o):
    """out[r] = x[r - o] with zero fill (axis 0), o = +-1."""
    if o == 1:
        return torch.cat([torch.zeros_like(x[:1]), x[:-1]], dim=0)
    return torch.cat([x[1:], torch.zeros_like(x[:1])], dim=0)


def _shift1(x, o):
    """out[:, i] = x[:, i - o] with zero fill (axis 1), o = +-1."""
    if o == 1:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def grid_matvec(op: GridOp, x):
    """A @ x on the (nr, L) grid: rolls, shifts and multiply-adds."""
    y = op.D * x
    if op.periodic:
        y = y + op.Wup * torch.roll(x, -1, dims=1) \
              + op.Wdn * torch.roll(x, 1, dims=1)
    else:
        y = y + op.Wup * _shift1(x, -1) + op.Wdn * _shift1(x, 1)
    y = y + op.Rup * _shift0(x, -1) + op.Rdn * _shift0(x, 1)
    return y


def coarsen(op: GridOp) -> GridOp:
    """Galerkin PWC 2x2 aggregation A_c = P^T A P (P piecewise-constant
    prolongation); a 5-point stencil stays 5-point."""
    nr, L = op.D.shape

    def q(x):          # (nr, L) -> (nr/2, 2, L/2, 2)
        return x.reshape(nr // 2, 2, L // 2, 2)

    # diagonal: all four diags + intra-aggregate couplings
    D = q(op.D).sum((1, 3)) \
        + q(op.Wup)[:, :, :, 0].sum(1) + q(op.Wdn)[:, :, :, 1].sum(1) \
        + q(op.Rup)[:, 0].sum(2) + q(op.Rdn)[:, 1].sum(2)
    # wrap couplings cross at fine i = 2I+1 (to I+1) / i = 2I (to I-1)
    Wup = q(op.Wup)[:, :, :, 1].sum(1)
    Wdn = q(op.Wdn)[:, :, :, 0].sum(1)
    # radial couplings cross at fine r = 2R+1 (to R+1) / r = 2R (to R-1)
    Rup = q(op.Rup)[:, 1].sum(2)
    Rdn = q(op.Rdn)[:, 0].sum(2)
    return GridOp(D, Wup, Wdn, Rup, Rdn, op.periodic)


def restrict(r):
    nr, L = r.shape
    return r.reshape(nr // 2, 2, L // 2, 2).sum((1, 3))


def prolong(e, shape):
    nr, L = shape
    return e[:, None, :, None].expand(nr // 2, 2, L // 2, 2).reshape(nr, L)


def _line_solve_radial(op: GridOp, r):
    """Exact solve of (Rdn, D, Rup) tridiagonal along axis 0."""
    return pcr_solve(op.Rdn, op.D, op.Rup, r)


def _line_solve_wrap(op: GridOp, r):
    """Exact solve of the wrap-direction restriction along axis 1
    (periodic for O-meshes)."""
    a, b, c, d = op.Wdn.t(), op.D.t(), op.Wup.t(), r.t()
    z = pcr_solve_periodic(a, b, c, d) if op.periodic else \
        pcr_solve(a, b, c, d)
    return z.t()


def smooth(op: GridOp, x, b, sweeps=1):
    """Alternating-direction line smoother: exact radial solve on the
    defect, then exact wrap solve on the updated defect."""
    for _ in range(sweeps):
        x = x + _line_solve_radial(op, b - grid_matvec(op, x))
        x = x + _line_solve_wrap(op, b - grid_matvec(op, x))
    return x


class Hierarchy(NamedTuple):
    levels: tuple      # GridOp per level, fine -> coarse
    shape: tuple       # (nr, L) of the fine level


def build_hierarchy(m, topo, min_cells: int = 64, max_levels: int = 12):
    """Galerkin hierarchy from the fine-grid FvMatrix, or None when the
    mesh has no recognizable grid form."""
    op = grid_form(m, topo)
    if op is None:
        return None
    levels = [op]
    while len(levels) < max_levels:
        nr, L = levels[-1].D.shape
        if nr % 2 or L % 2 or nr < 4 or L < 4 or nr * L <= min_cells:
            break
        levels.append(coarsen(levels[-1]))
    return Hierarchy(tuple(levels), tuple(op.D.shape))


def vcycle(h: Hierarchy, r, pre=1, post=1, coarse_sweeps=4, omega=1.0):
    """One V-cycle approximating A^{-1} r (zero initial guess). r, return:
    flat (nc,). Linear in r; coefficients depend on the matrix only.

    omega: coarse-grid-correction over-relaxation (piecewise-constant
    aggregation underestimates the correction for 2nd-order operators).
    """
    nr, L = h.shape
    x = _vcycle_rec(h.levels, 0, r.reshape(nr, L), pre, post, coarse_sweeps,
                    omega)
    return x.reshape(-1)


def _vcycle_rec(levels, k, b, pre, post, coarse_sweeps, omega):
    op = levels[k]
    z = torch.zeros_like(b)
    if k == len(levels) - 1:
        return smooth(op, z, b, sweeps=coarse_sweeps)
    z = smooth(op, z, b, sweeps=pre)
    rc = restrict(b - grid_matvec(op, z))
    ec = _vcycle_rec(levels, k + 1, rc, pre, post, coarse_sweeps, omega)
    z = z + omega * prolong(ec, op.D.shape)
    return smooth(op, z, b, sweeps=post)


def mg_solver(m, topo, pre=1, post=1, min_cells: int = 64, omega=1.0):
    """Approximate inverse r -> z ~= M^-1 r by one V-cycle, or None when the
    mesh has no grid form. Like the ADI sweep, the V-cycle is NONSYMMETRIC
    (line smoothers do not commute with A): pair it with BiCGStab/FGMRES,
    not CG."""
    h = build_hierarchy(m, topo, min_cells=min_cells)
    if h is None:
        return None
    return lambda r: vcycle(h, r, pre=pre, post=post, omega=omega)


def transpose_grid(op: GridOp) -> GridOp:
    """GridOp of A^T: the coupled coefficient planes swap and shift."""
    Wup = torch.roll(op.Wdn, -1, dims=1) if op.periodic else \
        _shift1(op.Wdn, -1)
    Wdn = torch.roll(op.Wup, 1, dims=1) if op.periodic else \
        _shift1(op.Wup, 1)
    return GridOp(op.D, Wup, Wdn, _shift0(op.Rdn, -1), _shift0(op.Rup, 1),
                  op.periodic)
