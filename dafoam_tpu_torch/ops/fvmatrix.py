"""FvMatrix: the LDU sparse matrix of one implicit FV equation, in torch.

Port of ``dafoam_tpu.ops.fvmatrix`` (OpenFOAM ``fvMatrix``/``lduMatrix``).
Storage is face-based:

    diag   (nc,) or (nc,3)   diagonal (boundary internalCoeffs folded in)
    lower  (ni,)             coeff of OWNER in NEIGHBOUR's row
    upper  (ni,)             coeff of NEIGHBOUR in OWNER's row
    source (nc,) or (nc,3)   RHS b (boundaryCoeffs folded in)

Conventions match OpenFOAM exactly so the SIMPLE machinery (A(), H(),
relax(), flux()) carries over:
  -  M @ psi is the volume-INTEGRATED operator;
  -  ``residual`` = (M@psi - b)/V;
  -  A() = cmptAv(diag)/V;  H(psi) = (b - offdiag@psi - (diag-cmptAv)psi)/V
     so that A*psi - H == residual identically.

Inside Krylov loops the matrix is applied through ``matvec_fn``, which
gathers the band coefficients once and then runs the banded (DIA) matvec
kernels of ``ops/dia_kernels.py``. When the topology was opted into the
halo route (``parallel.shard.shard_solver``), ``matvec``, ``matvec_fn``
and ``matvec_t_fn`` send every product through its ``HaloMatvec``
instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dafoam_tpu_torch.ops import dia_kernels
from dafoam_tpu_torch.ops.core import (_shift_bwd, abs_ad, cell_to_face_nei,
                                       cell_to_face_own, face_sum_pair,
                                       index_tensor)
from dafoam_tpu_torch.parallel.halo import active as active_halo


class FvMatrix(NamedTuple):
    diag: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    source: torch.Tensor

    def __add__(self, other):
        if isinstance(other, FvMatrix):
            return FvMatrix(_bc_add(self.diag, other.diag),
                            self.lower + other.lower,
                            self.upper + other.upper,
                            _bc_add(self.source, other.source))
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, FvMatrix):
            return FvMatrix(_bc_add(self.diag, -other.diag),
                            self.lower - other.lower,
                            self.upper - other.upper,
                            _bc_add(self.source, -other.source))
        return NotImplemented

    def __neg__(self):
        return FvMatrix(-self.diag, -self.lower, -self.upper, -self.source)

    def add_source(self, field_times_vol: torch.Tensor) -> "FvMatrix":
        """Add an explicit source term S (per-volume) * V to the RHS."""
        return self._replace(source=_bc_add(self.source, field_times_vol))


def _bc_add(a, b):
    """Add with rank broadcasting: (nc,) + (nc,3) -> (nc,3)."""
    if a.ndim == b.ndim:
        return a + b
    if a.ndim < b.ndim:
        return a[..., None] + b
    return a + b[..., None]


def _match_rank(a, like):
    return a if a.ndim == like.ndim else a[..., None]


def _face_term(coef, psi_vals):
    """coef (ni,) times psi values (ni,) or (ni,3)."""
    return coef[:, None] * psi_vals if psi_vals.ndim == 2 \
        else coef * psi_vals


def offdiag_matvec(m: FvMatrix, psi: torch.Tensor, topo) -> torch.Tensor:
    """Off-diagonal LDU product, composed of the face gathers and sums."""
    pn = cell_to_face_nei(psi, topo)
    po = cell_to_face_own(psi, topo)
    return face_sum_pair(_face_term(m.upper, pn), _face_term(m.lower, po),
                         topo)


def matvec(m: FvMatrix, psi: torch.Tensor, topo) -> torch.Tensor:
    """Volume-integrated A @ psi."""
    hm = active_halo(topo)
    if hm is not None:
        return hm(m.diag, m.lower, m.upper, psi)
    return _match_rank(m.diag, psi) * psi + offdiag_matvec(m, psi, topo)


def banded(topo) -> bool:
    """True when products on ``topo`` run as DIA kernels: the mesh is
    banded and no halo route is active (that route is cell-major)."""
    return topo.dia() is not None and active_halo(topo) is None


def _halo_closure(m: FvMatrix, topo, component_major):
    hm = active_halo(topo)
    if hm is None:
        return None
    if component_major:
        raise ValueError("the halo route runs vector fields cell-major")
    return lambda x: hm(m.diag, m.lower, m.upper, x)


def dia_bands(m: FvMatrix, topo):
    """Band form of ``m`` on the banded mesh: (offsets tuple, coef (K, nc)).

    Row ``i`` of the matrix is ``diag[i] x[i] + sum_k coef[k, i] x[i +
    offsets[k]]``. On the dense layout the gather is a reshape plus shifts
    of the lower rows; on the canonical layout it goes through the
    ``topo.dia()`` face index. Returns None when the mesh is not banded.
    """
    dia = topo.dia()
    if dia is None:
        return None
    offsets, face_idx, kind = dia
    nc = topo.n_cells
    offs_t = tuple(int(o) for o in offsets.tolist())
    dd = topo.dia_dense()
    if dd is not None:
        offs_d, _ = dd
        up_k = m.upper.reshape(len(offs_d), nc)
        lo_k = m.lower.reshape(len(offs_d), nc)
        pos = {int(o): i for i, o in enumerate(offs_d)}
        rows = [up_k[pos[o]] if o > 0 else _shift_bwd(lo_k[pos[-o]], -o)
                for o in offs_t]
        return offs_t, torch.stack(rows)
    dev = m.upper.device
    fidx = index_tensor(topo, "dia_face", dev, lambda: face_idx)
    kindt = index_tensor(topo, "dia_kind", dev, lambda: kind)
    coef = torch.where(kindt == 1, m.upper[fidx],
                       torch.where(kindt == 2, m.lower[fidx], 0.0))
    return offs_t, coef


def matvec_fn(m: FvMatrix, topo, component_major: bool = False):
    """Return a matvec closure with the band coefficients precomputed.

    On the banded mesh (``topo.dia()``) each application is the DIA
    matvec through the autograd Functions of ``ops/dia_kernels.py``:
    ``DiaMatvec`` (K1) for scalar equations, ``DiaMatvecMulti`` (K2) for
    component-major (C, n) operands of vector equations. Their reverse
    rule is K3 and their jvp two K1/K2 calls, so the closure is
    differentiable in the matrix and the operand in both AD modes (the
    JAX package's ``no_pallas`` switch for forward mode has no
    counterpart here). On a CUDA device they launch the hand-written
    kernels, on the CPU their plain torch versions.

    component_major=True returns a closure over (C, n) operands with the
    SHARED band coefficients; the diagonal may be shared (nc,) or per
    component (nc, C). Callers (fvsolve) transpose once at solve entry and
    exit. Falls back to the face-based ``matvec`` when the mesh is not
    banded (cell-major only). Under the halo route every application is
    one ``HaloMatvec`` product (cell-major only).
    """
    halo = _halo_closure(m, topo, component_major)
    if halo is not None:
        return halo
    bands = dia_bands(m, topo)
    if bands is None:
        if component_major:
            raise ValueError("component-major matvec needs a banded mesh")
        return lambda x: matvec(m, x, topo)
    offsets, coef = bands
    coef = coef.contiguous()
    d0 = m.diag

    if component_major:
        # (C, n) diagonal, or (n,) shared by every component
        dT = d0.t().contiguous() if d0.ndim == 2 else d0.contiguous()

        def mv_t(x):  # x (C, n)
            return dia_kernels.DiaMatvecMulti.apply(dT, coef, x.contiguous(),
                                                    offsets)

        return mv_t

    if d0.ndim != 1:
        raise ValueError("cell-major banded matvec needs a scalar diagonal; "
                         "vector equations run component-major")
    d0 = d0.contiguous()

    def mv(x):
        return dia_kernels.DiaMatvec.apply(d0, coef, x.contiguous(), offsets)

    return mv


def matvec_t_fn(m: FvMatrix, topo, component_major: bool = False):
    """Return a closure x -> M^T x (volume-integrated) with the band
    coefficients precomputed.

    On the banded mesh each application is one K3a launch
    (``dia_matvec_t``, or ``dia_matvec_multi_t`` over component-major
    (C, n) operands) that reads M's OWN bands at the shifted rows, so no
    transposed band array is built. The closure is not differentiable: it
    serves the adjoint's preconditioners and the transpose solves of the
    implicit ``fvsolve.solve`` rule, whose matrices are frozen. Falls back
    to the face-based product of the LDU transpose when the mesh is not
    banded (cell-major only). Under the halo route it is the
    ``HaloMatvec`` product of the transpose: lower and upper swapped.
    """
    mt = FvMatrix(m.diag.detach(), m.upper.detach(), m.lower.detach(),
                  m.source)
    halo = _halo_closure(mt, topo, component_major)
    if halo is not None:
        return halo
    bands = dia_bands(m, topo)
    if bands is None:
        if component_major:
            raise ValueError("component-major matvec needs a banded mesh")
        return lambda x: matvec(mt, x, topo)
    offsets, coef = bands
    coef = coef.detach().contiguous()
    d0 = m.diag.detach()
    if component_major:
        dT = d0.t().contiguous() if d0.ndim == 2 else d0.contiguous()
        return lambda x: dia_kernels.dia_matvec_multi_t(dT, coef, offsets, x)
    if d0.ndim != 1:
        raise ValueError("cell-major banded matvec needs a scalar diagonal; "
                         "vector equations run component-major")
    d0 = d0.contiguous()
    return lambda x: dia_kernels.dia_matvec_t(d0, coef, offsets, x)


def residual(m: FvMatrix, psi: torch.Tensor, geom, topo) -> torch.Tensor:
    """(A psi - b)/V — OpenFOAM ``M & psi`` semantics."""
    r = matvec(m, psi, topo) - _match_rank(m.source, psi)
    v = geom.vol if psi.ndim == 1 else geom.vol[:, None]
    return r / v


def cmpt_av(diag: torch.Tensor) -> torch.Tensor:
    return diag if diag.ndim == 1 else diag.mean(dim=-1)


def A(m: FvMatrix, geom) -> torch.Tensor:
    """Central coefficient / volume (volScalarField), OpenFOAM fvMatrix::A."""
    return cmpt_av(m.diag) / geom.vol


def H(m: FvMatrix, psi: torch.Tensor, geom, topo) -> torch.Tensor:
    """OpenFOAM fvMatrix::H — defined here such that A*psi - H == residual."""
    av = cmpt_av(m.diag)
    d = _match_rank(m.diag, psi)
    avx = av if psi.ndim == 1 else av[:, None]
    num = _match_rank(m.source, psi) - offdiag_matvec(m, psi, topo) \
        - (d - avx) * psi
    v = geom.vol if psi.ndim == 1 else geom.vol[:, None]
    return num / v


def H1(m: FvMatrix, geom, topo) -> torch.Tensor:
    """OpenFOAM fvMatrix::H1 — negated off-diagonal row sums / volume."""
    return face_sum_pair(-m.upper, -m.lower, topo) / geom.vol


def relax(m: FvMatrix, psi: torch.Tensor, alpha: float, topo) -> FvMatrix:
    """Under-relax the matrix (OpenFOAM fvMatrix::relax): enforce diagonal
    dominance, divide diag by alpha, and compensate the source with
    (Dnew - Dold)*psi_current so the converged solution is unchanged."""
    if alpha >= 1.0 - 1e-12:
        return m
    sum_off = face_sum_pair(abs_ad(m.upper), abs_ad(m.lower), topo)
    d0 = m.diag
    so = sum_off[:, None] if d0.ndim == 2 else sum_off
    dmag = torch.maximum(abs_ad(d0), so)
    dnew = torch.where(d0 >= 0, dmag, -dmag) / alpha
    src = m.source + (dnew - d0) * psi
    return m._replace(diag=dnew, source=src)


def set_reference(m: FvMatrix, cell: int, value: float) -> FvMatrix:
    """Pin a reference value (OpenFOAM fvMatrix::setReference)."""
    d = m.diag[cell]
    src = m.source.clone()
    diag = m.diag.clone()
    src[cell] += d * value
    diag[cell] += d
    return m._replace(diag=diag, source=src)

