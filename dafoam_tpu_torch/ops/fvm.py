"""Implicit finite-volume operators (OpenFOAM ``fvm::``): FvMatrix assembly.

Port of ``dafoam_tpu.ops.fvm``. Each operator returns an
:class:`~dafoam_tpu_torch.ops.fvmatrix.FvMatrix` whose action
``matvec(M, psi) - M.source`` equals the volume-integrated operator.
Boundary contributions are folded into diag/source at assembly using the BC
coefficient quadruples from ``dafoam_tpu_torch.ops.bc``.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops import fvc
from dafoam_tpu_torch.ops.bc import BCoef, boundary_value
from dafoam_tpu_torch.ops.core import (abs_ad, boundary_gather,
                                       boundary_scatter_add, cell_to_face_nei,
                                       cell_to_face_own, face_sum_pair,
                                       face_sum_signed)
from dafoam_tpu_torch.ops.fvmatrix import FvMatrix
from dafoam_tpu_torch.utils.precision import sq_guard


def _zeros_like_state(psi, topo):
    shape = (topo.n_cells,) if psi.ndim == 1 else (topo.n_cells, 3)
    return psi.new_zeros(shape)


def _rank_r(x, psi):
    """reshape face scalar (n,) for broadcasting against psi-rank values."""
    return x.reshape((-1,) + (1,) * (psi.ndim - 1))


def div(geom, topo, phi_f, psi, bcoef: BCoef, scheme: str = "upwind",
        bounded: bool = False, grad_psi=None) -> FvMatrix:
    """fvm::div(phi, psi): implicit convection.

    scheme: "upwind" | "linear" | "linearUpwind". ``bounded`` subtracts
    Sp(fvc::div(phi), psi) (OpenFOAM 'bounded Gauss' — removes the
    non-conservative part for steady-state runs before continuity is
    converged). "linearUpwind" is implicit upwind plus the explicit
    deferred correction phi * grad_up . (Cf - C_up) (``grad_psi``, or the
    Gauss gradient of psi when absent).
    """
    ni = topo.n_internal
    phi_i = phi_f[:ni]
    phi_b = phi_f[ni:] * bcoef.active

    lu_corr = None
    if scheme in ("upwind", "linearUpwind"):
        w = (phi_i >= 0.0).to(psi.dtype)
        if scheme == "linearUpwind":
            if grad_psi is None:
                grad_psi = fvc.grad(geom, topo, psi,
                                    boundary_value(bcoef, psi, topo))
            pos = phi_i >= 0.0
            cc_up = torch.where(pos[:, None],
                                cell_to_face_own(geom.cc, topo),
                                cell_to_face_nei(geom.cc, topo))
            g_up = torch.where(
                pos.reshape((-1,) + (1,) * (grad_psi.ndim - 1)),
                cell_to_face_own(grad_psi, topo),
                cell_to_face_nei(grad_psi, topo))
            d = geom.cf[:ni] - cc_up                     # (ni,3)
            dpsi = _corr_dot(d, g_up)
            lu_corr = _rank_r(phi_i, psi) * dpsi         # explicit face flux
    elif scheme == "linear":
        w = geom.weights[:ni]
    else:
        raise NotImplementedError(f"div scheme {scheme!r}")

    # owner row: +phi*(w psi_o + (1-w) psi_n) ; neighbour row: -the same
    diag_own = phi_i * w
    upper = phi_i * (1.0 - w)
    lower = -diag_own
    diag_nei = -upper

    diag_s = face_sum_pair(diag_own, diag_nei, topo)
    diag = _zeros_like_state(psi, topo)
    diag = diag + (diag_s if psi.ndim == 1 else diag_s[:, None])
    source = _zeros_like_state(psi, topo)

    # boundary: owner row gets phi_b * (vc psi_o + vb)
    pb = _rank_r(phi_b, psi)
    diag = boundary_scatter_add(diag, pb * bcoef.vc, topo)
    source = boundary_scatter_add(source, -pb * bcoef.vb, topo)

    if lu_corr is not None:
        # deferred correction: contribution += surfaceSum(+own/-nei) of the
        # explicit flux, i.e. source -= that sum
        source = source - face_sum_signed(lu_corr, topo)

    m = FvMatrix(diag=diag, lower=lower, upper=upper, source=source)
    if bounded:
        ones = torch.ones((ni,), dtype=phi_f.dtype, device=phi_f.device)
        divphi = fvc.div_surface(geom, topo,
                                 phi_f * torch.cat([ones, bcoef.active]))
        m = m - Sp(geom, topo, divphi, psi)
    return m


def _limit_correction(corr, orth, limit, psi):
    """OpenFOAM limitedSnGrad limiter: scale the explicit non-orthogonal
    correction so it never exceeds limit/(1-limit) x the orthogonal part."""
    if limit >= 1.0:
        return corr
    if psi.ndim == 2:
        mag_c = torch.sqrt(torch.clamp_min((corr * corr).sum(-1), 1e-36))
        mag_o = torch.sqrt(torch.clamp_min((orth * orth).sum(-1), 1e-36))
    else:
        mag_c = abs_ad(corr)
        mag_o = abs_ad(orth)
    # the floor keeps denom^2 a normal number in either precision (the
    # adjoint's quotient rule divides by it); where mag_c is that tiny,
    # corr ~ 0 and the limiter value is irrelevant
    tiny = sq_guard(mag_c.dtype)
    lam = torch.clamp_max(limit * mag_o / torch.clamp_min(
        (1.0 - limit) * mag_c, tiny), 1.0)
    return _rank_r(lam, psi) * corr


def _corr_dot(corr_vec, gf):
    """sum_i corr_vec[f,i] * gf[f,i,...]"""
    cv = corr_vec.reshape(corr_vec.shape + (1,) * (gf.ndim - 2))
    return (cv * gf).sum(dim=1)


def laplacian(geom, topo, gamma_f, psi, bcoef: BCoef, corrected: bool = True,
              psi_b=None, grad_psi=None, grad_psi_b=None,
              limit: float = 0.5) -> FvMatrix:
    """fvm::laplacian(gamma, psi)  — 'Gauss linear limited corrected <limit>'.

    gamma_f: (nf,) diffusivity already interpolated to faces.
    corrected: include explicit non-orthogonal correction (needs grad_psi;
    if absent it is computed from psi_b via a Gauss gradient).
    """
    ni = topo.n_internal
    dc = geom.nonorth_dc[:ni] if corrected else geom.delta_coeffs[:ni]
    coef = gamma_f[:ni] * geom.magsf[:ni] * dc  # symmetric positive

    diag_s = -face_sum_pair(coef, coef, topo)
    diag = _zeros_like_state(psi, topo)
    diag = diag + (diag_s if psi.ndim == 1 else diag_s[:, None])
    source = _zeros_like_state(psi, topo)

    # explicit non-orthogonal correction: + div( gamma * k . interp(grad psi) )
    if corrected:
        if grad_psi is None:
            if psi_b is None:
                psi_b = boundary_value(bcoef, psi, topo)
            grad_psi = fvc.grad(geom, topo, psi, psi_b)
        if grad_psi_b is None:
            grad_psi_b = boundary_gather(grad_psi, topo)
        gf = fvc.interpolate(geom, topo, grad_psi, grad_psi_b)[:ni]
        corr = _corr_dot(geom.corr_vec[:ni], gf)
        orth = _rank_r(dc, psi) * (cell_to_face_nei(psi, topo)
                                   - cell_to_face_own(psi, topo))
        corr = _limit_correction(corr, orth, limit, psi)
        cflux = _rank_r(gamma_f[:ni] * geom.magsf[:ni], psi) * corr
        # add to owner, subtract from neighbour; goes to SOURCE with minus
        source = source - face_sum_signed(cflux, topo)

    # boundary: gamma_b |Sf| (gc psi_own + gb), masked on empty patches
    gb_coef = _rank_r(gamma_f[ni:] * geom.magsf[ni:] * bcoef.active, psi)
    diag = boundary_scatter_add(diag, gb_coef * bcoef.gc, topo)
    source = boundary_scatter_add(source, -gb_coef * bcoef.gb, topo)

    return FvMatrix(diag=diag, lower=coef, upper=coef, source=source)


def laplacian_flux(geom, topo, gamma_f, psi, bcoef: BCoef, corrected=True,
                   grad_psi=None, grad_psi_b=None, limit: float = 0.5):
    """Implicit face flux of the laplacian matrix at the current psi —
    OpenFOAM ``pEqn.flux()`` (scalar psi)."""
    ni = topo.n_internal
    dc = geom.nonorth_dc[:ni] if corrected else geom.delta_coeffs[:ni]
    coef = gamma_f[:ni] * geom.magsf[:ni] * dc
    dpsi = cell_to_face_nei(psi, topo) - cell_to_face_own(psi, topo)
    orth = dc * dpsi
    fl_i = coef * dpsi
    if corrected:
        if grad_psi is None:
            psi_b = boundary_value(bcoef, psi, topo)
            grad_psi = fvc.grad(geom, topo, psi, psi_b)
        if grad_psi_b is None:
            grad_psi_b = boundary_gather(grad_psi, topo)
        gf = fvc.interpolate(geom, topo, grad_psi, grad_psi_b)[:ni]
        corr = (geom.corr_vec[:ni] * gf).sum(dim=-1)
        corr = _limit_correction(corr, orth, limit, psi)
        fl_i = fl_i + gamma_f[:ni] * geom.magsf[:ni] * corr
    fl_b = gamma_f[ni:] * geom.magsf[ni:] * bcoef.active \
        * (bcoef.gc * boundary_gather(psi, topo) + bcoef.gb)
    return torch.cat([fl_i, fl_b])


def div_flux(geom, topo, phi_f, psi, bcoef: BCoef, scheme: str = "upwind"):
    """Implicit face flux of the convection matrix at the current psi:
    phi_f * psi_f(scheme), the div part of fvMatrix::flux() that the
    transonic pressure equation needs (reference DARhoSimpleCFoam)."""
    ni = topo.n_internal
    phi_i = phi_f[:ni]
    if scheme == "upwind":
        w = (phi_i >= 0.0).to(psi.dtype)
    else:
        w = geom.weights[:ni]
    fl_i = phi_i * (w * cell_to_face_own(psi, topo)
                    + (1.0 - w) * cell_to_face_nei(psi, topo))
    fl_b = phi_f[ni:] * bcoef.active * (bcoef.vc * boundary_gather(psi, topo)
                                        + bcoef.vb)
    return torch.cat([fl_i, fl_b])


def Sp(geom, topo, coef, psi) -> FvMatrix:
    """fvm::Sp(coef, psi): implicit source, diag += coef * V."""
    ni = topo.n_internal
    d = coef * geom.vol
    diag = _zeros_like_state(psi, topo)
    diag = diag + (d if psi.ndim == 1 else d[:, None])
    return FvMatrix(
        diag=diag,
        lower=psi.new_zeros((ni,)),
        upper=psi.new_zeros((ni,)),
        source=_zeros_like_state(psi, topo),
    )


def ddt(geom, topo, psi, psi_old, dt, psi_oldold=None,
        scheme="Euler") -> FvMatrix:
    """fvm::ddt: implicit Euler or BDF2 ('backward') time derivative."""
    ni = topo.n_internal
    v = geom.vol if psi.ndim == 1 else geom.vol[:, None]
    if scheme == "Euler":
        diagc = v / dt
        src = v / dt * psi_old
    elif scheme == "backward":
        if psi_oldold is None:
            raise ValueError("ddt 'backward' needs psi_oldold")
        diagc = 1.5 * v / dt
        src = v / dt * (2.0 * psi_old - 0.5 * psi_oldold)
    else:
        raise NotImplementedError(scheme)
    return FvMatrix(
        diag=_zeros_like_state(psi, topo) + diagc,
        lower=psi.new_zeros((ni,)),
        upper=psi.new_zeros((ni,)),
        source=_zeros_like_state(psi, topo) + src,
    )
