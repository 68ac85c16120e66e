"""Explicit finite-volume operators (OpenFOAM ``fvc::``), in torch.

Port of ``dafoam_tpu.ops.fvc``: (geometry, cell field, boundary face
values) -> field. Boundary values come from ``dafoam_tpu_torch.ops.bc``.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops.core import (boundary_scatter_add,
                                       cell_to_face_nei, cell_to_face_own,
                                       face_sum_pair, surface_sum)


def interpolate(geom, topo, psi: torch.Tensor, psi_b: torch.Tensor):
    """Linear (central) face interpolation; boundary faces take psi_b."""
    ni = topo.n_internal
    w = geom.weights[:ni].reshape((-1,) + (1,) * (psi.ndim - 1))
    own = cell_to_face_own(psi, topo)
    nei = cell_to_face_nei(psi, topo)
    return torch.cat([w * own + (1.0 - w) * nei, psi_b], dim=0)


def snGrad(geom, topo, psi, sng_b, corrected=False, grad_psi=None,
           grad_psi_b=None):
    """Surface-normal gradient on internal faces + the given boundary
    snGrad. corrected=True adds the non-orthogonal correction
    k_f . interp(grad psi) (OpenFOAM correctedSnGrad) with the corrected
    delta coefficients; it needs ``grad_psi`` and its boundary values."""
    ni = topo.n_internal
    dc = geom.nonorth_dc[:ni] if corrected else geom.delta_coeffs[:ni]
    d = dc.reshape((-1,) + (1,) * (psi.ndim - 1))
    g = d * (cell_to_face_nei(psi, topo) - cell_to_face_own(psi, topo))
    if corrected:
        if grad_psi is None:
            raise ValueError("corrected snGrad needs grad_psi")
        gf = interpolate(geom, topo, grad_psi, grad_psi_b)[:ni]
        # psi scalar: grad (nc,3) -> (ni,); psi vector: (nc,3,3) -> (ni,3)
        cv = geom.corr_vec[:ni].reshape((-1, 3) + (1,) * (gf.ndim - 2))
        g = g + (cv * gf).sum(dim=1)
    return torch.cat([g, sng_b], dim=0)


def grad(geom, topo, psi: torch.Tensor, psi_b: torch.Tensor):
    """Gauss gradient: (1/V) sum_f Sf (x) psi_f.

    scalar -> (nc,3); vector -> (nc,3,3) with grad[c,i,j] = d psi_j / d x_i.
    """
    fvals = interpolate(geom, topo, psi, psi_b)
    ni = topo.n_internal
    if psi.ndim == 1:
        gi = geom.sf[:ni] * fvals[:ni, None]
        gb = geom.sf[ni:] * fvals[ni:, None]
        return surface_sum(gi, gb, topo) / geom.vol[:, None]
    gi = geom.sf[:ni, :, None] * fvals[:ni, None, :]
    gb = geom.sf[ni:, :, None] * fvals[ni:, None, :]
    return surface_sum(gi, gb, topo) / geom.vol[:, None, None]


def div_surface(geom, topo, phi_f: torch.Tensor):
    """fvc::div of a surface (face) flux field: (1/V) * surfaceSum(phi)."""
    ni = topo.n_internal
    extra = (1,) * (phi_f.ndim - 1)
    out = surface_sum(phi_f[:ni], phi_f[ni:], topo)
    return out / geom.vol.reshape((-1,) + extra)


def div(geom, topo, phi_f, psi, psi_b):
    """Explicit convection fvc::div(phi, psi) with linear interpolation."""
    fvals = interpolate(geom, topo, psi, psi_b)
    t = phi_f.reshape((-1,) + (1,) * (psi.ndim - 1)) * fvals
    return div_surface(geom, topo, t)


def div_tensor(geom, topo, T, T_b):
    """fvc::div of a cell tensor field: (1/V) sum_f Sf . T_f -> (nc,3)."""
    Tf = interpolate(geom, topo, T, T_b)
    ni = topo.n_internal
    fi = (geom.sf[:ni, :, None] * Tf[:ni]).sum(dim=1)
    fb = (geom.sf[ni:, :, None] * Tf[ni:]).sum(dim=1)
    return surface_sum(fi, fb, topo) / geom.vol[:, None]


def flux(geom, topo, U, U_b):
    """fvc::flux(U) = Sf & interp(U) on every face -> (nf,)."""
    Uf = interpolate(geom, topo, U, U_b)
    return (geom.sf * Uf).sum(dim=-1)


def average_to_faces(geom, topo, psi, psi_b):
    return interpolate(geom, topo, psi, psi_b)


def cell_sum(geom, vals):
    return torch.sum(vals * geom.vol)


def reconstruct(geom, topo, F_face):
    """OpenFOAM fvc::reconstruct: cell vector field from face fluxes,

    r_c = [sum_f (Sf Sf^T)/|Sf|]^-1  sum_f (Sf/|Sf|) F_f

    Degenerate (zero-area) dense-layout faces contribute nothing."""
    ni = topo.n_internal
    msf = torch.where(geom.magsf > 0.0, geom.magsf, 1.0)
    sf_n = geom.sf / msf[:, None]
    # G = sum_f Sf (x) Sf/|Sf| : (nc, 3, 3), owner and neighbour rows
    outer = (geom.sf[:, :, None] * sf_n[:, None, :]).reshape(-1, 9)
    Gi = face_sum_pair(outer[:ni], outer[:ni], topo)
    G = boundary_scatter_add(Gi, outer[ni:], topo).reshape(-1, 3, 3)
    rhs_f = sf_n * F_face[:, None]
    ri = face_sum_pair(rhs_f[:ni], rhs_f[:ni], topo)
    r = boundary_scatter_add(ri, rhs_f[ni:], topo)
    # regularize to keep 3x3 invertible on 2-D (empty-direction) meshes
    G = G + 1e-30 * torch.eye(3, dtype=F_face.dtype, device=F_face.device)
    return torch.linalg.solve(G, r[..., None])[..., 0]
