"""Boundary conditions as coefficient functions (port of
``dafoam_tpu.ops.bc``).

Every OpenFOAM fvPatchField is characterized, for assembly purposes, by four
per-face coefficient arrays (valueInternalCoeffs, valueBoundaryCoeffs,
gradientInternalCoeffs, gradientBoundaryCoeffs):

    boundary value    psi_b     = vc * psi_own + vb
    boundary snGrad   dpsi/dn|b = gc * psi_own + gb

Static data (BC types per patch) lives in the spec dict; the values live in
a separate ``values`` dict of tensors so BC values can be design inputs.

This slice ports the types the NACA0012 SIMPLE+SA primal uses:
``fixedValue``, ``zeroGradient``, ``inletOutlet`` and ``empty``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dafoam_tpu_torch.ops.core import boundary_gather


class BCoef(NamedTuple):
    vc: torch.Tensor      # (nb,) or (nb,3) value internal coeff
    vb: torch.Tensor      # value boundary coeff
    gc: torch.Tensor      # gradient internal coeff
    gb: torch.Tensor      # gradient boundary coeff
    active: torch.Tensor  # (nb,) 1.0 except empty patches


def _expand(val, size, rank, like):
    v = torch.as_tensor(val, dtype=like.dtype, device=like.device)
    target = (size, 3) if rank == 1 else (size,)
    return torch.broadcast_to(v, target)


def coeffs(bcspec: dict, values: dict, topo, geom, psi: torch.Tensor,
           rank: int = 0, phi_b: torch.Tensor | None = None) -> BCoef:
    """Assemble boundary coefficient arrays for one field over all patches.

    bcspec : {patch_name: {"type": str, ...}} (static)
    values : {patch_name: tensor} BC values
    psi    : (nc,) or (nc,3) current cell values
    phi_b  : (nb,) boundary face flux, needed by inletOutlet
    """
    ni = topo.n_internal
    psi_own_all = boundary_gather(psi, topo)
    dc_all = geom.nonorth_dc[ni:]

    vcs, vbs, gcs, gbs, acts = [], [], [], [], []
    for p in topo.patches:
        sl = slice(p.start - ni, p.start - ni + p.size)
        n = p.size
        spec = bcspec.get(p.name, {"type": "zeroGradient"})
        btype = spec["type"]
        psi_own = psi_own_all[sl]
        dc = dc_all[sl]
        dc_b = dc[:, None] if rank == 1 else dc

        one = torch.ones_like(psi_own)
        zero = torch.zeros_like(psi_own)
        act = torch.ones((n,), dtype=psi.dtype, device=psi.device)

        if btype == "empty":
            vc, vb, gc, gb = zero, zero, zero, zero
            act = torch.zeros((n,), dtype=psi.dtype, device=psi.device)
        elif btype == "zeroGradient":
            vc, vb, gc, gb = one, zero, zero, zero
        elif btype == "fixedValue":
            val = _expand(values.get(p.name, 0.0), n, rank, psi)
            vc, vb = zero, val
            gc, gb = -dc_b * one, dc_b * val
        elif btype == "inletOutlet":
            if phi_b is None:
                raise ValueError("inletOutlet BC needs phi_b")
            val = _expand(values.get(p.name, 0.0), n, rank, psi)
            out = phi_b[sl] >= 0.0  # outflow -> zeroGradient
            if rank == 1:
                out = out[:, None]
            vc = torch.where(out, one, zero)
            vb = torch.where(out, zero, val)
            gc = torch.where(out, zero, -dc_b * one)
            gb = torch.where(out, zero, dc_b * val)
        else:
            raise NotImplementedError(
                f"BC type {btype!r} (patch {p.name}) is not ported yet: "
                "dafoam_tpu_torch has fixedValue, zeroGradient, inletOutlet "
                "and empty (ROADMAP.md queue 1 adds the rest with the "
                "solvers that use them)")

        vcs.append(vc)
        vbs.append(vb)
        gcs.append(gc)
        gbs.append(gb)
        acts.append(act)

    return BCoef(vc=torch.cat(vcs), vb=torch.cat(vbs), gc=torch.cat(gcs),
                 gb=torch.cat(gbs), active=torch.cat(acts))


def boundary_value(bcoef: BCoef, psi: torch.Tensor, topo) -> torch.Tensor:
    """psi_b = vc*psi_own + vb on every boundary face."""
    return bcoef.vc * boundary_gather(psi, topo) + bcoef.vb


def boundary_sngrad(bcoef: BCoef, psi: torch.Tensor, topo) -> torch.Tensor:
    return bcoef.gc * boundary_gather(psi, topo) + bcoef.gb
