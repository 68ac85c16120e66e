"""Boundary conditions as coefficient functions (port of
``dafoam_tpu.ops.bc``).

Every OpenFOAM fvPatchField is characterized, for assembly purposes, by four
per-face coefficient arrays (valueInternalCoeffs, valueBoundaryCoeffs,
gradientInternalCoeffs, gradientBoundaryCoeffs):

    boundary value    psi_b     = vc * psi_own + vb
    boundary snGrad   dpsi/dn|b = gc * psi_own + gb

Static data (BC types per patch) lives in the spec dict; the values live in
a separate ``values`` dict of tensors so BC values can be design inputs.
Parametric types (multiFreq*, varyingVelocity*, homTemp,
wallHeatFluxTransfer, fixedWallHeatFlux) take a dict of tensors per patch
that overrides their static parameters, and time-dependent ones read the
physical time ``t``.

Every type of ``dafoam_tpu.ops.bc`` is here: zeroGradient/extrapolated,
fixedValue/noSlip/calculated, fixedGradient, mixed, inletOutlet,
symmetry/slip (ranks 0 and 1), multiFreqScalar/Vector,
varyingVelocity(InletOutlet), homTemp, wallHeatFluxTransfer,
fixedWallHeatFlux and empty.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dafoam_tpu_torch.ops.core import boundary_gather, maximum
from dafoam_tpu_torch.utils.precision import guard_tiny


class BCoef(NamedTuple):
    vc: torch.Tensor      # (nb,) or (nb,3) value internal coeff
    vb: torch.Tensor      # value boundary coeff
    gc: torch.Tensor      # gradient internal coeff
    gb: torch.Tensor      # gradient boundary coeff
    active: torch.Tensor  # (nb,) 1.0 except empty patches


_ZG_TYPES = ("zeroGradient", "extrapolated")
_FV_TYPES = ("fixedValue", "noSlip", "calculated")


def _as(val, like):
    return torch.as_tensor(val, dtype=like.dtype, device=like.device)


def _expand(val, size, rank, like):
    target = (size, 3) if rank == 1 else (size,)
    return torch.broadcast_to(_as(val, like), target)


def _params(spec: dict, values: dict, pname: str) -> dict:
    """The static spec merged with a per-patch override dict of tensors,
    so parametric-BC parameters can be design inputs."""
    over = values.get(pname, {})
    if not isinstance(over, dict):
        return spec
    return {**spec, **over}


def _inlet_outlet(out, one, zero, val, dc_b):
    """zeroGradient on outflow faces, fixedValue ``val`` on inflow ones."""
    return (torch.where(out, one, zero), torch.where(out, zero, val),
            torch.where(out, zero, -dc_b * one),
            torch.where(out, zero, dc_b * val))


def coeffs(bcspec: dict, values: dict, topo, geom, psi: torch.Tensor,
           rank: int = 0, phi_b: torch.Tensor | None = None,
           t=0.0) -> BCoef:
    """Assemble boundary coefficient arrays for one field over all patches.

    bcspec : {patch_name: {"type": str, ...}} (static)
    values : {patch_name: tensor-or-dict} BC values; dict-valued entries
             override the static parameters of parametric BCs
    psi    : (nc,) or (nc,3) current cell values (for the lagged
             cross-component part of symmetry/slip)
    phi_b  : (nb,) boundary face flux, needed by the inletOutlet family
    t      : physical time of the time-dependent BCs (multiFreq*,
             varyingVelocity*)
    """
    ni = topo.n_internal
    psi_own_all = boundary_gather(psi, topo)
    dc_all = geom.nonorth_dc[ni:]
    sf_all = geom.sf[ni:]
    magsf_all = maximum(geom.magsf[ni:], 1e-36)

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
        elif btype in _ZG_TYPES or (rank == 0
                                    and btype in ("symmetry", "slip")):
            vc, vb, gc, gb = one, zero, zero, zero
        elif btype in _FV_TYPES:
            val = _expand(values.get(p.name, 0.0), n, rank, psi)
            vc, vb = zero, val
            gc, gb = -dc_b * one, dc_b * val
        elif btype == "fixedGradient":
            g = _expand(values.get(p.name, 0.0), n, rank, psi)
            vc, vb = one, g / dc_b
            gc, gb = zero, g
        elif btype == "mixed":
            # Robin BC (OpenFOAM mixedFvPatchField): values[patch] =
            # {"refValue", "refGrad", "valueFraction"}
            v = values.get(p.name, {})
            rv = _expand(v.get("refValue", 0.0), n, rank, psi)
            rg = _expand(v.get("refGrad", 0.0), n, rank, psi)
            vf = _expand(v.get("valueFraction", 1.0), n, rank, psi)
            vc = (1.0 - vf) * one
            vb = vf * rv + (1.0 - vf) * rg / dc_b
            gc = -vf * dc_b
            gb = vf * rv * dc_b + (1.0 - vf) * rg
        elif btype == "inletOutlet":
            if phi_b is None:
                raise ValueError("inletOutlet BC needs phi_b")
            val = _expand(values.get(p.name, 0.0), n, rank, psi)
            out = phi_b[sl] >= 0.0  # outflow -> zeroGradient
            if rank == 1:
                out = out[:, None]
            vc, vb, gc, gb = _inlet_outlet(out, one, zero, val, dc_b)
        elif btype in ("symmetry", "slip") and rank == 1:
            nhat = sf_all[sl] / magsf_all[sl][:, None]
            # psi_b = psi - (psi.n) n: per-component implicit part 1-n_c^2,
            # cross-component part lagged (OpenFOAM per-cmpt approximation)
            psin = (psi_own * nhat).sum(dim=-1)
            vc = 1.0 - nhat * nhat
            vb = -(psin[:, None] - psi_own * nhat) * nhat
            gc = (vc - 1.0) * dc_b
            gb = vb * dc_b
        elif btype in ("multiFreqScalar", "multiFreqVector"):
            # DAMisc multiFreq{Scalar,Vector}: fixedValue refValue +
            # sum_i a_i sin(2 pi f_i t + ph_i) (the vector form adds it to
            # one component, only while t < endTime)
            pr = _params(spec, values, p.name)
            amps = _as(pr.get("amplitudes", ()), psi).reshape(-1)
            freqs = _as(pr.get("frequencies", ()), psi).reshape(-1)
            phases = _as(pr.get("phases", ()), psi).reshape(-1)
            nf = max(amps.shape[0], freqs.shape[0], phases.shape[0])
            if nf:
                osc = torch.sum(torch.broadcast_to(amps, (nf,)) * torch.sin(
                    2.0 * math.pi * torch.broadcast_to(freqs, (nf,)) * t
                    + torch.broadcast_to(phases, (nf,))))
            else:
                osc = _as(0.0, psi)
            if btype == "multiFreqScalar":
                val = _expand(pr.get("refValue", 0.0), n, 0, psi) + osc
            else:
                end_t = pr.get("endTime", None)
                if end_t is not None:
                    osc = torch.where(_as(t, psi) < _as(end_t, psi), osc,
                                      0.0)
                comp = int(spec.get("component", 0))
                val = _expand(pr.get("refValue", [0.0, 0.0, 0.0]), n, 1,
                              psi)
                e = psi.new_zeros((3,))
                e[comp] = 1.0
                val = val + osc * e
            vc, vb = zero, val
            gc, gb = -dc_b * one, dc_b * val
        elif btype in ("varyingVelocity", "varyingVelocityInletOutlet"):
            # DAMisc varyingVelocity*: U(t) = U0 + URate t at the angle
            # alpha0 + alphaRate t, split over the flow / normal
            # components; the InletOutlet form is zeroGradient on outflow
            pr = _params(spec, values, p.name)
            Ut = _as(pr.get("U0", 0.0), psi) \
                + _as(pr.get("URate", 0.0), psi) * t
            al = _as(pr.get("alpha0", 0.0), psi) \
                + _as(pr.get("alphaRate", 0.0), psi) * t
            fc = int(spec.get("flowComponent", 0))
            nc_ = int(spec.get("normalComponent", 1))
            cols = [psi.new_zeros(()) for _ in range(3)]
            cols[fc] = Ut * torch.cos(al)
            cols[nc_] = Ut * torch.sin(al)
            val = torch.broadcast_to(torch.stack(cols), (n, 3))
            if btype == "varyingVelocity":
                vc, vb = zero, val
                gc, gb = -dc_b * one, dc_b * val
            else:
                if phi_b is None:
                    raise ValueError(
                        "varyingVelocityInletOutlet BC needs phi_b")
                out = (phi_b[sl] >= 0.0)[:, None]
                vc, vb, gc, gb = _inlet_outlet(out, one, zero, val, dc_b)
        elif btype == "homTemp":
            # DAMisc homTemp: homogenized thin solid layer,
            # T_face = (T_base + C T_cell) / (1 + C),
            # C = kF/kS * solidThickness * deltaCoeffs
            pr = _params(spec, values, p.name)
            kS = _as(pr.get("kS", 1.0), psi)
            kF = _as(pr.get("kF", 1.0), psi)
            th = _as(pr.get("solidThickness", 0.0), psi)
            Tb = _expand(pr.get("baseTemperature", 0.0), n, 0, psi)
            C = kF / kS * th * dc
            vc = (C / (1.0 + C)) * one
            vb = Tb / (1.0 + C)
            gc = (vc - 1.0) * dc_b
            gb = vb * dc_b
        elif btype == "wallHeatFluxTransfer":
            # DAMisc wallHeatFluxTransfer: mixed BC with an external heat
            # transfer coefficient h and ambient Ta,
            # valueFraction = h / (h + kappa deltaCoeffs), refGrad = 0
            pr = _params(spec, values, p.name)
            hh = _expand(pr.get("h", 0.0), n, 0, psi)
            Ta = _expand(pr.get("Ta", 293.0), n, 0, psi)
            kap = _expand(pr.get("kappa", 1.0), n, 0, psi)
            vf = hh / maximum(hh + kap * dc, guard_tiny(psi.dtype))
            vc = (1.0 - vf) * one
            vb = vf * Ta
            gc = -vf * dc_b
            gb = vf * Ta * dc_b
        elif btype == "fixedWallHeatFlux":
            # DAMisc fixedWallHeatFlux: fixedGradient with
            # grad = q / alphaCpEff (the solver's effective diffusivity*Cp)
            pr = _params(spec, values, p.name)
            q = _expand(pr.get("heatFlux", 0.0), n, 0, psi)
            aCp = _expand(pr.get("alphaCpEff", 1.0), n, 0, psi)
            g = q / maximum(aCp, guard_tiny(psi.dtype))
            vc, vb = one, g / dc_b
            gc, gb = zero, g
        else:
            raise NotImplementedError(f"BC type {btype!r} (patch {p.name})")

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
