"""Multiple reference frames (MRF): rotating-zone source terms (port of
``dafoam_tpu.mrf``, the reference's MRFZoneListDF).

The rotation speed is a leaf of ``inputs["params"]["MRF"]["omega"]``
(else ``option["MRF"]["omega"]``), differentiable like every input.

Semantics (relative-velocity formulation inside the zone):
  UEqn += Omega x U                    (MRF.DDt(U), Coriolis)
  phi  -= (Omega x (Cf - origin)).Sf   (makeRelative on zone faces)
  rotating-wall BC: U_wall = Omega x (Cf - origin)

Config (option["MRF"]): {"active": True, "origin", "axis", "omega",
"cellZone": "all" | {"type": "cylinder", "origin", "axis", "radius",
"z1", "z2"}, "rotatingPatches": [names]}.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops.core import index_tensor, maximum


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _unit(v):
    return v / maximum(torch.linalg.norm(v), 1e-36)


def omega_vector(cfg, inputs, like):
    """Omega = omega * unit axis, as a (3,) tensor of ``like``'s dtype."""
    om = inputs["params"].get("MRF", {}).get("omega")
    if om is None:
        om = cfg["omega"]
    return _vec(om, like) * _unit(_vec(cfg.get("axis", [0.0, 0.0, 1.0]),
                                       like))


def cell_mask(cfg, geom):
    zone = cfg.get("cellZone", "all")
    if zone == "all":
        return torch.ones_like(geom.vol)
    if zone.get("type") == "cylinder":
        o = _vec(zone["origin"], geom.vol)
        ax = _unit(_vec(zone["axis"], geom.vol))
        d = geom.cc - o
        z = d @ ax
        r = torch.sqrt(maximum((d * d).sum(dim=-1) - z ** 2, 1e-30))
        inside = (r <= zone["radius"]) & (z >= zone.get("z1", -1e30)) \
            & (z <= zone.get("z2", 1e30))
        return inside.to(geom.vol.dtype)
    raise NotImplementedError(zone)


def face_mask(cfg, geom, topo):
    """Faces whose owner is in the zone (zone interior + its boundary)."""
    own = index_tensor(topo, "owner", geom.vol.device, lambda: topo.owner)
    return cell_mask(cfg, geom).index_select(0, own)


def ddt_source(cfg, U, geom, inputs):
    """Omega x U in zone cells -> (nc,3) per-volume source (MRF.DDt)."""
    om = omega_vector(cfg, inputs, U)
    return cell_mask(cfg, geom)[:, None] * torch.linalg.cross(
        torch.broadcast_to(om, U.shape), U)


def make_relative(cfg, phi, geom, topo, inputs):
    """phi -= (Omega x r_f) . Sf on zone faces (OpenFOAM makeRelative)."""
    om = omega_vector(cfg, inputs, phi)
    r = geom.cf - _vec(cfg.get("origin", [0.0, 0.0, 0.0]), phi)
    urot = torch.linalg.cross(torch.broadcast_to(om, r.shape), r)
    return phi - face_mask(cfg, geom, topo) * (urot * geom.sf).sum(dim=-1)


def rotating_wall_values(cfg, geom, topo, patches, inputs):
    """{patch: (n,3) wall velocity Omega x r} for rotatingPatches
    (correctBoundaryVelocity)."""
    om = omega_vector(cfg, inputs, geom.cf)
    origin = _vec(cfg.get("origin", [0.0, 0.0, 0.0]), geom.cf)
    out = {}
    for name in patches:
        r = geom.cf[topo.patch_slice(name)] - origin
        out[name] = torch.linalg.cross(torch.broadcast_to(om, r.shape), r)
    return out
