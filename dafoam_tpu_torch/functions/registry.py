"""Objective functions over patch faces (port of
``dafoam_tpu.functions.registry``; this slice has ``force``).

The context ``ctx`` is assembled by the solver per evaluation:
  state      : state dict
  geom, topo : mesh
  boundary   : {field: (nb,...) boundary-face values}
  gradU_b    : (nb,3,3) boundary velocity gradient
  nu_eff_b   : (nb,) effective viscosity at boundary
  rho_ref    : reference density for incompressible force scaling
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.ops.core import float_tensor


def _patch_mask(topo, patches, like):
    """(nb,) 0/1 mask of boundary faces belonging to the named patches."""
    def make():
        m = np.zeros((topo.n_boundary,))
        for name in patches:
            m[topo.patch_bslice(name)] = 1.0
        return m

    return float_tensor(topo, "patch_mask:" + ",".join(patches), like.device,
                        like.dtype, make)


def _bface_field(ctx, var):
    b = ctx["boundary"].get(var)
    if b is None:
        raise KeyError(f"function needs boundary values of {var!r}")
    return b


def _wall_force(cfg, ctx):
    """Per-face force vector on wall patches: pressure + viscous.

    fp = Sf * rho * (p - pRef);  fv = -rho nuEff (grad U + grad U^T) . Sf
    (reference DAFunctionForce uses devRhoReff the same way)."""
    topo, geom = ctx["topo"], ctx["geom"]
    ni = topo.n_internal
    mask = _patch_mask(topo, cfg["patches"], geom.magsf)
    p_b = _bface_field(ctx, "p")
    rho = ctx.get("rho_ref", 1.0)
    p_ref = cfg.get("pRef", 0.0)
    fp = geom.sf[ni:] * (rho * (p_b - p_ref))[:, None]
    fv = 0.0
    if "gradU_b" in ctx:
        gradU_b = ctx["gradU_b"]  # (nb,3,3), grad[i,j]=dU_j/dx_i
        nu_b = ctx.get("nu_eff_b", 0.0)
        tau = gradU_b + torch.swapaxes(gradU_b, -1, -2)
        rnu = torch.broadcast_to(torch.as_tensor(rho * nu_b), tau.shape[:1])
        fv = -rnu[:, None] * (tau * geom.sf[ni:, :, None]).sum(dim=1)
    return (fp + fv) * mask[:, None]


def f_force(cfg, ctx):
    f = _wall_force(cfg, ctx)
    mode = cfg.get("directionMode", "fixedDirection")
    if mode != "fixedDirection":
        raise NotImplementedError(
            f"force directionMode {mode!r} is not ported yet (it needs the "
            "angle-of-attack input, ROADMAP.md queue 1, P5)")
    d = torch.as_tensor(cfg["direction"], dtype=f.dtype, device=f.device)
    return torch.sum(f @ d)


_REGISTRY = {"force": f_force}


def evaluate_function(cfg: dict, ctx: dict):
    """Evaluate one `function` config entry -> scalar (times `scale`)."""
    ftype = cfg["type"]
    if ftype not in _REGISTRY:
        raise NotImplementedError(
            f"function type {ftype!r} is not ported yet: dafoam_tpu_torch "
            f"has {sorted(_REGISTRY)}")
    return _REGISTRY[ftype](cfg, ctx) * cfg.get("scale", 1.0)
