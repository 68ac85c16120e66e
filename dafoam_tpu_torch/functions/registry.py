"""Objective/constraint functions over patch faces or cell sets (port of
``dafoam_tpu.functions.registry``: every type of the reference's
DAFunction family that the JAX package has).

The context ``ctx`` is assembled by the solver per evaluation:
  state      : state dict
  geom, topo : mesh
  boundary   : {field: (nb,...) boundary-face values}
  phi        : (nf,) face flux (the mass flux of compressible solvers)
  aux        : {name: cell field} derived fields (vonMises, kappa, ...)
  data       : {name: reference data} (variance)
  residuals  : the solver's residuals (residualNorm only)
  gradU_b    : (nb,3,3) boundary velocity gradient
  nu_eff_b   : (nb,) effective viscosity at boundary
  rho_ref    : reference density for incompressible force scaling
  rho_b      : (nb,) boundary density (compressible mass flow)
  aoa_rad    : angle of attack (force parallelToFlow / normalToFlow)
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.ops.core import float_tensor, index_tensor, maximum


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


def _cell_field(ctx, name):
    """A state by name, else an aux field (None when neither has it)."""
    v = ctx["state"].get(name)
    return ctx.get("aux", {}).get(name) if v is None else v


def _vec(val, like):
    return torch.as_tensor(val, dtype=like.dtype, device=like.device)


def _ks(v, coeff):
    """KS aggregate max(v) + log(sum(exp(coeff (v - max)))) / coeff."""
    m = torch.max(v)
    return m + torch.log(torch.sum(torch.exp(coeff * (v - m)))) / coeff


# ---------------------------------------------------------------------------


def f_patch_mean(cfg, ctx):
    """Area-weighted mean of a variable over patches (reference
    DAFunctionPatchMean)."""
    topo, geom = ctx["topo"], ctx["geom"]
    mask = _patch_mask(topo, cfg["patches"], geom.magsf)
    w = geom.magsf[topo.n_internal:] * mask
    v = _bface_field(ctx, cfg["varName"])
    if v.ndim == 2:
        v = v[:, cfg.get("component", 0)]
    return torch.sum(w * v) / maximum(torch.sum(w), 1e-36)


def f_variable_vol_sum(cfg, ctx):
    """sum(var^index [^2] [* V]) over cells (reference
    DAFunctionVariableVolSum), optionally divided by the total volume."""
    geom = ctx["geom"]
    v = _cell_field(ctx, cfg["varName"])
    if v.ndim == 2:
        v = v[:, cfg.get("component", 0)]
    val = v ** cfg.get("index", 1)
    if cfg.get("isSquare", 0):
        val = val ** 2
    if cfg.get("multiplyVol", 1):
        val = val * geom.vol
    if cfg.get("divByTotalVol", 0):
        return torch.sum(val) / torch.sum(geom.vol)
    return torch.sum(val)


def f_mass_flow_rate(cfg, ctx):
    topo = ctx["topo"]
    mask = _patch_mask(topo, cfg["patches"], ctx["phi"])
    phi_b = ctx["phi"][topo.n_internal:]
    rho = ctx.get("rho_b", 1.0)
    return torch.sum(mask * rho * phi_b)


def f_total_pressure(cfg, ctx):
    """Mass-flow-averaged total pressure over patches (incompressible:
    p0 = rho (p + 0.5 |U|^2), reference DAFunctionTotalPressure)."""
    topo, geom = ctx["topo"], ctx["geom"]
    mask = _patch_mask(topo, cfg["patches"], geom.magsf)
    p_b = _bface_field(ctx, "p")
    U_b = _bface_field(ctx, "U")
    rho = ctx.get("rho_ref", 1.0)
    p0 = rho * (p_b + 0.5 * (U_b * U_b).sum(dim=-1))
    w = torch.abs(ctx["phi"][topo.n_internal:]) * mask
    return torch.sum(w * p0) / maximum(torch.sum(w), 1e-36)


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
    if mode == "fixedDirection":
        d = _vec(cfg["direction"], f)
    elif mode in ("parallelToFlow", "normalToFlow"):
        # AoA from the patchVelocity input (reference pyDAFoam.py:131-137):
        # drag parallel to the flow, lift normal to it, in the flowAxis plane
        aoa = ctx["aoa_rad"]
        flow = cfg.get("flowAxisIndex", 0)
        normal = cfg.get("normalAxisIndex", 1)
        cols = [f.new_zeros(()) for _ in range(3)]
        if mode == "parallelToFlow":
            cols[flow], cols[normal] = torch.cos(aoa), torch.sin(aoa)
        else:
            cols[flow], cols[normal] = -torch.sin(aoa), torch.cos(aoa)
        d = torch.stack(cols)
    else:
        raise NotImplementedError(mode)
    return torch.sum(f @ d)


def f_moment(cfg, ctx):
    topo, geom = ctx["topo"], ctx["geom"]
    f = _wall_force(cfg, ctx)
    center = _vec(cfg.get("center", [0.0, 0.0, 0.0]), f)
    axis = _vec(cfg["axis"], f)
    r = geom.cf[topo.n_internal:] - center
    return torch.sum(torch.linalg.cross(r, f) @ axis)


def f_field_max(cfg, ctx):
    """Differentiable max by KS aggregation (reference DAFunctionFieldMax)."""
    v = _cell_field(ctx, cfg["varName"])
    if v.ndim == 2:
        v = v[:, cfg.get("component", 0)]
    return _ks(v, cfg.get("coeffKS", 20.0))


def f_residual_norm(cfg, ctx):
    """Weighted sum of squares of selected residuals (reference
    DAFunctionResidualNorm)."""
    res = ctx["residuals"]
    weights = cfg.get("resWeight", {})
    tot = 0.0
    for name in cfg.get("resWeight", {k: 1.0 for k in res}):
        r = res[name.replace("Res", "")] if name.endswith("Res") \
            else res[name]
        tot = tot + weights.get(name, 1.0) * torch.sum(r * r)
    return tot


def f_variance(cfg, ctx):
    """Data misfit for field inversion (reference DAFunctionVariance):
    sum((var - data)^2)/N over cells or probe points."""
    v = _cell_field(ctx, cfg["varName"])
    data = ctx["data"][cfg["varName"] + "Data"]
    if cfg.get("varType") == "vector" or (v is not None and v.ndim == 2):
        comps = list(cfg.get("components", [0, 1, 2]))
        diff = (v[:, comps] - data[:, comps]).reshape(-1)
    else:
        diff = v - data
    if cfg.get("mode", "field") == "probePoint" and "probe_weights" in ctx:
        diff = diff * ctx["probe_weights"]
    return torch.sum(diff * diff) / diff.shape[0]


def f_wall_heat_flux(cfg, ctx):
    """Integrated (or area-averaged) wall heat flux of the solver's
    ``wall_heat_flux_b`` (reference DAFunctionWallHeatFlux)."""
    topo, geom = ctx["topo"], ctx["geom"]
    ni = topo.n_internal
    mask = _patch_mask(topo, cfg["patches"], geom.magsf)
    q = ctx["wall_heat_flux_b"]
    tot = torch.sum(q * geom.magsf[ni:] * mask)
    if cfg.get("byUnitArea", 1):
        return tot / maximum(torch.sum(geom.magsf[ni:] * mask), 1e-36)
    return tot


def f_von_mises_ks(cfg, ctx):
    """KS-aggregated von Mises stress (reference
    DAFunctionVonMisesStressKS)."""
    return _ks(ctx["aux"]["vonMises"], cfg.get("coeffKS", 2e-3))


def f_mesh_quality_ks(cfg, ctx):
    """KS-aggregated face non-orthogonality in degrees (reference
    DAFunctionMeshQualityKS)."""
    geom, topo = ctx["geom"], ctx["topo"]
    ni = topo.n_internal
    dev = geom.cc.device
    own = index_tensor(topo, "own_i", dev, lambda: topo.owner[:ni])
    nei = index_tensor(topo, "nei", dev, lambda: topo.neighbour)
    d = geom.cc.index_select(0, nei) - geom.cc.index_select(0, own)
    nhat = geom.sf[:ni] / maximum(geom.magsf[:ni], 1e-36)[:, None]
    cosang = (nhat * d).sum(dim=-1) / maximum(
        torch.sqrt(maximum((d * d).sum(dim=-1), 1e-36)), 1e-36)
    metric = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    return _ks(metric, cfg.get("coeffKS", 0.1))


def _flux_avg(ctx, patches, vals):
    """|phi|-weighted mean of boundary values over patches."""
    topo = ctx["topo"]
    mask = _patch_mask(topo, patches, vals)
    w = torch.abs(ctx["phi"][topo.n_internal:]) * mask
    return torch.sum(w * vals) / maximum(torch.sum(w), 1e-36)


def _mach2(cfg, ctx):
    gam = cfg.get("gamma", 1.4)
    T_b = _bface_field(ctx, "T")
    U_b = _bface_field(ctx, "U")
    c2 = gam * cfg.get("R", 287.0) * T_b
    return gam, T_b, (U_b * U_b).sum(dim=-1) / maximum(c2, 1e-36)


def f_total_pressure_ratio(cfg, ctx):
    """Mass-flow-averaged total-pressure ratio outlet/inlet (reference
    DAFunctionTotalPressureRatio): p0 = p (1 + (g-1)/2 M^2)^(g/(g-1))."""
    p_b = _bface_field(ctx, "p")
    gam, _, M2 = _mach2(cfg, ctx)
    p0 = p_b * (1.0 + 0.5 * (gam - 1.0) * M2) ** (gam / (gam - 1.0))
    return _flux_avg(ctx, cfg["outletPatches"], p0) / maximum(
        _flux_avg(ctx, cfg["inletPatches"], p0), 1e-36)


def f_total_temperature_ratio(cfg, ctx):
    """Mass-flow-averaged total-temperature ratio outlet/inlet (reference
    DAFunctionTotalTemperatureRatio): T0 = T (1 + (g-1)/2 M^2)."""
    gam, T_b, M2 = _mach2(cfg, ctx)
    T0 = T_b * (1.0 + 0.5 * (gam - 1.0) * M2)
    return _flux_avg(ctx, cfg["outletPatches"], T0) / maximum(
        _flux_avg(ctx, cfg["inletPatches"], T0), 1e-36)


def f_location(cfg, ctx):
    """Differentiable location of a field extremum by softmax-weighted
    coordinates (reference DAFunctionLocation, mode maxRadius)."""
    geom = ctx["geom"]
    v = _cell_field(ctx, cfg["varName"])
    if v is not None and v.ndim == 2:
        v = torch.sqrt(maximum((v * v).sum(dim=-1), 1e-36))
    mode = cfg.get("mode", "maxRadius")
    axis = _vec(cfg.get("axis", [0.0, 0.0, 1.0]), geom.cc)
    center = _vec(cfg.get("center", [0.0, 0.0, 0.0]), geom.cc)
    d = geom.cc - center
    z = d @ axis
    r = torch.sqrt(maximum((d * d).sum(dim=-1) - z ** 2, 1e-36))
    w = torch.softmax(cfg.get("coeffKS", 20.0) * v, dim=0)
    if mode == "maxRadius":
        return torch.sum(w * r)
    raise NotImplementedError(mode)


_REGISTRY = {
    "patchMean": f_patch_mean,
    "variableVolSum": f_variable_vol_sum,
    "massFlowRate": f_mass_flow_rate,
    "totalPressure": f_total_pressure,
    "force": f_force,
    "moment": f_moment,
    "fieldMax": f_field_max,
    "residualNorm": f_residual_norm,
    "variance": f_variance,
    "wallHeatFlux": f_wall_heat_flux,
    "vonMisesStressKS": f_von_mises_ks,
    "meshQualityKS": f_mesh_quality_ks,
    "totalPressureRatio": f_total_pressure_ratio,
    "totalTemperatureRatio": f_total_temperature_ratio,
    "location": f_location,
}


def evaluate_function(cfg: dict, ctx: dict):
    """Evaluate one `function` config entry -> scalar (times `scale`)."""
    ftype = cfg["type"]
    if ftype not in _REGISTRY:
        raise NotImplementedError(f"function type {ftype!r}")
    return _REGISTRY[ftype](cfg, ctx) * cfg.get("scale", 1.0)
