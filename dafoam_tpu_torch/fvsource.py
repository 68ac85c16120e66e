"""Differentiable momentum/energy source terms (port of
``dafoam_tpu.fvsource``, the reference's DAFvSource family:
actuatorDisk, actuatorPoint, actuatorLine, heatSource,
uniformPressureGradient).

Sources are functions of (geometry, params); actuator parameters live in
``inputs["params"]["fvSourcePar"][name]`` so they are adjoint inputs, else
in the option's ``parameters``. Cells are selected with smooth (tanh)
masks, differentiable in the actuator's position and size.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops.core import clip, maximum


def _smooth_mask(x, eps):
    """1 for x<0, 0 for x>0, smooth over width eps."""
    return 0.5 * (1.0 - torch.tanh(x / maximum(eps, 1e-12)))


def _unit(v):
    return v / maximum(torch.linalg.norm(v), 1e-12)


def actuator_disk(geom, params, cfg):
    """Goldstein-distribution actuator disk (reference
    DAFvSourceActuatorDisk): thrust distributed over an annular disk.

    params (10): [cx, cy, cz, dirx, diry, dirz, innerR, outerR, thickness,
    scale]
    """
    center = params[0:3]
    direction = _unit(params[3:6])
    r_in, r_out, thick, scale = params[6], params[7], params[8], params[9]

    d = geom.cc - center
    ax = d @ direction                      # axial coordinate
    rad = torch.sqrt(maximum((d * d).sum(dim=-1) - ax ** 2, 1e-30))

    eps = cfg.get("smoothness", 0.05) * maximum(r_out, 1e-12)
    m_ax = _smooth_mask(torch.abs(ax) - 0.5 * thick, eps)
    m_r = _smooth_mask(rad - r_out, eps) * _smooth_mask(r_in - rad, eps)
    # Goldstein eta(r~) = r~ sqrt(1 - r~); the clip keeps sqrt' finite
    rt = clip((rad - r_in) / maximum(r_out - r_in, 1e-12), 0.0, 1.0 - 1e-9)
    w = m_ax * m_r * rt * torch.sqrt(1.0 - rt)
    # the volume integral of the source equals `scale` (total thrust)
    w = w / maximum(torch.sum(w * geom.vol), 1e-30)
    return scale * w[:, None] * direction[None, :]


def actuator_point(geom, params, cfg):
    """Smoothed point force (reference DAFvSourceActuatorPoint):
    params [cx, cy, cz, fx, fy, fz, radius]."""
    center, force, rad = params[0:3], params[3:6], params[6]
    d2 = ((geom.cc - center) ** 2).sum(dim=-1)
    w = torch.exp(-d2 / maximum(rad ** 2, 1e-30))
    w = w / maximum(torch.sum(w * geom.vol), 1e-30)
    return w[:, None] * force[None, :]


def actuator_line(geom, params, cfg):
    """Rotating-line force smeared with a Gaussian kernel (reference
    DAFvSourceActuatorLine, azimuthally averaged steady form): params
    [cx, cy, cz, axx, axy, axz, radius, eps, fAxial, fTangential]."""
    center = params[0:3]
    axis = _unit(params[3:6])
    radius, eps, f_ax, f_tan = params[6], params[7], params[8], params[9]
    d = geom.cc - center
    ax = d @ axis
    radial = d - ax[:, None] * axis[None, :]
    rad = torch.sqrt(maximum((radial * radial).sum(dim=-1), 1e-30))
    w = torch.exp(-(ax / eps) ** 2) * torch.exp(-((rad - radius) / eps) ** 2)
    w = w / maximum(torch.sum(w * geom.vol), 1e-30)
    tang = torch.linalg.cross(torch.broadcast_to(axis, radial.shape),
                              radial) / rad[:, None]
    return w[:, None] * (f_ax * axis[None, :] + f_tan * tang)


def heat_source(geom, params, cfg):
    """Volumetric heat source in a cylinder (reference
    DAFvSourceHeatSource): params [cx, cy, cz, axx, axy, axz, radius,
    length, power] -> (nc,)."""
    center = params[0:3]
    axis = _unit(params[3:6])
    radius, length, power = params[6], params[7], params[8]
    d = geom.cc - center
    ax = d @ axis
    rad = torch.sqrt(maximum((d * d).sum(dim=-1) - ax ** 2, 1e-30))
    eps = cfg.get("smoothness", 0.05) * radius
    m = _smooth_mask(torch.abs(ax) - 0.5 * length, eps) \
        * _smooth_mask(rad - radius, eps)
    return power * m / maximum(torch.sum(m * geom.vol), 1e-30)


def uniform_pressure_gradient(geom, params, cfg):
    """Constant momentum source (reference
    DAFvSourceUniformPressureGradient): params = gradP vector (3,)."""
    return torch.broadcast_to(params[0:3], (geom.cc.shape[0], 3))


_REGISTRY = {
    "actuatorDisk": actuator_disk,
    "actuatorPoint": actuator_point,
    "actuatorLine": actuator_line,
    "heatSource": heat_source,
    "uniformPressureGradient": uniform_pressure_gradient,
}


def _sources(option, inputs, geom, heat):
    total = None
    for name, cfg in option.get("fvSource", {}).items():
        if (cfg["type"] == "heatSource") != heat:
            continue
        params = inputs["params"].get("fvSourcePar", {}).get(name)
        if params is None:
            params = torch.as_tensor(cfg["parameters"], dtype=geom.vol.dtype,
                                     device=geom.vol.device)
        src = _REGISTRY[cfg["type"]](geom, params, cfg)
        total = src if total is None else total + src
    return total


def compute_fv_source(option, inputs, geom):
    """Total momentum source (nc,3) of every configured non-heat fvSource
    entry (None without one). Parameters: inputs.params.fvSourcePar[name]
    (an adjoint input), else cfg['parameters']."""
    return _sources(option, inputs, geom, heat=False)


def compute_heat_source(option, inputs, geom):
    """Total volumetric heat source (nc,) of the heatSource entries."""
    return _sources(option, inputs, geom, heat=True)
