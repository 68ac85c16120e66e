"""Wall functions (high-Re near-wall treatment), differentiable (port of
``dafoam_tpu.models.wallfunctions``).

Reference: DAFoam's nutUSpaldingWallFunctionDF (an AD-safe fork of
OpenFOAM's nutUSpaldingWallFunction): the friction velocity u_tau at each
wall face solves Spalding's unified law of the wall

    y+ = u+ + (1/E) [exp(k u+) - 1 - k u+ - (k u+)^2/2 - (k u+)^3/6]

with u+ = |U_t|/u_tau, y+ = y u_tau / nu, by a FIXED 30-step Newton
iteration: a Python loop of device ops that autograd differentiates step
by step, with no host read. The wall eddy viscosity is then
nut_w = u_tau^2 / (|U_t|/y) - nu >= 0.
"""

from __future__ import annotations

import torch

from dafoam_tpu_torch.ops.core import clip, maximum, minimum

KAPPA = 0.41
E_WALL = 9.8


def spalding_utau(mag_up, y, nu, iters=30):
    """Newton solve for u_tau per wall face; all arguments (nw,) tensors
    (nu may be a 0-d tensor)."""
    mag_up = maximum(mag_up, 1e-12)
    # initial guess: the larger of the viscous and log-law estimates (from
    # below, in the exp-dominated branch, Newton creeps linearly)
    ut_vis = torch.sqrt(nu * mag_up / y)
    re_y = maximum(E_WALL * y * mag_up / nu, 2.0)
    ut_log = KAPPA * mag_up / torch.log(re_y)
    ut = torch.maximum(ut_vis, ut_log)
    for _ in range(int(iters)):
        u = maximum(ut, 1e-12)
        up = mag_up / u
        kup = minimum(KAPPA * up, 50.0)
        ekup = torch.exp(kup)
        f = up + (ekup - 1.0 - kup - kup ** 2 / 2.0 - kup ** 3 / 6.0) \
            / E_WALL - y * u / nu
        dup = -mag_up / u ** 2
        dkup = KAPPA * dup
        df = dup + (ekup * dkup - dkup - kup * dkup
                    - kup ** 2 * dkup / 2.0) / E_WALL - y / nu
        step = f / torch.where(torch.abs(df) > 1e-36, df, -1.0)
        ut = clip(ut - step, 1e-12, 1e6)
    return ut


def spalding_nut_wall(U_cell_tangential_mag, y, nu):
    """nut at the wall face from Spalding's law (>= 0)."""
    ut = spalding_utau(U_cell_tangential_mag, y, nu)
    mag_grad = maximum(U_cell_tangential_mag, 1e-12) / y
    return maximum(ut ** 2 / mag_grad - nu, 0.0)


def omega_wall_value(k_cell, y, nu, beta1=0.075):
    """omegaWallFunction blended value for wall-adjacent cells (Menter):
    omega = sqrt(omega_vis^2 + omega_log^2)."""
    w_vis = 6.0 * nu / (beta1 * y ** 2)
    w_log = torch.sqrt(maximum(k_cell, 1e-16)) / (0.09 ** 0.25 * KAPPA * y)
    return torch.sqrt(w_vis ** 2 + w_log ** 2)
