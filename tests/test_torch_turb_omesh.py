"""kOmegaSST on the 32x12 NACA0012 O-mesh, the setup of chip_smoke.py's
full-width phase 8 at test size, in both face layouts (f64, CPU):
residual-form totals dCD/dnu and dCD/dpoints at a fixed unconverged state
(30 SIMPLE iterations from the farfield values).

The port solves its adjoint tightly (FGMRES to rel 1e-12, one cycle,
segregated PC; ~840 and ~860 iterations, ~25 s each; neither the state,
another PC nor a start from the other layout's psi cuts that: the psi of
the two layouts differ by 1% in a direction that moves no total, and the
system is that close to singular there). dafoam_tpu then takes the port's
psi on the same state, on the canonical layout for both of the port's
layouts (one compilation): psi must solve dafoam_tpu's own adjoint system
D_W dR/dW^T psi = D_W dJ/dW (to rel 1e-6, see PSI_BAR), and dafoam_tpu's
totals from it must match the port's at rel 1e-8 (dCD/dnu, ||dCD/dpoints||
as the golden cases compare it, dCD/dk_far). dafoam_tpu's own FGMRES is
not run: it would add ~840 iterations and a ~25 s compilation, and in
this stiff case the two packages' operators differ by rounding far above
the solve's 1e-12 (PSI_BAR), so a tight psi is tight in its own operator
only; the totals are what both must agree on.

The case as chip_smoke.py runs it: k farfield inletOutlet at 1.5 (0.05
|U_inf|)^2, omega farfield inletOutlet at k_inf / (3 nu) (nut_inf = 3 nu,
like the SA case's nuTilda_inf), wall k 1e-10 and wall omega at Menter's
10 * 6 nu / (beta1 d1^2), d1 the smallest first-cell wall distance.
dafoam_tpu's KOmegaSST assembles grad(k) and grad(omega) without the face
flux and so raises on an inletOutlet k/omega patch; the JAX side here runs
it with the flux passed (``_JaxSSTWithFlux``, put in place only while its
solver is built), which is what the port does.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cases import (NU, assert_close, from_layout, jax_solver,
                              naca_options, to_numpy, torch_solver)

# Elementwise dCD/dpoints is not compared: on the symmetric airfoil at
# zero incidence the points on the symmetry line sit on kinks (equal
# neighbouring values under |x| and max), whose one-sided derivatives the
# packages and layouts pick by rounding (opposite signs of 4e-4 at one
# point here); the norm is unaffected.

torch.set_num_threads(1)
KINF = 1.5 * (0.05 * 1.0) ** 2
WINF = KINF / (3.0 * NU)
BETA1 = 0.075


def sst_naca_options(layout, d1, **over):
    opts = naca_options(layout, turbulenceModel="kOmegaSST", **over)
    bcs = opts["boundaryConditions"]
    del bcs["nuTilda"]
    bcs["k"] = {"far": {"type": "inletOutlet", "value": KINF},
                "wing": {"type": "fixedValue", "value": 1e-10}}
    bcs["omega"] = {"far": {"type": "inletOutlet", "value": WINF},
                    "wing": {"type": "fixedValue",
                             "value": 10.0 * 6.0 * NU / (BETA1 * d1 ** 2)}}
    opts["initialFields"] = {"U": [1.0, 0.0, 0.0], "p": 0.0, "k": KINF,
                             "omega": WINF}
    opts["normalizeStates"] = {"U": 1.0, "p": 0.5, "phi": 1.0, "k": KINF,
                               "omega": WINF}
    opts["relaxationFactors"] = {"fields": {"p": 0.2},
                                 "equations": {"U": 0.5, "nuTilda": 0.5}}
    return opts


def first_cell_distance():
    """The smallest first-cell wall distance of the port's frozen wall
    distance on the 32x12 O-mesh."""
    s = torch_solver(naca_options("canonical"))
    return float(s.wall_dist.min())


@contextlib.contextmanager
def jax_sst_with_flux():
    from dafoam_tpu.models import _TURB_REGISTRY
    from dafoam_tpu.models.komega_sst import KOmegaSST
    from dafoam_tpu.ops import bc, fvc

    class _JaxSSTWithFlux(KOmegaSST):
        def _grads(self, state, inputs, geom):
            topo = self.topo
            phi_b = state["phi"][topo.n_internal:]
            bk = bc.coeffs(self.bc_spec_k, inputs["bc"].get("k", {}), topo,
                           geom, state["k"], rank=0, phi_b=phi_b)
            bw = bc.coeffs(self.bc_spec_w, inputs["bc"].get("omega", {}),
                           topo, geom, state["omega"], rank=0, phi_b=phi_b)
            return (fvc.grad(geom, topo, state["k"],
                             bc.boundary_value(bk, state["k"], topo)),
                    fvc.grad(geom, topo, state["omega"],
                             bc.boundary_value(bw, state["omega"], topo)))

    old = _TURB_REGISTRY["kOmegaSST"]
    _TURB_REGISTRY["kOmegaSST"] = _JaxSSTWithFlux
    try:
        yield
    finally:
        _TURB_REGISTRY["kOmegaSST"] = old


# The wall omega (~4e6) makes the omega/k wall rows differences of ~1e10
# terms: the same psi gives dafoam_tpu's residual 2.7e-13 of ||b|| when
# evaluated op by op and 3.5e-7 when compiled (dense layout, measured on
# the CPU), the rounding of that cancellation. The port's psi is held to
# 1e-6 of ||b|| in dafoam_tpu's compiled operator; the totals, which do
# not see that rounding, to 1e-8.
PSI_BAR = 1e-6
ADJ = {"gmresRelTol": 1e-12, "gmresRestart": 2000, "gmresMaxIters": 2000,
       "gmresAbsTol": 1e-30, "pcType": "segregated"}


@pytest.fixture(scope="module")
def port_runs():
    """{layout: (solver, inputs, state, psi, info, totals)} of the port."""
    d1 = first_cell_distance()
    out = {}
    for layout in ("canonical", "diaDense"):
        s = torch_solver(sst_naca_options(
            layout, d1, primalMinIters=30, primalMaxIters=30,
            primalMinResTol=0.0, adjEqnOption=dict(ADJ)))
        x = s.make_inputs()
        w, info = s.run_primal(s.init_state(), x)
        assert info.iters == 30 and not info.failed, info
        psi, ai = s.solve_adjoint(w, x, "CD")
        assert ai.converged, ai
        tot = s.total_derivative(w, x, "CD", psi)
        out[layout] = (s, x, w, psi, ai, tot)
    return d1, out


@pytest.fixture(scope="module")
def jax_check(port_runs):
    """dafoam_tpu's canonical-layout solver and one compiled check, shared
    by both layouts (the dense layout's state and psi are carried to the
    canonical faces; its zero-area padding faces, whose phi rows are the
    identity and reach no other row and no total, drop out)."""
    d1, _ = port_runs
    with jax_sst_with_flux():
        js = jax_solver(sst_naca_options("canonical", d1,
                                         adjEqnOption=dict(ADJ)))
    jin = js.make_inputs()

    @jax.jit
    def check(w_, psi_):
        from dafoam_tpu.adjoint import solver as jadj
        func = lambda ww, xx: js.eval_function("CD", ww, xx)  # noqa: E731
        dJdW = jax.grad(lambda ww: func(ww, jin))(w_)
        _, f_vjp = jax.vjp(lambda ww: js._norm_residuals(ww, jin), w_)
        (g,) = f_vjp(psi_)
        sc = js.state_scales(js.geometry(jin))
        r = {k: sc[k] * (dJdW[k] - g[k]) for k in g}
        b = {k: sc[k] * dJdW[k] for k in g}
        tot = jadj.total_derivative(js._norm_residuals, func, w_, jin, psi_)
        return r, b, tot

    return check


@pytest.mark.parametrize("layout", ["canonical", "diaDense"])
def test_sst_omesh_totals_match_jax(port_runs, jax_check, layout):
    d1, runs = port_runs
    s, x, w, psi, ai, tot = runs[layout]
    assert ai.converged, ai
    wj = {k: jnp.asarray(v) for k, v in from_layout(w, s.topo).items()}
    pj = {k: jnp.asarray(v) for k, v in from_layout(psi, s.topo).items()}
    r, b, jtot = jax_check(wj, pj)
    r = to_numpy(r)
    rn = np.sqrt(sum(float(np.sum(v ** 2)) for v in r.values()))
    bn = np.sqrt(sum(float(jnp.sum(v ** 2)) for v in b.values()))
    assert rn <= PSI_BAR * bn, (rn, bn)
    jtot = to_numpy(jtot)
    got = {"nu": float(tot["params"]["nu"]),
           "points": float(torch.linalg.norm(tot["points"])),
           "k_far": float(tot["bc"]["k"]["far"])}
    want = {"nu": float(jtot["params"]["nu"]),
            "points": float(np.linalg.norm(jtot["points"])),
            "k_far": float(jtot["bc"]["k"]["far"])}
    for key in want:
        assert abs(got[key] - want[key]) <= 1e-8 * abs(want[key]), \
            (key, got[key], want[key])


def test_sst_omesh_layouts_agree(port_runs):
    """The two layouts' totals agree with each other (their states differ
    only by the layouts' summation order)."""
    _, runs = port_runs
    tc, td = runs["canonical"][5], runs["diaDense"][5]
    assert_close(td["params"]["nu"], tc["params"]["nu"].numpy(), 1e-8, "nu")
    assert_close(torch.linalg.norm(td["points"]),
                 torch.linalg.norm(tc["points"]).numpy(), 1e-8, "points")
