"""The turbulence models of dafoam_tpu_torch against dafoam_tpu: kOmegaSST,
kOmega and kEpsilon here, kOmegaSSTLM and Spalart-Allmaras with Spalding
wall functions in test_torch_turb_lm.py (two files, so that the test
workers share the JAX compilations), all on the 16x8 box channel of
tests/test_sst_channel.py / test_ktwoeq.py / test_wallfunctions.py (f64,
CPU, canonical layout); plus Spalding's u_tau and wall nut.

Per model, from the same initial state:
- 10 SIMPLE iterations at pinned Krylov trip counts, every state at
  rel 1e-10 (norm-relative, as test_torch_cases.assert_close);
- the normalized residuals R and one vjp dR^T v at a 2%-perturbed state of
  those iterations (rel 1e-12);
- one step-map vjp dG^T v from the same state with equation relaxation 1,
  off relax()'s dominance kinks as in test_torch_adjoint.py (rel 1e-10).

The pressure CG is pinned at 2 iterations: with 10 (the SA slice test's
count) the first SIMPLE steps of these channels amplify the packages'
rounding differences ~100x per step (1e-15 after one step, 4e-3 after
ten), with 2 they stay at ~1e-14.

The JAX side of each model is three compiled functions (primal, residual
vjp, step-map vjp; ~5-14 s of compilation each on the CPU), so the
fixtures share them per model.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint import solver as tadj
from dafoam_tpu_torch.ops import dia_kernels as dk
from test_torch_cases import assert_close, to_numpy

torch.set_num_threads(1)
NU = 1e-4
KIN = 3.75e-3
PINNED = {"pMaxIters": 2, "pRelTol": 0.0, "uMaxIters": 3, "uRelTol": 0.0,
          "turbMaxIters": 3, "turbRelTol": 0.0}
ITERS = 10


def channel_options(model, **over):
    """The 16x8 channel with ``model``'s fields: fixedValue inlet, walls
    at ymin/ymax (k 1e-10, omega 15360, epsilon 1.0; SpalartAllmaras:
    nuTilda zeroGradient with nutUSpaldingWallFunction walls)."""
    zero = [0.0, 0.0, 0.0]
    zg = {"type": "zeroGradient"}

    def fv(v):
        return {"type": "fixedValue", "value": v}

    bcs = {"U": {"xmin": fv([1.0, 0.0, 0.0]), "xmax": zg, "ymin": fv(zero),
                 "ymax": fv(zero)},
           "p": {"xmin": zg, "xmax": fv(0.0), "ymin": zg, "ymax": zg}}
    init = {"U": [1.0, 0.0, 0.0], "p": 0.0}
    norm = {"U": 1.0, "p": 0.5, "phi": 1.0}

    def field(name, inlet, wall):
        w = zg if wall is None else fv(wall)
        bcs[name] = {"xmin": fv(inlet), "xmax": zg, "ymin": w, "ymax": w}
        init[name] = norm[name] = inlet

    if model == "SpalartAllmaras":
        field("nuTilda", 50 * NU, None)
        bcs["nut"] = {"ymin": {"type": "nutUSpaldingWallFunction"},
                      "ymax": {"type": "nutUSpaldingWallFunction"}}
    else:
        field("k", KIN, 1e-10)
        if model == "kEpsilon":
            field("epsilon", 0.01, 1.0)
        else:
            field("omega", 60.0, 15360.0)
        if model == "kOmegaSSTLM":
            field("ReThetat", 200.0, None)
            field("gammaInt", 1.0, None)
    opts = {"solverName": "DASimpleFoam", "turbulenceModel": model,
            "transportProperties": {"nu": NU},
            "boundaryConditions": bcs, "initialFields": init,
            "primalMinResTol": 0.0, "primalMinIters": ITERS,
            "primalMaxIters": ITERS, "primalLinearSolver": dict(PINNED),
            "relaxationFactors": {"fields": {"p": 0.2},
                                  "equations": {"U": 0.5, "nuTilda": 0.5}},
            "function": {"drag": {"type": "force",
                                  "patches": ["ymin", "ymax"],
                                  "directionMode": "fixedDirection",
                                  "direction": [1.0, 0.0, 0.0],
                                  "scale": 1.0}},
            "normalizeStates": norm}
    opts.update(over)
    return opts


def step_map_options(model):
    """The step map of the fixed-point adjoint with equation relaxation 1
    and the linear smoothers."""
    return channel_options(
        model, adjEqnSolMethod="fixedPoint",
        adjEqnOption={"fpInnerSmoother": "linear", "fpInnerScale": 1.0},
        relaxationFactors={"fields": {"p": 0.2},
                           "equations": {"U": 1.0, "nuTilda": 1.0}})


def _box(lib):
    kinds = {"zmin": "empty", "zmax": "empty", "ymin": "wall",
             "ymax": "wall"}
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(16, 8, 1, (1.0, 0.1, 0.01), kinds=kinds)


def solvers(opts):
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    pj, tj = _box("jax")
    pt, tt = _box("torch")
    return (jmake(opts, tj, pj),
            tmake(opts, tt, pt, device="cpu", dtype=torch.float64))


def run_model(model):
    """Both packages' results for ``model`` (numpy, the port's launch
    counts of the primal)."""
    js, ts = solvers(channel_options(model))
    jin = js.make_inputs()
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    jst = to_numpy(jst)
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", torch.float64)
    dk.reset_counts()
    tst, tinfo = ts.run_primal(convert.state_from_numpy(st0, "cpu",
                                                        torch.float64), tin)
    counts = dict(dk.COUNTS)

    rng = np.random.default_rng(7)
    st = {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
          for k, a in jst.items()}
    v = {k: rng.standard_normal(a.shape) for k, a in st.items()}
    wj = {k: jnp.asarray(a) for k, a in st.items()}
    vj = {k: jnp.asarray(a) for k, a in v.items()}
    wt = convert.state_from_numpy(st, "cpu", torch.float64)
    vt = convert.state_from_numpy(v, "cpu", torch.float64)

    @jax.jit
    def jres(w, vv):
        r, f_vjp = jax.vjp(lambda w_: js._norm_residuals(w_, jin), w)
        return r, f_vjp(vv)[0], js.turb.nu_eff_faces(w, jin,
                                                       js.geometry(jin))

    rj, gj, nej = jres(wj, vj)
    rt, f_vjp = tadj.vjp(lambda w: ts._norm_residuals(w, tin), wt)
    gt = f_vjp(vt)
    with torch.no_grad():
        net = ts.turb.nu_eff_faces(wt, tin, ts.geometry(tin))

    js2, ts2 = solvers(step_map_options(model))
    sj, stp = js2._fp_step_fn(), ts2._fp_step_fn()

    @jax.jit
    def jstep(w, vv):
        _, f = jax.vjp(lambda w_: sj(w_, jin)[0], w)
        return f(vv)[0]

    pj = jstep(wj, vj)
    _, f_vjp = tadj.vjp(lambda w: stp(w, tin)[0], wt)
    pt = f_vjp(vt)
    return SimpleNamespace(
        jst=jst, jinfo=jinfo, tst=convert.state_to_numpy(tst), tinfo=tinfo,
        counts=counts, rj=to_numpy(rj), gj=to_numpy(gj), rt=rt, gt=gt,
        nej=to_numpy(nej), net=net, wall_fn=ts.turb._wf_mask, nu=NU,
        pj=to_numpy(pj), pt=pt, model_states=ts.turb.model_states)


@pytest.fixture(scope="module", params=("kOmegaSST", "kOmega", "kEpsilon"))
def runs(request):
    return run_model(request.param)


def check_simple_iterations(r):
    assert int(r.jinfo.iters) == r.tinfo.iters == ITERS
    assert set(r.tst) == set(r.jst) == {"U", "p", "phi", *r.model_states}
    for k in r.jst:
        assert_close(r.tst[k], r.jst[k], 1e-10, k)
    assert abs(r.tinfo.max_res - float(r.jinfo.max_res)) \
        <= 1e-10 * float(r.jinfo.max_res)
    # every model solve ran K1 (its plain version here), U ran K2
    assert r.counts["dia_matvec_plain"] > 0
    assert r.counts["dia_matvec_multi_plain"] > 0


def check_residuals(r):
    assert set(r.rt) == set(r.rj)
    for k in r.rj:
        assert_close(r.rt[k], r.rj[k], 1e-12, f"R {k}")
        assert_close(r.gt[k], r.gj[k], 1e-12, f"dR^T v {k}")
    # nu + nut on the faces, in the cells and on the boundary faces; the
    # boundary nut is zero at low-Re walls and Spalding's value at
    # nutUSpaldingWallFunction walls
    for got, want, what in zip(r.net, r.nej, ("faces", "cells", "boundary")):
        assert_close(got, want, 1e-12, f"nu_eff {what}")
    if r.wall_fn is not None:
        assert (r.net[2].numpy()[r.wall_fn > 0.5] > r.nu).all()


def check_step_map(r):
    for k in r.pj:
        assert_close(r.pt[k], r.pj[k], 1e-10, f"dG^T v {k}")


def test_simple_iterations_match(runs):
    check_simple_iterations(runs)


def test_residuals_and_vjp_match(runs):
    check_residuals(runs)


def test_step_map_vjp_matches(runs):
    check_step_map(runs)


def test_spalding_matches_jax():
    """u_tau, nut_wall and their reverse derivatives in |U_t| and y across
    the viscous, buffer and log layers (rel 1e-12)."""
    from dafoam_tpu.models import wallfunctions as jwf
    from dafoam_tpu_torch.models import wallfunctions as twf
    rng = np.random.default_rng(5)
    mag = 10.0 ** rng.uniform(-3, 1, 64)
    y = 10.0 ** rng.uniform(-5, -1, 64)
    ct = rng.standard_normal(64)
    nu = 1e-4

    def jfun(m, yy):
        return jwf.spalding_utau(m, yy, nu), jwf.spalding_nut_wall(m, yy, nu)

    (ju, jn), f_vjp = jax.vjp(jfun, jnp.asarray(mag), jnp.asarray(y))
    jgu = f_vjp((jnp.asarray(ct), jnp.zeros(64)))
    jgn = f_vjp((jnp.zeros(64), jnp.asarray(ct)))

    m_t = torch.tensor(mag, requires_grad=True)
    y_t = torch.tensor(y, requires_grad=True)
    nu_t = torch.tensor(nu, dtype=torch.float64)
    tu = twf.spalding_utau(m_t, y_t, nu_t)
    tn = twf.spalding_nut_wall(m_t, y_t, nu_t)
    ctt = torch.tensor(ct)
    tgu = torch.autograd.grad(tu, (m_t, y_t), ctt, retain_graph=True)
    tgn = torch.autograd.grad(tn, (m_t, y_t), ctt)
    assert_close(tu, ju, 1e-12, "u_tau")
    assert_close(tn, jn, 1e-12, "nut_wall")
    for a, b, what in zip(tgu + tgn, jgu + jgn,
                          ("du/dU", "du/dy", "dnut/dU", "dnut/dy")):
        assert_close(a, b, 1e-12, what)
    # the law itself: y+ = u+ + (exp(k u+) - 1 - ...)/E at the solution
    up = mag / tu.detach().numpy()
    ku = 0.41 * up
    yplus = y * tu.detach().numpy() / nu
    law = up + (np.exp(ku) - 1 - ku - ku ** 2 / 2 - ku ** 3 / 6) / 9.8
    assert np.allclose(law, yplus, rtol=1e-9)
    w = twf.omega_wall_value(torch.tensor(ct ** 2), torch.tensor(y), nu_t)
    assert_close(w, jwf.omega_wall_value(ct ** 2, y, nu), 1e-14, "omega_w")
