"""DAPimpleDyMFoam (ALE) in dafoam_tpu_torch against dafoam_tpu (CPU,
f64), on tests/test_pimple_dym.py's plunging 12x6 channel cut to 2 time
steps:

- mesh_phi against dafoam_tpu's at 1e-13; the discrete space conservation
  law (rigid translation keeps every cell volume, so each cell's
  mesh-flux sum vanishes) at 1e-12 of the cell's sum of |mesh_phi|
  (``scl_residual``) on both face layouts, with the dense layout's padded
  faces exactly 0;
- residuals_unsteady_n and one vjp with respect to W, W_old and every
  input (points and dyMeshAmp among them) at a 2%-perturbation of
  dafoam_tpu's step-2 state, at 1e-12, on both face layouts;
- the primal history with pinned Krylov trip counts at 1e-10;
- d(wall force)/d(inputs) by the reverse sweep, both packages with GMRES
  at rel 1e-12, at 1e-8: canonical and unpreconditioned as dafoam_tpu
  runs it, and on the dense layout with the segregated PC assembled on
  each step's geometry, which dafoam_tpu does not have.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.utils import tree
from test_torch_cases import (LAYOUTS, assert_close, from_layout, to_layout,
                              to_numpy)

torch.set_num_threads(1)
F64 = torch.float64
DT = 0.05
KINDS = {"zmin": "empty", "zmax": "empty", "ymin": "wall", "ymax": "wall"}
PINNED = {"pMaxIters": 10, "pRelTol": 0.0, "uMaxIters": 4, "uRelTol": 0.0}
# restart 500 > the 462 unknowns of a step: GMRES without a PC converges
# to rounding (restarted at 200 it stalls near rel 1e-11 at its cap)
ADJ = {"gmresRelTol": 1e-12, "gmresRestart": 500, "gmresMaxIters": 1000,
       "pcType": "none"}


def dym_options(layout="canonical", **over):
    """tests/test_pimple_dym.py:plunging_channel's options, 2 steps."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DAPimpleDyMFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 1e-3},
        "dynamicMesh": {"active": True, "motionType": "translation",
                        "amplitude": 0.02, "frequency": 2.0,
                        "direction": [0.0, 1.0, 0.0],
                        "movingPatches": ["ymin", "ymax"]},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "ymax": {"type": "fixedValue", "value": zero}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": 0.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"U": [1.0, 0.0, 0.0], "p": 0.0},
        "deltaT": DT, "endTime": 2 * DT,
        "pimple": {"nOuterCorrectors": 3, "nCorrectors": 2},
        "primalLinearSolver": PINNED,
        "function": {"wallFx": {"type": "force", "patches": ["ymin"],
                                "directionMode": "fixedDirection",
                                "direction": [1.0, 0.0, 0.0],
                                "scale": 1.0, "timeOp": "average"}},
        "adjEqnOption": ADJ,
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


def jax_solver(opts):
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver
    pts, topo = box_hex_mesh(12, 6, 1, (1.0, 0.2, 0.02), kinds=KINDS)
    return make_solver(opts, topo, pts)


def port_solver(opts):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box_hex_mesh(12, 6, 1, (1.0, 0.2, 0.02), kinds=KINDS)
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's history, totals, mesh flux and the residual + vjp of
    step 2."""
    js = jax_solver(dym_options())
    jin = js.make_inputs()
    _, hist = jax.jit(js.solve_primal_history)(js.init_state(), jin)
    tot, resids = jax.jit(
        lambda h, x: js.solve_unsteady_adjoint(h, x, "wallFx"))(hist, jin)
    assert float(jnp.max(resids)) < 1e-12
    h = to_numpy(hist)
    rng = np.random.default_rng(5)
    W = [{k: a[n] * (1.0 + 0.02 * rng.standard_normal(a[n].shape))
          for k, a in h.items()} for n in (2, 1)]
    v = {k: rng.standard_normal(a.shape) for k, a in W[0].items()}

    @jax.jit
    def res_and_vjp(w, wo, x, vv):
        r, vjp = jax.vjp(
            lambda *a: js.residuals_unsteady_n(a[0], a[1], a[1], a[2], 2),
            w, wo, x)
        return r, vjp(vv)

    rv = to_numpy(res_and_vjp(*[{k: jnp.asarray(a) for k, a in s.items()}
                                for s in W], jin,
                              {k: jnp.asarray(a) for k, a in v.items()}))
    t0, t1 = 0.3 * DT, 1.7 * DT
    mphi = np.asarray(js.mesh_phi(js.points_at(jin, t0),
                                  js.points_at(jin, t1), t1 - t0))
    return js, to_numpy(jin), h, to_numpy(tot), (W, v) + rv, mphi


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_phi_and_scl(jax_case, layout):
    js, jin = jax_case[:2]
    ts = port_solver(dym_options(layout))
    x = convert.inputs_from_numpy(jin, "cpu", F64)
    t0, t1 = 0.3 * DT, 1.7 * DT
    p1 = ts.points_at(x, t1)
    mphi = ts.mesh_phi(ts.points_at(x, t0), p1, t1 - t0)
    assert_close(from_layout({"f": mphi}, ts.topo)["f"], jax_case[5],
                 1e-13, f"{layout} mesh_phi")
    if layout == "diaDense":
        real = np.zeros(ts.topo.n_faces, bool)
        real[ts.topo.face_map_old2new] = True
        assert torch.all(mphi[torch.from_numpy(~real)] == 0.0)
    assert ts.scl_residual(ts.points_at(x, t0), p1, t1 - t0) <= 1e-12


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residuals_and_vjp(jax_case, layout):
    js, jin, _, _, (W, v, r_j, g_j), _ = jax_case
    ts = port_solver(dym_options(layout))
    nf = js.topo.n_faces
    wt = [{k: torch.tensor(a, requires_grad=True)
           for k, a in to_layout(s, ts.topo, nf).items()} for s in W]
    vt = {k: torch.tensor(a) for k, a in to_layout(v, ts.topo, nf).items()}
    xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(),
                   convert.inputs_from_numpy(jin, "cpu", F64))
    r = ts.residuals_unsteady_n(wt[0], wt[1], wt[1], xt, 2)
    got_r = from_layout(r, ts.topo)
    for k in r_j:
        assert_close(got_r[k], r_j[k], 1e-12, f"{layout} R[{k}]")
    keys = sorted(wt[0])
    leaves = [w[k] for w in wt for k in keys] + tree.leaves(xt)
    grads = torch.autograd.grad(sum((r[k] * vt[k]).sum() for k in r),
                                leaves, allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(leaves, grads)]
    n = len(keys)
    gw = [from_layout(dict(zip(keys, grads[i * n:(i + 1) * n])), ts.topo)
          for i in range(2)]
    got = [gw[i][k].reshape(-1) for i in range(2) for k in keys] + \
        [g.reshape(-1).numpy() for g in grads[2 * n:]]
    want = [np.asarray(g_j[i][k]).reshape(-1) for i in range(2)
            for k in keys] + \
        [np.asarray(a).reshape(-1) for a in jax.tree_util.tree_leaves(
            g_j[2])]
    assert_close(np.concatenate(got), np.concatenate(want), 1e-12,
                 f"{layout} vjp")


@pytest.fixture(scope="module", params=LAYOUTS)
def port_case(request, jax_case):
    layout = request.param
    over = {} if layout == "canonical" else \
        {"adjEqnOption": dict(ADJ, pcType="segregated")}
    ts = port_solver(dym_options(layout, **over))
    x = convert.inputs_from_numpy(jax_case[1], "cpu", F64)
    with torch.no_grad():
        _, hist = ts.solve_primal_history(ts.init_state(), x)
    dk.reset_counts()
    tot, resids = ts.solve_unsteady_adjoint(hist, x, "wallFx")
    return layout, ts, hist, tot, resids, dict(dk.COUNTS)


def test_history_pinned(jax_case, port_case):
    layout, ts, hist = port_case[:3]
    # 2 steps x 3 outer correctors: one U solve and 2 p solves each
    assert ts.solve_stats["U"] == [6, 24]
    assert ts.solve_stats["p"] == [12, 120]
    got = from_layout(hist, ts.topo)
    for k, a in jax_case[2].items():
        assert_close(got[k], a, 1e-10, f"{layout} history {k}")


def test_totals_against_jax(jax_case, port_case):
    layout, ts, _, tot, resids, counts = port_case
    assert float(resids.max()) < 1e-12
    want = np.concatenate([np.asarray(a).reshape(-1)
                           for a in tree.leaves(jax_case[3])])
    assert_close(np.concatenate([a.reshape(-1).numpy()
                                 for a in tree.leaves(tot)]),
                 want, 1e-8, f"{layout} totals")
    assert abs(float(tot["params"]["dyMeshAmp"])) > 1e-10
    if layout == "diaDense":
        # the segregated PC's transposed products ran K3a (plain here)
        assert counts["dia_matvec_t_plain"] + \
            counts["dia_matvec_multi_t_plain"] > 0
