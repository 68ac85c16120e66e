"""DARhoPimpleFoam in dafoam_tpu_torch against dafoam_tpu (CPU, f64), on
the heated 12x6 channel of tests/test_schemes_unsteady_comp.py (5
implicit-Euler steps, 20 outer and 3 pressure correctors, timeOp
average of the outlet temperature) with the top wall at 331 K (T_TOP):

- residuals_unsteady and one vjp with respect to W, W_old and every
  input, at a perturbed state of dafoam_tpu's history, at 1e-12, on both
  face layouts (dafoam_tpu's side runs once, on the canonical layout);
- the primal history at 1e-10 (every field on the canonical layout, the
  cell fields on the dense one, whose faces are numbered differently);
- the unsteady totals against dafoam_tpu's at 1e-8, on both layouts.
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
UIN = 50.0
# the top wall 1 K warmer than the bottom one: with both at 330 K the flow
# is mirror-symmetric, neighbouring pressures and temperatures across the
# centreline agree to the last bit, and the limited non-orthogonal
# correction sits on its |x| kink there, where each package's one-sided
# derivative follows its last-ulp rounding of the (zero) correction
T_TOP = 331.0
KINDS = {"zmin": "empty", "zmax": "empty", "ymin": "wall", "ymax": "wall"}


def channel_options(layout="canonical"):
    """tests/test_schemes_unsteady_comp.py:rho_pimple_case's options."""
    return {
        "solverName": "DARhoPimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"mu": 1.8e-5, "Cp": 1004.5, "R": 287.0,
                                "Pr": 0.7},
        "deltaT": 2e-4, "endTime": 1e-3,
        "pimple": {"nOuterCorrectors": 20, "nCorrectors": 3},
        "primalLinearSolver": {"pMaxIters": 400, "pRelTol": 1e-12,
                               "uMaxIters": 200, "uRelTol": 1e-12,
                               "turbMaxIters": 100,
                               "turbRelTol": 1e-11},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [UIN, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]},
                  "ymax": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": 101325.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "T": {"xmin": {"type": "fixedValue", "value": 300.0},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": 330.0},
                  "ymax": {"type": "fixedValue", "value": T_TOP}},
        },
        "initialFields": {"U": [UIN, 0.0, 0.0], "p": 101325.0, "T": 300.0},
        "primalVarBounds": {"UMin": -1000.0, "UMax": 1000.0,
                            "pMin": 20000.0, "pMax": 500000.0,
                            "TMin": 100.0, "TMax": 1000.0},
        "function": {"Tout": {"type": "patchMean", "patches": ["xmax"],
                              "varName": "T", "scale": 1.0,
                              "timeOp": "average",
                              "timeOpFracStart": 0.4}},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 250,
                         "gmresMaxIters": 1500, "pcType": "none"},
        "normalizeStates": {"U": UIN, "p": 101325.0, "T": 300.0,
                            "phi": 1.0},
        "meshFaceLayout": layout,
    }


def jax_solver(layout):
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver
    pts, topo = box_hex_mesh(12, 6, 1, (1.0, 0.1, 0.01), kinds=KINDS)
    return make_solver(channel_options(layout), topo, pts)


def port_solver(layout):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box_hex_mesh(12, 6, 1, (1.0, 0.1, 0.01), kinds=KINDS)
    return make_solver(channel_options(layout), topo, pts, device="cpu",
                       dtype=F64)


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's solver, inputs, history and totals on the canonical
    layout (its inputs are the same on either layout)."""
    js = jax_solver("canonical")
    jin = js.make_inputs()
    _, jhist = jax.jit(js.solve_primal_history)(js.init_state(), jin)
    jtot, _ = js.solve_unsteady_adjoint(jhist, jin, "Tout")
    return to_numpy(jin), to_numpy(jhist), to_numpy(jtot), js


@pytest.fixture(scope="module", params=LAYOUTS)
def port_case(request, jax_case):
    ts = port_solver(request.param)
    tin = convert.inputs_from_numpy(jax_case[0], "cpu", F64)
    dk.reset_counts()
    with torch.no_grad():
        _, hist = ts.solve_primal_history(ts.init_state(), tin)
    return request.param, ts, tin, hist, dict(dk.COUNTS)


@pytest.fixture(scope="module")
def jax_residuals(jax_case):
    """dafoam_tpu's residual and one vjp at steps 3, 2 of its history,
    perturbed, on the canonical layout (one compile; the port's dense
    layout takes them through face_map_old2new)."""
    jin, jhist, _, js = jax_case
    rng = np.random.default_rng(23)
    W = [{k: a[n] * (1.0 + 0.02 * rng.standard_normal(a[n].shape))
          for k, a in jhist.items()} for n in (3, 2)]
    v = {k: rng.standard_normal(a.shape) for k, a in W[0].items()}

    @jax.jit
    def jfun(w, wo, x, vv):
        r, f_vjp = jax.vjp(
            lambda a, b, c: js.residuals_unsteady(a, b, b, c), w, wo, x)
        return r, f_vjp(vv)

    rj, gj = to_numpy(jfun(
        *[{k: jnp.asarray(a) for k, a in s.items()} for s in W], jin,
        {k: jnp.asarray(a) for k, a in v.items()}))
    return js.topo.n_faces, W, v, rj, gj


def test_residuals_unsteady_and_vjp(jax_case, port_case, jax_residuals):
    layout, ts, tin = port_case[:3]
    nf, W, v, rj, gj = jax_residuals
    wt = [{k: torch.tensor(a).requires_grad_()
           for k, a in to_layout(s, ts.topo, nf).items()} for s in W]
    vt = {k: torch.as_tensor(a)
          for k, a in to_layout(v, ts.topo, nf).items()}
    xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(), tin)
    rt = ts.residuals_unsteady(wt[0], wt[1], wt[1], xt)
    keys = sorted(rt)
    leaves = [w[k] for w in wt for k in sorted(w)] + tree.leaves(xt)
    grads = torch.autograd.grad(
        sum((rt[k] * vt[k]).sum() for k in keys), leaves, allow_unused=True)
    got_r = from_layout(rt, ts.topo)
    for k in keys:
        assert_close(got_r[k], np.asarray(rj[k]), 1e-12, f"{layout} R[{k}]")
    want = [np.asarray(g[k]) for g in gj[:2] for k in sorted(g)] + \
        [np.asarray(a) for a in jax.tree_util.tree_leaves(gj[2])]
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, grads)]
    n = len(keys)
    got = [a.reshape(-1) for i in range(2) for a in from_layout(
        dict(zip(sorted(W[0]), got[i * n:(i + 1) * n])), ts.topo).values()] \
        + [g.reshape(-1).numpy() for g in got[2 * n:]]
    assert len(got) == len(want)
    assert_close(np.concatenate(got),
                 np.concatenate([w.reshape(-1) for w in want]), 1e-12,
                 f"{layout} vjp")


def test_history(jax_case, port_case):
    _, jhist = jax_case[:2]
    layout, ts, _, hist, counts = port_case
    assert hist["T"].shape[0] == ts.n_steps + 1 == 6
    assert float(hist["T"][-1].max()) <= T_TOP
    for k, a in jhist.items():
        if k == "phi" and layout != "canonical":
            continue
        assert_close(hist[k], a, 1e-10, f"{layout} history {k}")
    # U solves through K2, T and p solves through K1 (plain on the CPU)
    assert counts["dia_matvec_plain"] > 0
    assert counts["dia_matvec_multi_plain"] > 0
    assert ts.solve_stats["T"][0] == ts.solve_stats["U"][0] == 5 * 20
    assert ts.solve_stats["p"][0] == 5 * 20 * 3


def test_unsteady_totals(jax_case, port_case):
    jtot = jax_case[2]
    layout, ts, tin, hist, _ = port_case
    tot, resids = ts.solve_unsteady_adjoint(hist, tin, "Tout")
    assert resids.shape == (5,)
    assert_close(torch.cat([a.reshape(-1) for a in tree.leaves(tot)]),
                 np.concatenate([np.asarray(b).reshape(-1)
                                 for b in tree.leaves(jtot)]), 1e-8,
                 f"{layout} totals")
    assert_close(tot["bc"]["T"]["ymin"], jtot["bc"]["T"]["ymin"], 1e-8,
                 f"{layout} dTout/dTwall")
