"""The time-spectral ("hybrid") scalar solver in dafoam_tpu_torch against
dafoam_tpu (CPU, f64), on tests/test_time_spectral.py:_case (10x6 box,
N = 5 instances, a multiFreqScalar inlet, KS-max objective):

- spectral_derivative_matrix at 1e-14, and its odd-N check;
- make_solver: "hybrid" selects DATimeSpectralScalarFoam for
  DAScalarTransportFoam, as in dafoam_tpu;
- three block Gauss-Seidel sweeps from the initial state, with the inner
  tolerance set to dafoam_tpu's hard-coded 1e-12 / 2000
  (primalLinearSolver turbRelTol / turbMaxIters), so that both packages
  run the same Krylov iterations: the instances at 1e-10;
- the stacked residual and one vjp (state and every input) at a
  2%-perturbation of that state, at 1e-12, on both face layouts (one
  dafoam_tpu evaluation on the canonical layout: the states are cell
  fields);
- at dafoam_tpu's state after the three sweeps: J at 1e-10 and the
  adjoint totals at 1e-8, both packages with GMRES at rel 1e-12 and no
  PC; with the segregated PC the port's totals agree at 1e-8 too. (The
  adjoint equation and the totals are defined at any state; converging
  the primal would cost 264 sweeps in each package.)

dafoam_tpu runs jitted, in one module fixture (three compiles: the
sweeps, J with its adjoint and totals, the residual vjp); its eager path
costs seconds per call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.solvers.time_spectral import (
    DATimeSpectralScalarFoam, spectral_derivative_matrix)
from dafoam_tpu_torch.utils import tree
from test_torch_cases import LAYOUTS, assert_close, to_numpy

torch.set_num_threads(1)
F64 = torch.float64
PERIOD = 2.0
KINDS = {"zmin": "empty", "zmax": "empty"}
PINNED = {"primalMaxIters": 3, "primalMinResTol": 0.0}


def ts_options(layout="canonical", **over):
    """tests/test_time_spectral.py:_case's options, with the inner solve
    tolerance that dafoam_tpu hard-codes."""
    opts = {
        "solverName": "DAScalarTransportFoam",
        "unsteadyAdjoint": {"mode": "hybrid", "nTimeInstances": 5,
                            "periodicity": PERIOD},
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "multiFreqScalar", "refValue": 1.0,
                           "amplitudes": [0.6],
                           "frequencies": [1.0 / PERIOD], "phases": [0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"T": 1.0},
        "primalMinResTol": 1e-11,
        "primalMaxIters": 500,
        "primalLinearSolver": {"turbRelTol": 1e-12, "turbMaxIters": 2000},
        "function": {"TMean": {"type": "variableVolSum", "varName": "T",
                               "scale": 1.0, "timeOp": "max",
                               "timeOpMaxMode": "KS", "coeffKS": 50.0}},
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresRestart": 200,
                         "gmresMaxIters": 400, "gmresAbsTol": 1e-30,
                         "pcType": "none"},
        "normalizeStates": {"T": 1.0},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


def jax_solver(opts):
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver
    pts, topo = box_hex_mesh(10, 6, 1, (1.0, 0.6, 0.1), kinds=KINDS)
    return make_solver(opts, topo, pts)


def port_solver(opts):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box_hex_mesh(10, 6, 1, (1.0, 0.6, 0.1), kinds=KINDS)
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


def make_pair(opts):
    return jax_solver(opts), port_solver(opts)


def frozen_u(inputs, n_cells, like):
    """The frozen convecting velocity (0.4, 0, 0) of _case."""
    u = np.tile([0.4, 0.0, 0.0], (n_cells, 1))
    inputs["params"]["U"] = like(u)
    return inputs


def perturbed(st, seed):
    rng = np.random.default_rng(seed)
    return {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
            for k, a in st.items()}


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's three sweeps from the initial state, and at that state
    J, the adjoint totals and one residual vjp at a perturbation of it."""
    js = jax_solver(ts_options(**PINNED))
    jin = frozen_u(js.make_inputs(), js.topo.n_cells, jnp.asarray)
    st, info = jax.jit(js.solve_primal)(js.init_state(), jin)

    @jax.jit
    def adjoint(st, x):
        psi, _ = js.solve_adjoint(st, x, "TMean")
        return js.eval_function("TMean", st, x), \
            js.total_derivative(st, x, "TMean", psi)

    @jax.jit
    def res_and_vjp(w, x, vv):
        r, vjp = jax.vjp(js.residuals, w, x)
        return r, vjp(vv)

    J, tot = adjoint(st, jin)
    W = perturbed(to_numpy(st), 3)
    v = {k: np.random.default_rng(4).standard_normal(a.shape)
         for k, a in W.items()}
    res_vjp = (W, v) + to_numpy(res_and_vjp(
        {k: jnp.asarray(a) for k, a in W.items()}, jin,
        {k: jnp.asarray(a) for k, a in v.items()}))
    return js, to_numpy(jin), to_numpy(st), float(J), to_numpy(tot), \
        res_vjp


def port_inputs(jin):
    return convert.inputs_from_numpy(jin, "cpu", F64)


def test_spectral_derivative_matrix():
    from dafoam_tpu.solvers.time_spectral import \
        spectral_derivative_matrix as jsdm
    for n in (3, 5, 9):
        assert_close(torch.tensor(spectral_derivative_matrix(n, PERIOD)),
                     jsdm(n, PERIOD), 1e-14, f"D N={n}")
    with pytest.raises(ValueError):
        spectral_derivative_matrix(4, PERIOD)


def test_hybrid_selects_time_spectral():
    js, ts = make_pair(ts_options())
    assert type(js).__name__ == type(ts).__name__ \
        == "DATimeSpectralScalarFoam"
    assert isinstance(ts, DATimeSpectralScalarFoam)
    assert sorted(ts.init_state()) == [f"T{n}" for n in range(5)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residuals_and_vjp(jax_case, layout):
    jin = jax_case[1]
    W, v, r_j, (gw_j, gx_j) = jax_case[5]

    ts = port_solver(ts_options(layout))
    w = {k: torch.tensor(a, requires_grad=True) for k, a in W.items()}
    x = tree.tmap(lambda a: a.detach().clone().requires_grad_(),
                  port_inputs(jin))
    r = ts.residuals(w, x)
    for k in r:
        assert_close(r[k], np.asarray(r_j[k]), 1e-12, f"{layout} R[{k}]")
    leaves = [w[k] for k in sorted(w)] + tree.leaves(x)
    grads = torch.autograd.grad(
        sum((r[k] * torch.tensor(v[k])).sum() for k in r), leaves,
        allow_unused=True)
    want = [np.asarray(gw_j[k]) for k in sorted(w)] + \
        [np.asarray(a) for a in jax.tree_util.tree_leaves(gx_j)]
    got = [torch.zeros_like(a) if g is None else g
           for a, g in zip(leaves, grads)]
    assert_close(torch.cat([g.reshape(-1) for g in got]),
                 np.concatenate([a.reshape(-1) for a in want]), 1e-12,
                 f"{layout} vjp")


def test_sweeps_pinned(jax_case):
    """Three sweeps from the initial state."""
    _, jin, jst = jax_case[:3]
    ts = port_solver(ts_options(**PINNED))
    st, info = ts.run_primal(ts.init_state(), port_inputs(jin))
    assert info.iters == 3 and not info.failed
    assert ts.solve_stats["T"][0] == 15
    for k, a in jst.items():
        assert_close(st[k], a, 1e-10, f"sweeps {k}")


def test_totals_against_jax(jax_case):
    """At dafoam_tpu's state after three sweeps."""
    _, jin, jst, jJ, jtot = jax_case[:5]
    ts = port_solver(ts_options())
    x = port_inputs(jin)
    st = convert.state_from_numpy(jst, "cpu", F64)
    J = float(ts.run_function("TMean", st, x))
    assert abs(J - jJ) <= 1e-10 * abs(jJ), (J, jJ)
    flat_j = np.concatenate([np.asarray(a).reshape(-1)
                             for a in tree.leaves(jtot)])
    for pc in ("none", "segregated"):
        ts.option.set("adjEqnOption.pcType", pc)
        psi, ai = ts.solve_adjoint(st, x, "TMean")
        assert ai.converged, (pc, ai)
        tot = ts.total_derivative(st, x, "TMean", psi)
        assert_close(torch.cat([a.reshape(-1) for a in tree.leaves(tot)]),
                     flat_j, 1e-8, f"totals, pcType {pc}")
    # the BC amplitude (the design variable of the forcing) is not 0
    assert abs(float(tot["bc"]["T"]["xmin"]["amplitudes"][0])) > 1e-6
