"""DAScalarTransportFoam, DAHeatTransferFoam and DASolidDisplacementFoam of
dafoam_tpu_torch against dafoam_tpu and the golden values (CPU, f64).

- goldens scalar_transport (tests/test_golden.py:_case_scalar_transport)
  and heat_radiation (_case_heat_radiation, the coupled T-G system) on
  both face layouts: objectives at rel 1e-8, totals at rel 1e-6 against
  tests/golden/values.json (the port's scalar-transport adjoint takes the
  default segregated PC, dafoam_tpu's runs unpreconditioned);
- the unsteady scalar transport (implicit Euler) for 5 steps: the port's
  history against dafoam_tpu's step, and the final state against its
  solve_primal, at 1e-10;
- the normalized residuals and one vjp of each solver at a perturbed
  state, against dafoam_tpu at 1e-12 (one jitted JAX function per case
  returns both);
- DASolidDisplacementFoam (tests/test_solid.py's plate): 10 Picard
  iterations at 1e-10 on the banded mesh, where the D solves run
  component-major (K2).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint import solver as tadj
from dafoam_tpu_torch.ops import dia_kernels as dk
from test_torch_cases import LAYOUTS, REPO, assert_close, to_numpy

torch.set_num_threads(1)
F64 = torch.float64
BOX_EMPTY = {"zmin": "empty", "zmax": "empty"}


def golden(name):
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        return json.load(fh)[name]


def box(lib, nx, ny, size, kinds=BOX_EMPTY):
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(nx, ny, 1, size, kinds=kinds)


def make_pair(opts, nx, ny, size, kinds=BOX_EMPTY):
    """(dafoam_tpu solver, the port's solver) on the same box."""
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    pj, tj = box("jax", nx, ny, size, kinds)
    pt, tt = box("torch", nx, ny, size, kinds)
    return jmake(opts, tj, pj), tmake(opts, tt, pt, device="cpu", dtype=F64)


def residual_vjp_pair(js, ts, jin, tin, state, seed=3):
    """The normalized residuals and one vjp of both packages at ``state``
    (numpy dict), with a random cotangent: ((R, vjp) JAX, (R, vjp) port)."""
    v = {k: np.random.default_rng(seed).standard_normal(a.shape)
         for k, a in state.items()}

    @jax.jit
    def jfun(w, vv):
        r, f_vjp = jax.vjp(lambda w_: js._norm_residuals(w_, jin), w)
        return r, f_vjp(vv)[0]

    rj, gj = jfun({k: jnp.asarray(a) for k, a in state.items()},
                  {k: jnp.asarray(a) for k, a in v.items()})
    rt, f_vjp = tadj.vjp(lambda w: ts._norm_residuals(w, tin),
                         convert.state_from_numpy(state, "cpu", F64))
    gt = f_vjp(convert.state_from_numpy(v, "cpu", F64))
    return (to_numpy(rj), to_numpy(gj)), (rt, gt)


def assert_pairs(got, want, rel, what):
    for k in want[0]:
        assert_close(got[0][k], want[0][k], rel, f"{what} R[{k}]")
        assert_close(got[1][k], want[1][k], rel, f"{what} vjp[{k}]")


def perturbed(state, seed=5, amp=0.02):
    rng = np.random.default_rng(seed)
    return {k: np.asarray(a) * (1.0 + amp * rng.standard_normal(
        np.shape(a))) for k, a in state.items()}


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def scalar_options(layout, **over):
    """tests/test_golden.py:_case_scalar_transport."""
    opts = {
        "solverName": "DAScalarTransportFoam",
        "ddtScheme": "steadyState",
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1.0},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": 0.0},
                  "ymax": {"type": "zeroGradient"}},
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"T": 0.0},
        "function": {"TMean": {"type": "patchMean", "patches": ["xmax"],
                               "varName": "T", "scale": 1.0}},
        "normalizeStates": {"T": 1.0},
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresRestart": 60},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


SCALAR_BOX = (8, 6, (1.0, 1.0, 0.1))


def heat_options(layout):
    """tests/test_golden.py:_case_heat_radiation."""
    return {
        "solverName": "DAHeatTransferFoam",
        "transportProperties": {"kappa": 10.0},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1000.0},
                  "xmax": {"type": "fixedValue", "value": 400.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "G": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")},
        },
        "initialFields": {"T": 700.0, "G": 4.0 * 5.67e-8 * 700.0 ** 4},
        "primalMinResTol": 1e-7, "primalMaxIters": 200,
        "function": {"Tm": {"type": "variableVolSum", "varName": "T",
                            "scale": 1.0, "divByTotalVol": 1}},
        "normalizeStates": {"T": 700.0, "G": 5e4},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 200,
                         "gmresMaxIters": 1500, "pcType": "none"},
        "meshFaceLayout": layout,
    }


HEAT_BOX = (10, 6, (1.0, 0.5, 0.05))


def solid_options(**over):
    """tests/test_solid.py:plate, banded layout."""
    opts = {
        "solverName": "DASolidDisplacementFoam",
        "transportProperties": {"E": 2e11, "nuPoisson": 0.3,
                                "rhoSolid": 7854.0},
        "boundaryConditions": {
            "D": {"xmin": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "fixedGradient",
                           "value": [0.0, -1e-4, 0.0]}},
        },
        "initialFields": {"D": [0.0, 0.0, 0.0]},
        "primalMinResTol": 0.0, "primalMaxIters": 10,
        "relaxationFactors": {"fields": {"D": 0.9}, "equations": {}},
        "function": {"vms": {"type": "vonMisesStressKS", "coeffKS": 2e-7,
                             "scale": 1.0}},
        "normalizeStates": {"D": 1e-5},
        "meshFaceLayout": "diaDense",
    }
    opts.update(over)
    return opts


SOLID_BOX = (12, 4, (1.0, 0.2, 0.05))


def scalar_inputs(s):
    x = s.make_inputs()
    x["params"]["U"] = torch.tensor([1.0, 0.2, 0.0], dtype=F64).repeat(
        s.topo.n_cells, 1)
    return x


def port_solver(opts, nx, ny, size):
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box("torch", nx, ny, size)
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _check_golden(got, want):
    for k, w in want.items():
        bar = 1e-6 if k.startswith("d") else 1e-8
        assert abs(got[k] - w) <= bar * abs(w), (k, got[k], w)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_golden_scalar_transport(layout):
    s = port_solver(scalar_options(layout), *SCALAR_BOX)
    x = scalar_inputs(s)
    dk.reset_counts()
    w, info = s.run_primal(s.init_state(), x)
    assert info.converged and not info.failed, info
    psi, ai = s.run_adjoint("TMean", w, x)
    assert ai.converged, ai
    tot = s.run_totals("TMean", w, x, psi)
    assert dk.COUNTS["dia_matvec_plain"] > 0
    # the default segregated PC's transposed products (K3a)
    assert dk.COUNTS["dia_matvec_t_plain"] > 0
    _check_golden({
        "TMean": float(s.run_function("TMean", w, x)),
        "dTMean_dDT": float(tot["params"]["DT"]),
        "dTMean_dTin": float(tot["bc"]["T"]["xmin"]),
        "dTMean_dpoints_norm": float(torch.linalg.norm(tot["points"]))},
        golden("scalar_transport"))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_golden_heat_radiation(layout):
    s = port_solver(heat_options(layout), *HEAT_BOX)
    x = s.make_inputs()
    x["params"]["radiationAbsorptivity"] = torch.tensor(0.5, dtype=F64)
    w, info = s.run_primal(s.init_state(), x)
    assert info.converged and not info.failed, info
    assert set(w) == {"T", "G"}
    psi, ai = s.run_adjoint("Tm", w, x)
    assert ai.converged, ai
    tot = s.run_totals("Tm", w, x, psi)
    _check_golden({
        "Tm": float(s.run_function("Tm", w, x)),
        "dTm_dAbsorptivity": float(tot["params"]["radiationAbsorptivity"]),
        "dTm_dkappa": float(tot["params"]["kappa"])},
        golden("heat_radiation"))


# ---------------------------------------------------------------------------
# unsteady scalar transport
# ---------------------------------------------------------------------------

def test_unsteady_scalar_transport_history():
    from dafoam_tpu.linalg import fvsolve as jfvsolve
    steps, dt = 5, 0.05
    opts = scalar_options("canonical", ddtScheme="Euler", deltaT=dt,
                          endTime=steps * dt)
    js, ts = make_pair(opts, *SCALAR_BOX)
    jin = js.make_inputs()
    jin["params"]["U"] = jnp.tile(jnp.asarray([1.0, 0.2, 0.0]),
                                  (js.topo.n_cells, 1))
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st0 = to_numpy(js.init_state())
    jst, _ = jax.jit(js.solve_primal)(st0, jin)

    # dafoam_tpu's Euler step, one at a time: the rows of its scan history
    @jax.jit
    def jstep(T):
        geom = js.geometry(jin)
        M = js._assemble(T, jin, geom, js._phi(jin, geom))
        v = geom.vol
        M = M._replace(diag=M.diag + v / dt, source=M.source + v / dt * T)
        return jfvsolve.solve(M, T, js.topo, symmetric=False, rel_tol=1e-12,
                              max_iters=1000)[0]

    T, jhist = jnp.asarray(st0["T"]), []
    for _ in range(steps):
        T = jstep(T)
        jhist.append(np.asarray(T))
    tst, tinfo, thist = ts.solve_primal_history(
        convert.state_from_numpy(st0, "cpu", F64), tin)
    assert tinfo.iters == steps and thist.shape == (steps, ts.topo.n_cells)
    assert_close(thist, np.stack(jhist), 1e-10, "T history")
    assert_close(tst["T"], np.asarray(jst["T"]), 1e-10, "T final")
    assert_close(thist[-1], np.asarray(jst["T"]), 1e-10, "last row")

    # the unsteady residual (with T_old) and its vjp, off the solution
    jin["T_old"] = jnp.asarray(jhist[-2])
    tin["T_old"] = torch.tensor(jhist[-2])
    want, got = residual_vjp_pair(js, ts, jin, tin,
                                  perturbed({"T": jhist[-1]}, amp=0.2))
    assert_pairs(got, want, 1e-12, "unsteady")


# ---------------------------------------------------------------------------
# residuals and vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["scalar", "heat"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_residuals_and_vjp(case, layout):
    if case == "scalar":
        js, ts = make_pair(scalar_options(layout), *SCALAR_BOX)
        jin = js.make_inputs()
        jin["params"]["U"] = jnp.tile(jnp.asarray([1.0, 0.2, 0.0]),
                                      (js.topo.n_cells, 1))
    else:
        js, ts = make_pair(heat_options(layout), *HEAT_BOX)
        jin = js.make_inputs()
        jin["params"]["kappa"] = jnp.asarray(
            np.random.default_rng(1).uniform(5.0, 15.0, js.topo.n_cells))
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st = perturbed(to_numpy(js.init_state()), amp=0.2)
    if case == "scalar":
        st["T"] = np.random.default_rng(2).uniform(0.0, 1.0, st["T"].shape)
    want, got = residual_vjp_pair(js, ts, jin, tin, st)
    assert_pairs(got, want, 1e-12, f"{case}/{layout}")


@pytest.fixture(scope="module")
def solid_runs():
    js, ts = make_pair(solid_options(), *SOLID_BOX)
    jin = js.make_inputs()
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    dk.reset_counts()
    tst, tinfo = ts.run_primal(convert.state_from_numpy(st0, "cpu", F64),
                               tin)
    counts = dict(dk.COUNTS)
    return js, ts, jin, tin, to_numpy(jst), jinfo, tst, tinfo, counts


def test_solid_primal(solid_runs):
    js, ts, jin, tin, jst, jinfo, tst, tinfo, counts = solid_runs
    assert int(jinfo.iters) == tinfo.iters == 10
    assert_close(tst["D"], jst["D"], 1e-10, "D")
    assert abs(tinfo.max_res - float(jinfo.max_res)) \
        <= 1e-8 * float(jinfo.max_res)
    # the D solves went component-major through K2's plain version
    from dafoam_tpu_torch.linalg.fvsolve import _component_major_ok
    M = ts._assemble(tst["D"], tin, ts.geometry(tin))
    assert M.diag.shape == (ts.topo.n_cells, 3)
    assert _component_major_ok(M, tst["D"], ts.topo)
    assert counts["dia_matvec_multi_plain"] > 0
    assert counts["dia_matvec_plain"] == 0
    vm_j = float(js.run_function("vms", jst, jin))
    vm_t = float(ts.run_function("vms", tst, tin))
    assert abs(vm_t - vm_j) <= 1e-10 * abs(vm_j)


def test_solid_residuals_and_vjp(solid_runs):
    js, ts, jin, tin, jst, _, _, _, _ = solid_runs
    want, got = residual_vjp_pair(js, ts, jin, tin, perturbed(jst))
    assert_pairs(got, want, 1e-12, "solid")
