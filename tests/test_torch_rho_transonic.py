"""DARhoSimpleCFoam and DATurboFoam of dafoam_tpu_torch against dafoam_tpu
(CPU, f64).

- DARhoSimpleCFoam on tests/test_transonic.py's Gaussian-bump channel at
  24x8 (Mach 0.74 inlet): 2 subsonic warm-start iterations then 5
  transonic SIMPLEC iterations at pinned Krylov trip counts, every state
  at rel 1e-10, with the non-symmetric p equation solved by BiCGStab;
  the normalized residuals and one vjp at a perturbed state at 1e-12;
  and the adjoint's transpose solves of that p matrix, which must run the
  transposed product (K3a), not the forward one;
- DATurboFoam on tests/test_turbo_cascade.py's rotating channel: the
  residuals and one vjp with respect to the state and the rotation speed
  omega (inputs.params.MRF.omega) at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from test_torch_cases import assert_close, to_numpy
from test_torch_scalar_heat_solid import (assert_pairs, perturbed,
                                          residual_vjp_pair)

torch.set_num_threads(1)
F64 = torch.float64
PINNED = {"pMaxIters": 2, "pRelTol": 0.0, "uMaxIters": 3, "uRelTol": 0.0,
          "turbMaxIters": 3, "turbRelTol": 0.0}
WARM, ITERS = 2, 5


def transonic_options():
    """test_transonic.make_case's options with pinned trip counts, the
    primal cut to WARM subsonic + ITERS transonic iterations."""
    import test_transonic as tt
    uin = [tt.UIN, 0.0, 0.0]
    return {
        "solverName": "DARhoSimpleCFoam",
        "turbulenceModel": "None",
        "transportProperties": {"mu": 1e-5, "Cp": 1004.5, "R": tt.R,
                                "Pr": 0.7},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": uin},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "slip"}, "ymax": {"type": "slip"}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": tt.P_OUT},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "T": {"xmin": {"type": "fixedValue", "value": tt.T_IN},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"U": uin, "p": tt.P_OUT, "T": tt.T_IN},
        "primalMinResTol": 0.0,
        "primalMinIters": ITERS, "primalMaxIters": ITERS,
        "transonicInitRelTol": 0.0, "transonicInitMaxIters": WARM,
        "primalLinearSolver": dict(PINNED),
        "primalVarBounds": {"pMin": 1e3, "TMin": 50.0},
        "relaxationFactors": {"fields": {"p": 0.3, "rho": 0.05},
                              "equations": {"U": 0.7, "T": 0.7,
                                            "p": 0.5}},
        "function": {"CDp": {"type": "force", "patches": ["ymin"],
                             "directionMode": "fixedDirection",
                             "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 1500,
                         "gmresMaxIters": 1500, "gmresAbsTol": 1e-16,
                         "pcType": "segregated"},
        "normalizeStates": {"U": tt.UIN, "p": tt.P_OUT, "T": tt.T_IN,
                            "phi": 1.0},
        "meshFaceLayout": "diaDense",
    }


@pytest.fixture(scope="module")
def transonic_runs():
    import test_transonic as tt
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    pts, topo_j = tt.bump_channel(nx=24, ny=8)
    _, topo_t = _torch_box(24, 8)
    opts = transonic_options()
    js = jmake(opts, topo_j, pts)
    ts = tmake(opts, topo_t, pts, device="cpu", dtype=F64)
    jin = js.make_inputs()
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    dk.reset_counts()
    ts.solve_stats.clear()
    tst, tinfo = ts.run_primal(convert.state_from_numpy(st0, "cpu", F64),
                               tin)
    counts = dict(dk.COUNTS)
    return js, ts, jin, tin, to_numpy(jst), jinfo, tst, tinfo, counts


def _torch_box(nx, ny):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(nx, ny, 1, (3.0, 1.0, 0.05),
                        kinds={"zmin": "empty", "zmax": "empty",
                               "ymin": "wall", "ymax": "wall"})


def test_transonic_iterations(transonic_runs):
    js, ts, jin, tin, jst, jinfo, tst, tinfo, counts = transonic_runs
    assert int(jinfo.iters) == tinfo.iters == WARM + ITERS
    for k in jst:
        assert_close(tst[k], jst[k], 1e-10, k)
    assert abs(tinfo.max_res - float(jinfo.max_res)) \
        <= 1e-10 * float(jinfo.max_res)
    # the last p solve was the non-symmetric transonic one (BiCGStab)
    assert ts.last_p_symmetric is False
    assert ts.solve_stats["p"][0] == WARM + ITERS
    assert counts["dia_matvec_plain"] > 0
    assert counts["dia_matvec_multi_plain"] > 0


def test_transonic_residuals_and_vjp(transonic_runs):
    js, ts, jin, tin, jst, _, _, _, _ = transonic_runs
    want, got = residual_vjp_pair(js, ts, jin, tin, perturbed(jst, amp=0.01))
    assert_pairs(got, want, 1e-12, "transonic")


def test_transonic_p_transpose_solve(transonic_runs):
    """The adjoint PC's p block and the implicit rule's transpose solve of
    the transonic p equation run the transposed product (K3a): with
    symmetric=True they would run the forward one and give a wrong
    adjoint, not an error."""
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    _, ts, _, tin, jst, _, tst, _, _ = transonic_runs
    geom = ts.geometry(tin)
    with torch.no_grad():
        mats = ts._pc_matrices(tst, tin, geom)
    pM, sym = mats["p"]
    assert sym is False
    up, lo = pM.upper, pM.lower
    assert float((up - lo).abs().max()) > 1e-3 * float(up.abs().max())
    # d(x)/d(rhs) of one p solve: lambda = A^-T ct by the implicit rule
    rhs = torch.randn(ts.topo.n_cells, dtype=F64,
                      generator=torch.Generator().manual_seed(1)) \
        .requires_grad_()
    dk.reset_counts()
    x, _ = fvsolve.solve(pM, tst["p"], ts.topo, symmetric=False,
                         rel_tol=1e-12, max_iters=400, rhs=rhs)
    ct = torch.randn_like(x)
    (lam,) = torch.autograd.grad(x, rhs, ct)
    assert dk.COUNTS["dia_matvec_t_plain"] > 0
    A_T_lam = fvx.matvec(fvx.FvMatrix(pM.diag, pM.upper, pM.lower,
                                      pM.source), lam, ts.topo)
    assert_close(A_T_lam, ct.numpy(), 1e-8, "A^T lambda")


def test_turbo_residuals_and_vjp_with_omega():
    import test_turbo_cascade as tc
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    # test_turbo_cascade.make_case on the dense layout: one dafoam_tpu
    # solver, not one per layout
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tc, "make_solver", lambda o, topo, pts: jmake(
            dict(o, meshFaceLayout="diaDense"), topo, pts))
        js, jin = tc.make_case()
    pts, _ = tc.channel_mesh()
    opts = dict(js.option.all, meshFaceLayout="diaDense")
    jin = dict(jin, points=js.points)
    _, topo_t = _torch_box_turbo()
    ts = tmake(opts, topo_t, pts, device="cpu", dtype=F64)
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st = perturbed(to_numpy(js.init_state()), amp=0.05)
    rng = np.random.default_rng(4)
    v = {k: rng.standard_normal(a.shape) for k, a in st.items()}

    @jax.jit
    def jfun(w, om, vv):
        def f(w_, om_):
            x = dict(jin, params=dict(jin["params"], MRF={"omega": om_}))
            return js._norm_residuals(w_, x)
        r, f_vjp = jax.vjp(f, w, om)
        return r, f_vjp(vv)

    om0 = jin["params"]["MRF"]["omega"]
    rj, (gw, gom) = jfun({k: jnp.asarray(a) for k, a in st.items()}, om0,
                         {k: jnp.asarray(a) for k, a in v.items()})
    om_t = tin["params"]["MRF"]["omega"].clone().requires_grad_()
    wt = {k: torch.tensor(a).requires_grad_() for k, a in st.items()}
    xt = dict(tin, params=dict(tin["params"], MRF={"omega": om_t}))
    rt = ts._norm_residuals(wt, xt)
    keys = sorted(rt)
    grads = torch.autograd.grad(
        sum((rt[k] * torch.as_tensor(v[k])).sum() for k in keys),
        [wt[k] for k in keys] + [om_t])
    for i, k in enumerate(keys):
        assert_close(rt[k], np.asarray(rj[k]), 1e-12, f"R[{k}]")
        assert_close(grads[i], np.asarray(gw[k]), 1e-12, f"vjp[{k}]")
    assert_close(grads[-1], np.asarray(gom), 1e-12, "d/domega")
    assert abs(float(np.asarray(gom))) > 0.0


def _torch_box_turbo():
    from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(24, 8, 1, (1.0, 1.0, 1.0),
                        kinds={"zmin": "empty", "zmax": "empty",
                               "ymin": "wall", "ymax": "wall"})
