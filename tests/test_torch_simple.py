"""The slice as a whole: 20 SIMPLE+SA iterations of the 32x12 NACA0012
case (tests/test_golden.py:_case_naca_sa options, primalMinIters =
primalMaxIters = 20) through dafoam_tpu_torch and dafoam_tpu, from the same
initial state, in each face layout. U, p, phi, nuTilda and CD must agree
to 1e-10 relative to each field's max norm (f64, CPU).

The inner Krylov solves are pinned to fixed trip counts (relTol 0, 10
CG iterations for p, 3 BiCGStab iterations for U and nuTilda). With the
golden tolerances (up to 200/50/50 iterations) one SIMPLE step of either
package from the same state agrees to ~1e-15, but over the first few
steps of the transient the long BiCGStab runs amplify that rounding
difference about 30x per step, to ~4e-9 after 20 steps; the converged
solution is held to the golden CD in test_torch_cases."""

import numpy as np
import pytest
import torch

from dafoam_tpu_torch.convert import (inputs_from_numpy, state_from_numpy,
                                      state_to_numpy)
from dafoam_tpu_torch.ops import dia_kernels as dk
from test_torch_cases import (LAYOUTS, assert_close, jax_solver,
                              naca_options, to_numpy, torch_solver)

torch.set_num_threads(1)
ITERS = 20
PINNED = {"pMaxIters": 10, "pRelTol": 0.0, "uMaxIters": 3, "uRelTol": 0.0,
          "turbMaxIters": 3, "turbRelTol": 0.0}


@pytest.fixture(scope="module", params=LAYOUTS)
def runs(request):
    opts = naca_options(request.param, primalMinIters=ITERS,
                        primalMaxIters=ITERS, primalLinearSolver=PINNED)
    js = jax_solver(opts)
    jin = js.make_inputs()
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    jcd = float(js.run_function("CD", jst, jin))

    ts = torch_solver(opts)
    tin = inputs_from_numpy(to_numpy(jin), "cpu", torch.float64)
    dk.reset_counts()
    tst, tinfo = ts.run_primal(state_from_numpy(st0, "cpu", torch.float64),
                               tin)
    counts = dict(dk.COUNTS)
    tcd = float(ts.run_function("CD", tst, tin))
    return (to_numpy(jst), jinfo, jcd), (state_to_numpy(tst), tinfo, tcd), \
        counts, ts


def test_states_match(runs):
    (jst, jinfo, _), (tst, tinfo, _), _, _ = runs
    assert int(jinfo.iters) == tinfo.iters == ITERS
    assert set(jst) == set(tst) == {"U", "p", "phi", "nuTilda"}
    for k in jst:
        assert_close(tst[k], jst[k], 1e-10, k)
    assert abs(tinfo.max_res - float(jinfo.max_res)) \
        <= 1e-10 * float(jinfo.max_res)


def test_cd_matches(runs):
    (_, _, jcd), (_, _, tcd), _, _ = runs
    assert np.isfinite(tcd)
    assert abs(tcd - jcd) <= 1e-10 * abs(jcd), (tcd, jcd)


def test_solves_ran_through_the_dia_path(runs):
    """Every p/nuTilda Krylov matvec is K1's, every momentum matvec K2's
    (their plain versions here, on the CPU)."""
    _, _, counts, _ = runs
    assert counts["dia_matvec_plain"] > 0
    assert counts["dia_matvec_multi_plain"] > 0
    assert counts["dia_matvec"] == counts["dia_matvec_multi"] == 0


def test_make_solver_refuses_hybrid_and_unknown(runs):
    """unsteadyAdjoint mode "hybrid" (time-spectral) with DASimpleFoam
    raises NotImplementedError and an unknown solver name KeyError, in
    both packages."""
    _, _, _, ts = runs
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver
    hybrid = naca_options("canonical", primalMaxIters=1,
                          unsteadyAdjoint={"mode": "hybrid"})
    unknown = naca_options("canonical", primalMaxIters=1,
                           solverName="DANoSuchFoam")
    for opts, err in ((hybrid, NotImplementedError), (unknown, KeyError)):
        with pytest.raises(err):
            make_solver(opts, ts.topo, ts.points.numpy(), device="cpu",
                        dtype=torch.float64)
        with pytest.raises(err):
            jmake(opts, ts.topo, ts.points.numpy())
