"""DAIrkPimpleFoam (Radau IIA(2,3)) in dafoam_tpu_torch against dafoam_tpu
(CPU, f64), on tests/test_irk_pimple.py's 8x8 lid-driven cavity cut to 2
time steps of 2 sweeps:

- the doubled state layout (U, U1, p, p1, phi, phi1): sizes and offsets
  as dafoam_tpu's, and convert carries the state both ways exactly;
- the Radau rows D1, D2;
- residuals_unsteady (both collocation rows) and one vjp with respect to
  W, W_old and every input, at a 2%-perturbation of dafoam_tpu's step-2
  state, at 1e-12, on both face layouts (one dafoam_tpu evaluation on the
  canonical layout; face fields carried by face_map_old2new);
- the primal history with pinned Krylov trip counts (every inner solve
  runs its full budget) at 1e-10;
- the totals of the in-memory reverse sweep with the two-stage segregated
  PC, both packages with GMRES at rel 1e-12, at 1e-8, on both face
  layouts (the PC's transposed block products ran K3a, plain on the
  CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.solvers.irk_pimple import DAIrkPimpleFoam
from dafoam_tpu_torch.utils import tree
from test_torch_cases import (LAYOUTS, assert_close, from_layout, to_layout,
                              to_numpy)

torch.set_num_threads(1)
F64 = torch.float64
WALLS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall", "ymax": "wall"}
# every inner solve at its full budget: both packages do the same work
PINNED = {"pMaxIters": 8, "pRelTol": 0.0, "uMaxIters": 4, "uRelTol": 0.0}
ADJ = {"gmresRelTol": 1e-12, "gmresRestart": 300, "gmresMaxIters": 3000,
       "pcType": "segregated", "pcInnerIters": 15}


def irk_options(layout="canonical"):
    """tests/test_irk_pimple.py:cavity's options, 2 steps of 2 sweeps."""
    zero = [0.0, 0.0, 0.0]
    return {
        "solverName": "DAIrkPimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "deltaT": 0.02, "endTime": 0.04,
        "pimple": {"nOuterCorrectors": 1, "nCorrectors": 2},
        "irk": {"maxSweeps": 2},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")},
        },
        "initialFields": {"U": zero, "p": 0.0},
        "primalLinearSolver": PINNED,
        "function": {
            "lidF": {"type": "force", "patches": ["ymax"],
                     "directionMode": "fixedDirection",
                     "direction": [1.0, 0.0, 0.0], "scale": 1.0,
                     "timeOp": "final"},
        },
        "adjEqnOption": ADJ,
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": layout,
    }


def jax_solver(opts):
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver
    pts, topo = box_hex_mesh(8, 8, 1, (0.1, 0.1, 0.01), kinds=WALLS)
    return make_solver(opts, topo, pts)


def port_solver(opts):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box_hex_mesh(8, 8, 1, (0.1, 0.1, 0.01), kinds=WALLS)
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


def flat(tot):
    return np.concatenate([np.asarray(a).reshape(-1)
                           for a in tree.leaves(tot)])


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's history, totals, and residual + vjp at step 2."""
    js = jax_solver(irk_options())
    jin = js.make_inputs()
    _, hist = jax.jit(js.solve_primal_history)(js.init_state(), jin)
    tot, resids = jax.jit(
        lambda h, x: js.solve_unsteady_adjoint(h, x, "lidF"))(hist, jin)
    assert float(jnp.max(resids)) < 1e-12
    h = to_numpy(hist)
    rng = np.random.default_rng(11)
    W = [{k: a[n] * (1.0 + 0.02 * rng.standard_normal(a[n].shape))
          for k, a in h.items()} for n in (2, 1)]
    v = {k: rng.standard_normal(a.shape) for k, a in W[0].items()}

    @jax.jit
    def res_and_vjp(w, wo, x, vv):
        r, vjp = jax.vjp(
            lambda *a: js.residuals_unsteady(a[0], a[1], a[1], a[2], n=2),
            w, wo, x)
        return r, vjp(vv)

    rv = to_numpy(res_and_vjp(*[{k: jnp.asarray(a) for k, a in s.items()}
                                for s in W], jin,
                              {k: jnp.asarray(a) for k, a in v.items()}))
    return js, to_numpy(jin), h, to_numpy(tot), (W, v) + rv


def test_state_layout_and_convert(jax_case):
    js = jax_case[0]
    ts = port_solver(irk_options())
    assert isinstance(ts, DAIrkPimpleFoam)
    assert ts.state_info == type(ts.state_info)(
        **{f: getattr(js.state_info, f) for f in
           ("vol_vector", "vol_scalar", "model", "surface_scalar")})
    assert ts.layout.sizes == js.layout.sizes
    assert ts.layout.offsets == js.layout.offsets
    assert ts.layout.n_states == js.layout.n_states
    hist = jax_case[2]
    st = {k: a[-1] for k, a in hist.items()}
    back = convert.state_to_numpy(convert.state_from_numpy(st, "cpu", F64))
    for k, a in st.items():
        np.testing.assert_array_equal(back[k], a)
    vec = ts.layout.pack(convert.state_from_numpy(st, "cpu", F64))
    np.testing.assert_array_equal(
        vec.numpy(), np.asarray(js.layout.pack(
            {k: jnp.asarray(a) for k, a in st.items()})))
    assert ts.D1 == js.D1 and ts.D2 == js.D2


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residuals_and_vjp(jax_case, layout):
    js, jin, _, _, (W, v, r_j, g_j) = jax_case
    ts = port_solver(irk_options(layout))
    nf = js.topo.n_faces
    wt = [{k: torch.tensor(a, requires_grad=True)
           for k, a in to_layout(s, ts.topo, nf).items()} for s in W]
    vt = {k: torch.tensor(a) for k, a in to_layout(v, ts.topo, nf).items()}
    xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(),
                   convert.inputs_from_numpy(jin, "cpu", F64))
    r = ts.residuals_unsteady(wt[0], wt[1], wt[1], xt, n=2)
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
    ts = port_solver(irk_options(layout))
    x = convert.inputs_from_numpy(jax_case[1], "cpu", F64)
    with torch.no_grad():
        _, hist = ts.solve_primal_history(ts.init_state(), x)
    dk.reset_counts()
    tot, resids = ts.solve_unsteady_adjoint(hist, x, "lidF")
    return layout, ts, hist, tot, resids, dict(dk.COUNTS)


def test_history_pinned(jax_case, port_case):
    layout, ts, hist = port_case[:3]
    # per step: 2 sweeps x 2 stages, one U solve and 2 p solves each
    assert ts.solve_stats["U"] == [8, 32]
    assert ts.solve_stats["p"] == [16, 128]
    got = from_layout(hist, ts.topo)
    for k, a in jax_case[2].items():
        assert_close(got[k], a, 1e-10, f"{layout} history {k}")


def test_totals_against_jax(jax_case, port_case):
    layout, ts, _, tot, resids, counts = port_case
    assert float(resids.max()) < 1e-12
    assert_close(np.concatenate([a.reshape(-1).numpy()
                                 for a in tree.leaves(tot)]),
                 flat(jax_case[3]), 1e-8, f"{layout} totals")
    assert abs(float(tot["params"]["nu"])) > 1e-6
    # the two-stage PC's transposed block products ran K3a (plain here)
    assert counts["dia_matvec_t_plain"] + \
        counts["dia_matvec_multi_t_plain"] > 0
