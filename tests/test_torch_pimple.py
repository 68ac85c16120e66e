"""DAPimpleFoam, its time-accurate adjoint and timeOp in dafoam_tpu_torch
against dafoam_tpu (CPU, f64), on the 8x8 lid-driven cavity of
tests/test_pimple_unsteady.py (Re 10, 5 Euler steps, timeOp average):

- time_op in every mode: its value and its weights (the gradient that
  seeds the reverse sweep) at 1e-12;
- residuals_unsteady and one vjp with respect to W, W_old, W_oldold and
  every input, Euler and BDF2, at perturbed states of dafoam_tpu's
  history, at 1e-12, on both face layouts;
- one PIMPLE time step with pinned Krylov trip counts (every inner solve
  runs its full budget) at 1e-10, on both face layouts (dafoam_tpu's side
  of both runs once, on the canonical layout; the port's dense faces
  carried by face_map_old2new);
- golden pimple_unsteady through the port on both layouts: lidF_avg at
  1e-8, dlidF/dnu and ||dlidF/dpoints|| at 1e-6 against
  tests/golden/values.json, each times max(1, |golden|) as
  tests/test_golden.py holds them, the sweep's residuals under 1e-9; J
  against dafoam_tpu's at 1e-10 and the totals at 1e-8 (dafoam_tpu runs
  the golden's canonical, unpreconditioned sweep; the port the segregated
  PC, without which the dense layout's sweep stops at its iteration cap);
- the port's sweep on dafoam_tpu's history (convert.history_from_numpy)
  gives dafoam_tpu's totals at 1e-8;
- the checkpointed sweep (seg_len 1 canonical, 5 dense) equals the
  in-memory one at 1e-10, and the amortized PC (PCMatUpdateInterval 2)
  gives the per-step PC's totals at 1e-8;
- BDF2 (ddtScheme backward, Euler bootstrap): the history and the totals
  against dafoam_tpu's at 1e-8.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.timeops import dfscaling, time_op
from dafoam_tpu_torch.utils import tree
from test_torch_cases import (LAYOUTS, REPO, assert_close, from_layout,
                              to_layout, to_numpy)

torch.set_num_threads(1)
F64 = torch.float64
SEGREGATED = {"gmresRelTol": 1e-11, "gmresRestart": 200,
              "gmresMaxIters": 1000, "pcType": "segregated"}
WALLS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall", "ymax": "wall"}


def cavity_options(layout="canonical", **over):
    """tests/test_pimple_unsteady.py:cavity_unsteady's options."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DAPimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "deltaT": 0.02, "endTime": 0.1,
        "pimple": {"nOuterCorrectors": 12, "nCorrectors": 2},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {k: {"type": "zeroGradient"}
                  for k in ("xmin", "xmax", "ymin", "ymax")},
        },
        "initialFields": {"U": zero, "p": 0.0},
        "primalLinearSolver": {"pMaxIters": 400, "pRelTol": 1e-12,
                               "uMaxIters": 200, "uRelTol": 1e-12},
        "function": {
            "lidF": {"type": "force", "patches": ["ymax"],
                     "directionMode": "fixedDirection",
                     "direction": [1.0, 0.0, 0.0], "scale": 1.0,
                     "timeOp": "average", "timeOpFracStart": 0.4},
        },
        "adjEqnOption": {"gmresRelTol": 1e-11, "gmresRestart": 200,
                         "gmresMaxIters": 1000, "pcType": "none"},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


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


def assert_totals(got, want, rel, what):
    """Every leaf of the input-shaped totals as one vector, max-abs
    relative to the largest (the small wall-BC leaves cancel to ~0)."""
    assert_close(torch.cat([a.reshape(-1) for a in tree.leaves(got)]),
                 np.concatenate([np.asarray(b).reshape(-1)
                                 for b in tree.leaves(want)]), rel, what)


def golden():
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        return json.load(fh)["pimple_unsteady"]


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's Euler primal history, J and totals on the canonical
    layout (the golden's), unpreconditioned as the golden runs: one
    compile each."""
    js = jax_solver(cavity_options())
    jin = js.make_inputs()
    _, jhist = jax.jit(js.solve_primal_history)(js.init_state(), jin)
    jJ, _ = js.eval_function_history("lidF", jhist, jin)
    jtot, _ = js.solve_unsteady_adjoint(jhist, jin, "lidF")
    return js, jin, to_numpy(jhist), float(jJ), to_numpy(jtot)


@pytest.fixture(scope="module", params=LAYOUTS)
def port_case(request):
    """The port's primal history, J and in-memory totals on one layout,
    with the segregated PC (unpreconditioned, the dense layout's sweep
    stalls at the 1000-iteration cap)."""
    layout = request.param
    ts = port_solver(cavity_options(layout, adjEqnOption=SEGREGATED))
    x = ts.make_inputs()
    dk.reset_counts()
    with torch.no_grad():
        stT, hist = ts.solve_primal_history(ts.init_state(), x)
        J, vals = ts.eval_function_history("lidF", hist, x)
    counts = dict(dk.COUNTS)
    tot, resids = ts.solve_unsteady_adjoint(hist, x, "lidF")
    return layout, ts, x, hist, float(J), tot, resids, counts


# ---------------------------------------------------------------------------
# timeOp
# ---------------------------------------------------------------------------

TIME_OPS = {"final": ("final", {}),
            "average": ("average", {"timeOpFracStart": 0.4}),
            "maxKS": ("max", {"coeffKS": 5.0}),
            "maxPlain": ("max", {"timeOpMaxMode": "plain"})}


@pytest.mark.parametrize("name", sorted(TIME_OPS))
def test_time_op(name):
    from dafoam_tpu.timeops import time_op as jtime_op
    mode, cfg = TIME_OPS[name]
    vals = np.random.default_rng(5).standard_normal(7)
    jv = jtime_op(jnp.asarray(vals), mode, cfg)
    jw = jax.grad(lambda v: jtime_op(v, mode, cfg))(jnp.asarray(vals))
    tv = torch.tensor(vals)
    assert_close(time_op(tv, mode, cfg), np.asarray(jv), 1e-12, name)
    assert_close(dfscaling(tv, mode, cfg), np.asarray(jw), 1e-12,
                 f"{name} weights")


# ---------------------------------------------------------------------------
# residual and vjp
# ---------------------------------------------------------------------------

PINNED = {"pMaxIters": 6, "pRelTol": 0.0, "uMaxIters": 3, "uRelTol": 0.0}


@pytest.fixture(scope="module")
def jax_products(jax_case):
    """dafoam_tpu on the canonical layout, one compile each: the residual
    of step 3 and one vjp for each ddt scheme, at steps 3, 2, 1 of its
    history perturbed by 2%, and one pinned step 3 from its step-2 state.
    The port's layouts take them through face_map_old2new."""
    jin, jhist = jax_case[1], jax_case[2]
    rng = np.random.default_rng(17)
    W = [{k: a[n] * (1.0 + 0.02 * rng.standard_normal(a[n].shape))
          for k, a in jhist.items()} for n in (3, 2, 1)]
    v = {k: rng.standard_normal(a.shape) for k, a in W[0].items()}
    res = {}
    for scheme in ("Euler", "backward"):
        js = jax_solver(cavity_options(ddtScheme=scheme))

        @jax.jit
        def jfun(w, wo, woo, x, vv):
            r, f_vjp = jax.vjp(
                lambda *a: js.residuals_unsteady(*a, n=3), w, wo, woo, x)
            return r, f_vjp(vv)

        res[scheme] = to_numpy(jfun(
            *[{k: jnp.asarray(a) for k, a in s.items()} for s in W], jin,
            {k: jnp.asarray(a) for k, a in v.items()}))
    js = jax_solver(cavity_options(
        primalLinearSolver=PINNED,
        pimple={"nOuterCorrectors": 4, "nCorrectors": 2}))
    W2 = {k: a[2] for k, a in jhist.items()}
    geom_j = js.geometry(jin)
    step = to_numpy(jax.jit(lambda w: js._step(w, jin, geom_j,
                                               t=jnp.asarray(3 * js.dt)))(
        {k: jnp.asarray(a) for k, a in W2.items()}))
    return js.topo.n_faces, to_numpy(jin), W, v, res, W2, step


@pytest.mark.parametrize("scheme", ["Euler", "backward"])
def test_residuals_unsteady_and_vjp(port_case, jax_products, scheme):
    """At steps 3, 2, 1 of dafoam_tpu's history, perturbed."""
    layout = port_case[0]
    nf, jin, W, v, res, _, _ = jax_products
    rj, gj = res[scheme]
    ts = port_solver(cavity_options(layout, ddtScheme=scheme))
    tin = convert.inputs_from_numpy(jin, "cpu", F64)
    wt = [{k: torch.tensor(a).requires_grad_()
           for k, a in to_layout(s, ts.topo, nf).items()} for s in W]
    vt = {k: torch.as_tensor(a)
          for k, a in to_layout(v, ts.topo, nf).items()}
    xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(), tin)
    rt = ts.residuals_unsteady(*wt, xt, n=3)
    keys = sorted(rt)
    leaves = [w[k] for w in wt for k in sorted(w)] + tree.leaves(xt)
    grads = torch.autograd.grad(
        sum((rt[k] * vt[k]).sum() for k in keys), leaves,
        allow_unused=True)
    got_r = from_layout(rt, ts.topo)
    for k in keys:
        assert_close(got_r[k], np.asarray(rj[k]), 1e-12, f"{scheme} R[{k}]")
    want = [np.asarray(g[k]) for g in gj[:3] for k in sorted(g)] + \
        [np.asarray(a) for a in jax.tree_util.tree_leaves(gj[3])]
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(leaves, grads)]
    n = len(keys)
    got = [a.reshape(-1) for i in range(3) for a in from_layout(
        dict(zip(sorted(W[0]), got[i * n:(i + 1) * n])), ts.topo).values()] \
        + [g.reshape(-1).numpy() for g in got[3 * n:]]
    assert len(got) == len(want)
    assert_close(np.concatenate(got),
                 np.concatenate([w.reshape(-1) for w in want]), 1e-12,
                 f"{scheme} vjp")


# ---------------------------------------------------------------------------
# one time step, pinned
# ---------------------------------------------------------------------------

def test_step_pinned(port_case, jax_products):
    """Step 3 from dafoam_tpu's step-2 state, with every inner solve at its
    full budget (rel_tol 0): 4 outer correctors, U 3 BiCGStab and p 6 CG
    iterations per solve."""
    layout = port_case[0]
    nf, jin, _, _, _, W2, jst = jax_products
    opts = cavity_options(layout, primalLinearSolver=PINNED,
                          pimple={"nOuterCorrectors": 4, "nCorrectors": 2})
    ts = port_solver(opts)
    tin = convert.inputs_from_numpy(jin, "cpu", F64)
    with torch.no_grad():
        tst = ts._step(convert.state_from_numpy(to_layout(W2, ts.topo, nf),
                                                "cpu", F64),
                       tin, ts.geometry(tin), t=3 * ts.dt)
    assert ts.solve_stats["U"] == [4, 12]
    assert ts.solve_stats["p"] == [8, 48]
    got = from_layout(tst, ts.topo)
    for k in jst:
        assert_close(got[k], jst[k], 1e-10, f"{layout} step {k}")


# ---------------------------------------------------------------------------
# golden and the reverse sweep
# ---------------------------------------------------------------------------

def test_golden_pimple(jax_case, port_case):
    _, _, _, jJ, jtot = jax_case
    layout, ts, x, hist, J, tot, resids, counts = port_case
    want = golden()
    got = {"lidF_avg": J, "dlidF_dnu": float(tot["params"]["nu"]),
           "dlidF_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    for k, w in want.items():
        # tests/test_golden.py's bar: rel x max(1, |golden|)
        tol = (1e-6 if k.startswith("d") else 1e-8) * max(1.0, abs(w))
        assert abs(got[k] - w) <= tol, (layout, k, got[k], w)
    assert float(resids.max()) < 1e-9
    assert resids.shape == (ts.n_steps,)
    assert hist["U"].shape[0] == ts.n_steps + 1
    # against dafoam_tpu: J, and the totals (layout-independent leaves)
    assert abs(J - jJ) <= 1e-10 * abs(jJ), (J, jJ)
    assert_totals(tot, jtot, 1e-8, f"{layout} totals")
    # U solves through K2, p solves through K1, the PC's transposed block
    # products through K3a (plain versions on the CPU)
    assert counts["dia_matvec_plain"] > 0
    assert counts["dia_matvec_multi_plain"] > 0


def test_sweep_on_jax_history(jax_case):
    """The port's reverse sweep on dafoam_tpu's history, carried over by
    convert.history_from_numpy, gives dafoam_tpu's totals."""
    _, jin, jhist, _, jtot = jax_case
    ts = port_solver(cavity_options(adjEqnOption=SEGREGATED))
    hist = convert.history_from_numpy(jhist, "cpu", F64)
    back = convert.history_to_numpy(hist)
    for k in jhist:
        np.testing.assert_array_equal(back[k], jhist[k])
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    tot, resids = ts.solve_unsteady_adjoint(hist, tin, "lidF")
    assert float(resids.max()) < 1e-9
    assert_totals(tot, jtot, 1e-8, "totals")


def test_checkpointed_matches_inmemory(port_case):
    """seg_len 1 on the canonical layout, 5 on the dense one."""
    layout, ts, x, hist, J, tot, _, _ = port_case
    seg_len = 1 if layout == "canonical" else 5
    tot1, resids, J1 = ts.solve_unsteady_adjoint_checkpointed(
        ts.init_state(), x, "lidF", seg_len=seg_len)
    assert abs(J1 - J) <= 1e-12 * abs(J)
    assert resids.shape == (ts.n_steps,)
    assert_totals(tot1, tree.tmap(torch.Tensor.numpy, tot), 1e-10,
                  f"seg_len {seg_len}")


def test_amortized_pc(port_case):
    """Segregated PC rebuilt every second reverse step (the reference's
    PCMatPrecomputeInterval): the totals of the per-step PC."""
    layout, ts, x, hist, J, tot, _, _ = port_case
    ts.option.set("unsteadyAdjoint.PCMatUpdateInterval", 2)
    try:
        dk.reset_counts()
        tot1, resids = ts.solve_unsteady_adjoint(hist, x, "lidF")
        counts = dict(dk.COUNTS)
    finally:
        ts.option.set("unsteadyAdjoint.PCMatUpdateInterval", 1)
    assert float(resids.max()) < 1e-10
    assert_totals(tot1, tree.tmap(torch.Tensor.numpy, tot), 1e-8,
                  f"{layout} totals")
    # the PC's transposed block products ran K3a (plain on the CPU)
    assert counts["dia_matvec_t_plain"] + \
        counts["dia_matvec_multi_t_plain"] > 0


def test_bdf2_against_jax(jax_case):
    """Canonical layout, dafoam_tpu unpreconditioned, the port with the
    segregated PC."""
    jin = jax_case[1]
    js = jax_solver(cavity_options(ddtScheme="backward"))
    ts = port_solver(cavity_options(ddtScheme="backward",
                                    adjEqnOption=SEGREGATED))
    assert js.ddt_order == ts.ddt_order == 2
    _, jhist = jax.jit(js.solve_primal_history)(js.init_state(), jin)
    jtot, _ = js.solve_unsteady_adjoint(jhist, jin, "lidF")
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    with torch.no_grad():
        _, hist = ts.solve_primal_history(ts.init_state(), tin)
    for k, a in to_numpy(jhist).items():
        assert_close(hist[k], a, 1e-8, f"BDF2 history {k}")
    tot, resids = ts.solve_unsteady_adjoint(hist, tin, "lidF")
    assert float(resids.max()) < 1e-9
    assert_totals(tot, to_numpy(jtot), 1e-8, "BDF2 totals")
    with pytest.raises(NotImplementedError):
        ts.solve_unsteady_adjoint_checkpointed(ts.init_state(), tin, "lidF",
                                               seg_len=5)
