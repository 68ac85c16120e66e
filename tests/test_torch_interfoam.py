"""DAInterFoam (VoF with MULES) in dafoam_tpu_torch against dafoam_tpu
(CPU, f64), on tests/test_interfoam.py's 12x8 dam break cut to 2 time
steps:

- alpha_update, the mixture (rho, mu) of its result, and one vjp (alpha,
  phi, U and every input) at the dam break's initial state, at 1e-12, on
  both face layouts. There phi == 0 on every face and alpha is exactly 0
  or 1, so |phi|, the limiter's max/min pairs and the mixture's clip all
  sit on their kinks. The limiter's kinks reach the vjp only times the
  antidiffusive flux, which is 0 there; the clip's do not, so a clip
  with torch.clamp's tie rule fails here (and in the residual vjp and
  the totals below);
- residuals_unsteady (the explicit alpha row among them) and one vjp with
  respect to W, W_old and every input, at a 2%-perturbation of
  dafoam_tpu's step-2 state, at 1e-12, on both face layouts;
- the primal history with pinned Krylov trip counts at 1e-10, the water
  volume conserved;
- d(p_rgh on the right wall)/d(inputs) by the reverse sweep (the alpha
  chain and the mixture momentum and pressure), both packages
  unpreconditioned with GMRES at rel 1e-12 (which floors near 1e-10 here,
  under tests/test_interfoam.py's 1e-9), at 1e-8; on the dense layout
  with the two-phase segregated PC too.
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
DT = 0.002
KINDS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall"}
PINNED = {"pMaxIters": 12, "pRelTol": 0.0, "uMaxIters": 4, "uRelTol": 0.0}
# restart 1000 > the unknowns of a step: GMRES without a PC needs no
# restart
ADJ = {"gmresRelTol": 1e-12, "gmresRestart": 1000, "gmresMaxIters": 2000,
       "pcType": "none"}


def dam_options(layout="canonical", **over):
    """tests/test_interfoam.py:dam_break's options, 2 steps of 2 outer
    correctors."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DAInterFoam",
        "transportProperties": {"rho1": 1000.0, "rho2": 1.0,
                                "nu1": 1e-6, "nu2": 1.48e-5,
                                "cAlpha": 1.0},
        "g": [0.0, -9.81, 0.0],
        "deltaT": DT, "endTime": 2 * DT,
        "pimple": {"nOuterCorrectors": 2, "nCorrectors": 2},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "ymax": {"type": "zeroGradient"}},
            "p_rgh": {"xmin": {"type": "zeroGradient"},
                      "xmax": {"type": "zeroGradient"},
                      "ymin": {"type": "zeroGradient"},
                      "ymax": {"type": "fixedValue", "value": 0.0}},
            "alpha": {"xmin": {"type": "zeroGradient"},
                      "xmax": {"type": "zeroGradient"},
                      "ymin": {"type": "zeroGradient"},
                      "ymax": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": zero, "p_rgh": 0.0, "alpha": 0.0},
        "primalLinearSolver": PINNED,
        "function": {
            "pRight": {"type": "patchMean", "patches": ["xmax"],
                       "varName": "p_rgh", "scale": 1.0,
                       "timeOp": "average"},
        },
        "adjEqnOption": ADJ,
        "normalizeStates": {"U": 1.0, "p_rgh": 100.0, "phi": 1.0,
                            "alpha": 1.0},
        "normalizeResiduals": ["URes", "p_rghRes", "phiRes", "alphaRes"],
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


def jax_solver(opts):
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver
    pts, topo = box_hex_mesh(12, 8, 1, (0.6, 0.4, 0.02), kinds=KINDS)
    return make_solver(opts, topo, pts)


def port_solver(opts):
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = box_hex_mesh(12, 8, 1, (0.6, 0.4, 0.02), kinds=KINDS)
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


def water_column(solver):
    """alpha = 1 in the cells with centres at x < 0.2, y < 0.2."""
    cc = np.asarray(solver.geometry(solver.make_inputs()).cc)
    return ((cc[:, 0] < 0.2) & (cc[:, 1] < 0.2)).astype(float)


def initial_state(solver, like):
    st = solver.init_state()
    st["alpha"] = like(water_column(solver))
    return st


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's history and totals, alpha_update + vjp at the initial
    state, residuals + vjp at step 2."""
    js = jax_solver(dam_options())
    jin = js.make_inputs()
    st0 = initial_state(js, jnp.asarray)
    _, hist = jax.jit(js.solve_primal_history)(st0, jin)
    tot, resids = jax.jit(
        lambda h, x: js.solve_unsteady_adjoint(h, x, "pRight"))(hist, jin)
    # tests/test_interfoam.py's bar: this sweep's FGMRES floor is ~1e-10
    assert float(jnp.max(resids)) < 1e-9
    rng = np.random.default_rng(9)

    @jax.jit
    def alpha_and_vjp(a, phi, U, x, va):
        def f(a, phi, U, x):
            an, aphi = js.alpha_update(a, phi, U, x, js.geometry(x))
            return (an, aphi) + js._mixture(an, x)
        out, vjp = jax.vjp(f, a, phi, U, x)
        return out, vjp((va[0], jnp.zeros_like(out[1]), va[1], va[2]))

    va = rng.standard_normal((3, js.topo.n_cells))
    av = (va,) + to_numpy(alpha_and_vjp(st0["alpha"], st0["phi"], st0["U"],
                                        jin, jnp.asarray(va)))
    h = to_numpy(hist)
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
    return js, to_numpy(jin), to_numpy(st0), h, to_numpy(tot), av, \
        (W, v) + rv


@pytest.mark.parametrize("layout", LAYOUTS)
def test_alpha_update_at_tie_state(jax_case, layout):
    js, jin, st0 = jax_case[:3]
    va, (a_j, aphi_j, rho_j, mu_j), (ga, gphi, gU, gx) = jax_case[5]
    ts = port_solver(dam_options(layout))
    nf = js.topo.n_faces
    s = {k: torch.tensor(a, requires_grad=True)
         for k, a in to_layout(st0, ts.topo, nf).items()}
    assert float(torch.max(torch.abs(s["phi"]))) == 0.0
    x = tree.tmap(lambda a: a.detach().clone().requires_grad_(),
                  convert.inputs_from_numpy(jin, "cpu", F64))
    a, aphi = ts.alpha_update(s["alpha"], s["phi"], s["U"], x,
                              ts.geometry(x))
    assert_close(a, a_j, 1e-12, f"{layout} alpha")
    assert_close(from_layout({"f": aphi}, ts.topo)["f"], aphi_j, 1e-12,
                 f"{layout} alphaPhi")
    rho, mu = ts._mixture(a, x)
    assert_close(rho, rho_j, 1e-12, f"{layout} rho")
    assert_close(mu, mu_j, 1e-12, f"{layout} mu")
    xl = tree.leaves(x)
    vt = torch.tensor(va)
    grads = torch.autograd.grad((a * vt[0] + rho * vt[1]
                                 + mu * vt[2]).sum(),
                                [s["alpha"], s["phi"], s["U"]] + xl,
                                allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g
             for w, g in zip([s["alpha"], s["phi"], s["U"]] + xl, grads)]
    got = [grads[0].numpy(),
           from_layout({"f": grads[1]}, ts.topo)["f"], grads[2].numpy()] \
        + [g.numpy() for g in grads[3:]]
    want = [ga, gphi, gU] + [np.asarray(w)
                             for w in jax.tree_util.tree_leaves(gx)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, w, 1e-12, f"{layout} alpha vjp leaf {i}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residuals_and_vjp(jax_case, layout):
    js, jin = jax_case[:2]
    W, v, r_j, g_j = jax_case[6]
    ts = port_solver(dam_options(layout))
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
    over = {} if layout == "canonical" else \
        {"adjEqnOption": dict(ADJ, pcType="segregated")}
    ts = port_solver(dam_options(layout, **over))
    x = convert.inputs_from_numpy(jax_case[1], "cpu", F64)
    st0 = convert.state_from_numpy(
        to_layout(jax_case[2], ts.topo, jax_case[0].topo.n_faces), "cpu",
        F64)
    with torch.no_grad():
        _, hist = ts.solve_primal_history(st0, x)
    dk.reset_counts()
    tot, resids = ts.solve_unsteady_adjoint(hist, x, "pRight")
    return layout, ts, x, hist, tot, resids, dict(dk.COUNTS)


def test_history_pinned(jax_case, port_case):
    layout, ts, x, hist = port_case[:4]
    # 2 steps x 2 outer x 2 correctors, no momentum predictor
    assert ts.solve_stats["p_rgh"] == [8, 96]
    assert "U" not in ts.solve_stats
    got = from_layout(hist, ts.topo)
    for k, a in jax_case[3].items():
        assert_close(got[k], a, 1e-10, f"{layout} history {k}")
    # the flux-form update conserves the water volume (the pinned pressure
    # solves leave phi short of divergence-free, so alpha may leave
    # [0, 1] by ~1e-6 here, in both packages)
    m = (hist["alpha"] * ts.geometry(x).vol).sum(dim=1)
    assert float(torch.max(torch.abs(m / m[0] - 1.0))) < 1e-12


def test_totals_against_jax(jax_case, port_case):
    layout, ts, _, _, tot, resids, counts = port_case
    assert float(resids.max()) < 1e-9
    want = np.concatenate([np.asarray(a).reshape(-1)
                           for a in tree.leaves(jax_case[4])])
    assert_close(np.concatenate([a.reshape(-1).numpy()
                                 for a in tree.leaves(tot)]),
                 want, 1e-8, f"{layout} totals")
    assert abs(float(tot["params"]["rho1"])) > 1e-12
    if layout == "diaDense":
        # the two-phase PC's transposed block products ran K3a (plain)
        assert counts["dia_matvec_t_plain"] + \
            counts["dia_matvec_multi_t_plain"] > 0
