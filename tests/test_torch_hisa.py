"""DAHisaFoam in dafoam_tpu_torch against dafoam_tpu (CPU, f64), on the
bump channel of tests/test_hisa.py at 24x8 (its make_hisa options:
inviscid, AUSMPlusUp, inlet Mach 0.675):

- the residuals and one vjp with respect to the state and every input,
  for each of AUSMPlusUp, JST and laxFriedrichs, inviscid and viscous
  (laminar, mu 0.5), at a perturbed state, at 1e-12, on both face
  layouts (dafoam_tpu's side of these and of the PTC iterations runs once
  per file, on the canonical layout: the states are cell fields);
- _euler_flux_jac, _dQdW_blocks, and one forward and one transposed
  _block_pc application at 1e-12;
- the flow-residual jvp that each PTC GMRES product takes (forward-mode
  AD) against a central difference at 1e-8;
- three PTC iterations (sequenceFlux off, innerRelTol 0, so every GMRES
  runs its 20 iterations) at 1e-10, on both face layouts;
- at dafoam_tpu's converged state, carried across: run_adjoint/run_totals
  against dafoam_tpu's at 1e-8, against the port's
  forward_total_derivative at 1e-6, and dCDp/dU_in against a central
  difference of the port's whole pipeline at 2e-4 (as tests/test_hisa.py
  does; each perturbed primal warm-starts from the converged state with
  sequenceFlux off, CFL 1e8 (plain Newton) and no minimum iteration
  count, to stay inside the file's time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint import solver as tadj
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.utils import tree
from test_torch_cases import LAYOUTS, assert_close, to_numpy

torch.set_num_threads(1)
F64 = torch.float64
MACH_IN, T_IN, P_OUT, R, GAMMA = 0.675, 300.0, 1.0e5, 287.0, 1.4
UIN = MACH_IN * float(np.sqrt(GAMMA * R * T_IN))
NX, NY = 24, 8


def bump_channel(lib):
    """tests/test_hisa.py:bump_channel at NX x NY."""
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    pts, topo = box_hex_mesh(NX, NY, 1, (3.0, 1.0, 0.05),
                             kinds={"zmin": "empty", "zmax": "empty",
                                    "ymin": "wall", "ymax": "wall"})
    pts = np.asarray(pts).copy()
    x, y = pts[:, 0], pts[:, 1]
    pts[:, 1] = y + 0.06 * np.exp(-((x - 1.5) / 0.4) ** 2) * (1.0 - y)
    return pts, topo


def hisa_options(layout="canonical", hisa=None, **over):
    """tests/test_hisa.py:make_hisa's options."""
    opts = {
        "solverName": "DAHisaFoam",
        "turbulenceModel": "None",
        "hisa": {"inviscid": True, "fluxScheme": "AUSMPlusUp",
                 "cfl": 5.0, "cflMax": 1e4, "innerIters": 240,
                 **(hisa or {})},
        "transportProperties": {"R": R, "gamma": GAMMA},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [UIN, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "slip"}, "ymax": {"type": "slip"}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": P_OUT},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "T": {"xmin": {"type": "fixedValue", "value": T_IN},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"U": [UIN, 0.0, 0.0], "p": P_OUT, "T": T_IN},
        "primalMinResTol": 1e-7,
        "primalMinIters": 10, "primalMaxIters": 300,
        "primalLinearSolver": {"pMaxIters": 50, "pRelTol": 0.05,
                               "uMaxIters": 20, "uRelTol": 0.1,
                               "turbMaxIters": 20, "turbRelTol": 0.1},
        "function": {
            "CDp": {"type": "force", "patches": ["ymin"],
                    "directionMode": "fixedDirection",
                    "direction": [1.0, 0.0, 0.0], "scale": 1.0},
        },
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 300,
                         "gmresMaxIters": 600, "gmresAbsTol": 1e-16,
                         "pcType": "blockJacobian", "pcInnerIters": 12},
        "normalizeStates": {"U": 240.0, "p": 1e5, "T": 300.0},
        "primalVarBounds": {"pMin": 1e3, "TMin": 50.0},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


def port_solver(opts):
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = bump_channel("torch")
    return make_solver(opts, topo, pts, device="cpu", dtype=F64)


def jax_solver(opts):
    from dafoam_tpu.solvers import make_solver
    pts, topo = bump_channel("jax")
    return make_solver(opts, topo, pts)


def make_pair(opts):
    js = jax_solver(opts)
    return js, port_solver(opts), js.make_inputs()


def perturbed_state(js, seed=0):
    """The uniform start with 3% noise and a random cross-flow."""
    rng = np.random.default_rng(seed)
    st = {k: a * (1.0 + 0.03 * rng.standard_normal(a.shape))
          for k, a in to_numpy(js.init_state()).items()}
    st["U"][:, 1] += 5.0 * rng.standard_normal(st["U"].shape[0])
    st["U"][:, 2] = 0.0
    return st


def jnp_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


# ---------------------------------------------------------------------------
# residuals and their vjp
# ---------------------------------------------------------------------------

SCHEMES = ("AUSMPlusUp", "JST", "laxFriedrichs")
# dafoam_tpu's side of the layout-parametrized tests, computed once per
# file on the canonical layout (HiSA's states are cell fields, so the
# port's dense layout compares against the same arrays; dafoam_tpu's
# inputs are the same on either layout)
_JAX = {}


def viscous_options(layout, viscous, **over):
    tp = {"transportProperties": {"R": R, "gamma": GAMMA, "mu": 0.5}} \
        if viscous else {}
    return hisa_options(layout, hisa={"inviscid": not viscous},
                        **tp, **over)


def jax_residuals(viscous):
    """(state, cotangent, [(R, (vjp_W, vjp_x)) per flux scheme], inputs)."""
    if viscous not in _JAX:
        js = jax_solver(viscous_options("canonical", viscous))
        jin = js.make_inputs()
        st = perturbed_state(js)
        rng = np.random.default_rng(9)
        v = {k: rng.standard_normal(a.shape) for k, a in st.items()}

        @jax.jit
        def jfun(w, x, vv):
            out = []
            for sch in SCHEMES:
                r, f_vjp = jax.vjp(
                    lambda w_, x_: js._residuals_geom(
                        w_, x_, js.geometry(x_), scheme=sch), w, x)
                out.append((r, f_vjp(vv)))
            return out

        _JAX[viscous] = (st, v, to_numpy(jfun(jnp_tree(st), jin,
                                              jnp_tree(v))), to_numpy(jin))
    return _JAX[viscous]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("viscous", [False, True],
                         ids=["inviscid", "viscous"])
def test_residuals_and_vjp(layout, viscous):
    ts = port_solver(viscous_options(layout, viscous))
    st, v, jout, jin = jax_residuals(viscous)
    tin = convert.inputs_from_numpy(jin, "cpu", F64)
    for sch, (rj, (gwj, gxj)) in zip(SCHEMES, jout):
        wt = {k: torch.tensor(a).requires_grad_() for k, a in st.items()}
        xt = tree.tmap(lambda a: a.detach().clone().requires_grad_(), tin)
        rt = ts._residuals_geom(wt, xt, ts.geometry(xt), scheme=sch)
        keys = sorted(rt)
        leaves = [wt[k] for k in keys] + tree.leaves(xt)
        grads = torch.autograd.grad(
            sum((rt[k] * torch.as_tensor(v[k])).sum() for k in keys),
            leaves, allow_unused=True)
        what = f"{layout} {sch} viscous={viscous}"
        for k in keys:
            assert_close(rt[k], np.asarray(rj[k]), 1e-12, f"{what} R[{k}]")
        want = [np.asarray(gwj[k]) for k in keys] + \
            [np.asarray(a) for a in jax.tree_util.tree_leaves(gxj)]
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves, grads)]
        assert len(got) == len(want)
        assert_close(torch.cat([g.reshape(-1) for g in got]),
                     np.concatenate([w.reshape(-1) for w in want]), 1e-12,
                     f"{what} vjp")


# ---------------------------------------------------------------------------
# the block preconditioner
# ---------------------------------------------------------------------------

def test_block_pc_parts():
    js, ts, jin = make_pair(hisa_options("diaDense"))
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st = perturbed_state(js, seed=1)
    nc, ni = ts.topo.n_cells, ts.topo.n_internal
    rng = np.random.default_rng(4)
    u = rng.standard_normal((ni, 3)) * 200.0
    s = rng.standard_normal((ni, 3)) * 0.05
    q2 = (u * u).sum(-1)
    H = 1004.5 * 300.0 + 0.5 * q2
    assert_close(ts._euler_flux_jac(*(torch.tensor(a) for a in (u, q2, H,
                                                                 s)), GAMMA),
                 np.asarray(js._euler_flux_jac(*(jnp.asarray(a) for a in (
                     u, q2, H, s)), GAMMA)), 1e-12, "flux jacobian")
    wt = convert.state_from_numpy(st, "cpu", F64)
    wj = jnp_tree(st)
    assert_close(ts._dQdW_blocks(wt, tin),
                 np.asarray(js._dQdW_blocks(wj, jin)), 1e-12, "dQdW")
    b = rng.standard_normal((nc, 5))

    @jax.jit
    def jpc(w, bb):
        geom = js.geometry(jin)
        inv_dt = js._inv_dtau(w, jin, geom, 50.0)
        f, t = js._block_pc(w, jin, geom, inv_dt, 4)
        return inv_dt, f(bb), t(bb)

    jdt, jf, jt = jpc(wj, jnp.asarray(b))
    geom = ts.geometry(tin)
    inv_dt = ts._inv_dtau(wt, tin, geom, 50.0)
    f, t = ts._block_pc(wt, tin, geom, inv_dt, 4)
    bt = torch.tensor(b)
    assert_close(inv_dt, np.asarray(jdt), 1e-12, "1/dtau")
    assert_close(f(bt), np.asarray(jf), 1e-12, "forward block PC")
    assert_close(t(bt), np.asarray(jt), 1e-12, "transposed block PC")


def test_ptc_jvp_against_fd():
    """The PTC matvec's jvp of the flow residual (forward-mode AD through
    the AUSM flux) against a central difference."""
    js, ts, jin = make_pair(hisa_options("diaDense"))
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st = convert.state_from_numpy(perturbed_state(js, seed=2), "cpu", F64)
    geom = ts.geometry(tin)
    rng = np.random.default_rng(6)
    ref = {"U": 240.0, "p": 1e5, "T": 300.0}
    v = {k: ref[k] * torch.tensor(rng.standard_normal(tuple(a.shape)))
         for k, a in st.items()}

    def res(w):
        return ts._residuals_geom(w, tin, geom)

    _, jv = tadj.jvp(res, st, v)
    eps = 1e-6
    with torch.no_grad():
        rp = res({k: a + eps * v[k] for k, a in st.items()})
        rm = res({k: a - eps * v[k] for k, a in st.items()})
    for k in jv:
        assert_close(jv[k], ((rp[k] - rm[k]) / (2 * eps)).numpy(), 1e-8,
                     f"jvp {k}")


# ---------------------------------------------------------------------------
# the PTC primal, three iterations pinned
# ---------------------------------------------------------------------------

PINNED = {"sequenceFlux": False, "innerIters": 20, "innerRelTol": 0.0}


def jax_ptc():
    """dafoam_tpu's three pinned PTC iterations (canonical layout) and its
    inputs."""
    if "ptc" not in _JAX:
        js = jax_solver(hisa_options(
            "canonical", hisa=PINNED, primalMaxIters=3, primalMinIters=3))
        jin = js.make_inputs()
        jw, jinfo = js.run_primal(js.init_state(), jin)
        _JAX["ptc"] = (to_numpy(jw), int(jinfo.iters), float(jinfo.max_res),
                       to_numpy(jin))
    return _JAX["ptc"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ptc_three_iterations(layout):
    ts = port_solver(hisa_options(
        layout, hisa=PINNED, primalMaxIters=3, primalMinIters=3))
    jw, jiters, jres, jin = jax_ptc()
    tin = convert.inputs_from_numpy(jin, "cpu", F64)
    tw, tinfo = ts.run_primal(ts.init_state(), tin)
    assert jiters == tinfo.iters == 3
    assert ts.solve_stats["ptc_gmres"] == [3, 60]
    assert abs(tinfo.max_res - jres) <= 1e-10 * jres
    for k, a in jw.items():
        assert_close(tw[k], a, 1e-10, f"{layout} PTC {k}")


# ---------------------------------------------------------------------------
# adjoint and totals at a converged state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converged():
    js, ts, jin = make_pair(hisa_options("diaDense"))
    jw, jinfo = js.run_primal(js.init_state(), jin)
    assert bool(jinfo.converged)
    jpsi, jai = js.run_adjoint("CDp", jw, jin)
    jtot = js.run_totals("CDp", jw, jin, jpsi)
    return js, ts, jin, to_numpy(jw), to_numpy(jtot)


def test_adjoint_totals(converged):
    js, ts, jin, jw, jtot = converged
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    w = convert.state_from_numpy(jw, "cpu", F64)
    dk.reset_counts()
    psi, ai = ts.run_adjoint("CDp", w, tin)
    assert ai.resid < 1e-8 * ai.resid0 + 1e-14
    tot = ts.run_totals("CDp", w, tin, psi)
    # HiSA calls no banded matvec
    assert sum(dk.COUNTS.values()) == 0
    assert_close(torch.cat([a.reshape(-1) for a in tree.leaves(tot)]),
                 np.concatenate([np.asarray(b).reshape(-1)
                                 for b in tree.leaves(jtot)]), 1e-8,
                 "totals")
    dJ = float(tot["bc"]["U"]["xmin"][0])
    dx = tree.tmap(torch.zeros_like, tin)
    dx["bc"]["U"]["xmin"] = torch.tensor([1.0, 0.0, 0.0], dtype=F64)
    dJ_fwd, _ = ts.forward_total_derivative(w, tin, "CDp", dx)
    assert dJ == pytest.approx(float(dJ_fwd), rel=1e-6)

    # central difference of the port's pipeline, warm-started
    h = 1e-3 * UIN
    ts.option.set("hisa.sequenceFlux", False)
    ts.option.set("hisa.cfl", 1e8)      # Newton: 2 iterations, not 6
    ts.option.set("hisa.cflMax", 1e8)
    ts.option.set("primalMinIters", 0)

    def run(uin):
        x2 = tree.tmap(torch.clone, tin)
        x2["bc"]["U"]["xmin"] = torch.tensor([uin, 0.0, 0.0], dtype=F64)
        w2, info = ts.run_primal(w, x2)
        assert info.converged, info
        return float(ts.run_function("CDp", w2, x2))

    fd = (run(UIN + h) - run(UIN - h)) / (2 * h)
    assert dJ == pytest.approx(fd, rel=2e-4)
