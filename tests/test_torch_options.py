"""The SIMPLE and linear-solver options of dafoam_tpu_torch against
dafoam_tpu (f64, CPU):

- the "krylov" step-map smoother: ``fvsolve.solve_fixed(smoother=
  "krylov")`` (``cg_steps`` on the pressure, ``bicgstab_steps`` on U and
  nuTilda) and its vjp in the start value and the right-hand side, on the
  32x12 NACA0012 matrices of test_torch_dia (dense layout), including a
  run long enough to reach the sticky freeze (rel 1e-10);
- the primal's ``pc="mg"``: same BiCGStab iterations and iterate (rel
  1e-10) on the dense-layout p matrix, the fall-through to the line PC
  (and there, without line directions, to Jacobi-CG) on the canonical
  layout, and the implicit rule's vjp with the mg PC (rel 1e-8);
- fpRemat: the rematerialized products equal the stored-graph ones
  (rel 1e-12, the port alone);
- SIMPLEC, momentumPredictor off and user U/p bounds: 10 SIMPLE
  iterations of the laminar cavity (tests/test_golden.py:
  _case_cavity_simple, an all-Neumann pressure, so adjustPhi and the
  reference cell run in every case) at pinned Krylov trip counts (rel
  1e-10);
- useMeanStates and primalFuncStdTol: the same exit iteration and final
  state (rel 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu.ops import fvmatrix as jfvx
from dafoam_tpu_torch import convert
from test_torch_cases import assert_close, to_numpy
from test_torch_dia import _assembled, _tmat

torch.set_num_threads(1)
PINNED = {"pMaxIters": 2, "pRelTol": 0.0, "uMaxIters": 3, "uRelTol": 0.0}


@pytest.fixture(scope="module")
def dense():
    return _assembled("diaDense")


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


# ---------------------------------------------------------------------------
# the "krylov" step-map smoother
# ---------------------------------------------------------------------------

# (field, symmetric, steps): a dozen CG steps on p and five BiCGStab steps
# on U and nuTilda; 400 CG steps on the 384-cell p matrix run far past
# the f64 floor, so the sticky freeze stops them
KRYLOV = [("p", True, 12), ("U", False, 5), ("nuTilda", False, 5),
          ("p", True, 400)]


@pytest.mark.parametrize("field,symmetric,steps", KRYLOV)
def test_krylov_smoother_matches_jax(dense, field, symmetric, steps):
    from dafoam_tpu.linalg import fvsolve as jfs
    from dafoam_tpu_torch.linalg import fvsolve as tfs
    topo_j, topo_t, mats, st = dense
    m, psi0 = mats[field], st[field]
    rng = np.random.default_rng(steps)
    ct = rng.standard_normal(psi0.shape)

    @jax.jit
    def jrun(psi, src):
        f = lambda p_, s_: jfs.solve_fixed(  # noqa: E731
            m._replace(source=s_), p_, topo_j, symmetric=symmetric,
            n_iters=steps, smoother="krylov")
        x, f_vjp = jax.vjp(f, psi, src)
        return x, f_vjp(jnp.asarray(ct))

    xj, (gpj, gsj) = jrun(jnp.asarray(psi0), jnp.asarray(m.source))
    mt = _tmat(m)
    p_t = torch.from_numpy(psi0).requires_grad_(True)
    s_t = mt.source.clone().requires_grad_(True)

    def trun(n):
        return tfs.solve_fixed(mt._replace(source=s_t), p_t, topo_t,
                               symmetric=symmetric, n_iters=n,
                               smoother="krylov")

    xt = trun(steps)
    gpt, gst = torch.autograd.grad(xt, (p_t, s_t), torch.from_numpy(ct))
    assert_close(xt, np.asarray(xj), 1e-10, f"{field} iterate")
    assert_close(gst, np.asarray(gsj), 1e-10, f"{field} vjp in b")
    if steps > 100:
        # frozen: more steps are exact identities; x0 -> x is I - C A ~ 0
        # there, so its vjp is rounding, judged on the scale of dx/db
        assert torch.equal(trun(steps + 100).detach(), xt.detach())
        err = float(np.abs(gpt.numpy() - np.asarray(gpj)).max())
        assert err <= 1e-10 * float(np.abs(np.asarray(gsj)).max())
    else:
        assert_close(gpt, np.asarray(gpj), 1e-10, f"{field} vjp in psi0")


# ---------------------------------------------------------------------------
# the primal's multigrid PC
# ---------------------------------------------------------------------------

def _jax_mg_iters(m, psi0, topo, rel_tol, max_iters):
    """The inner BiCGStab of dafoam_tpu's solve(pc="mg") run on its own
    (custom_linear_solve hides the iteration count)."""
    from dafoam_tpu.linalg import krylov as jk
    from dafoam_tpu.linalg import mg as jmg
    h = jmg.build_hierarchy(m, topo)
    mv = jfvx.matvec_fn(m, topo, pallas=False)
    _, info = jk.bicgstab(mv, m.source - mv(psi0),
                          precond=lambda r: jmg.vcycle(h, r, omega=1.7),
                          rel_tol=rel_tol, max_iters=max_iters)
    return info


@pytest.mark.parametrize("layout", ["diaDense", "canonical"])
def test_mg_pc_matches_jax(dense, layout):
    from dafoam_tpu.linalg import fvsolve as jfs
    from dafoam_tpu_torch.linalg import fvsolve as tfs
    from dafoam_tpu_torch.linalg import mg as tmg
    topo_j, topo_t, mats, st = dense if layout == "diaDense" \
        else _assembled("canonical")
    m, psi0 = mats["p"], st["p"]
    assert (tmg.grid_structure(topo_t) is None) == (layout == "canonical")

    grid = layout == "diaDense"

    @jax.jit
    def jrun(m, psi):
        x, _ = jfs.solve(m, psi, topo_j, symmetric=True, rel_tol=1e-8,
                         max_iters=100, pc="mg")
        return x, (_jax_mg_iters(m, psi, topo_j, 1e-8, 100) if grid
                   else None)

    xj, ij = jrun(m, jnp.asarray(psi0))
    xt, it = tfs.solve(_tmat(m), torch.from_numpy(psi0), topo_t,
                       symmetric=True, rel_tol=1e-8, max_iters=100, pc="mg")
    assert_close(xt, np.asarray(xj), 1e-10, "p iterate")
    _, ic = tfs.solve(_tmat(m), torch.from_numpy(psi0), topo_t,
                      symmetric=True, rel_tol=1e-8, max_iters=100)
    if grid:
        assert it.iters == int(ij.iters) and it.converged, (it, ij)
        # Jacobi-CG does not reach 1e-8 within its 100 iterations here
        assert it.iters < 20 and not ic.converged, (it, ic)
    else:
        # no grid form and no line directions: Jacobi-CG, as dafoam_tpu
        assert it.iters == ic.iters


def test_mg_solver_and_transpose_grid_match_jax(dense):
    """mg.mg_solver (one V-cycle as an approximate inverse) and
    transpose_grid (the grid operator of A^T) on the p matrix (rel
    1e-12)."""
    from dafoam_tpu.linalg import mg as jmg
    from dafoam_tpu_torch.linalg import mg as tmg
    topo_j, topo_t, mats, _ = dense
    m = mats["p"]
    r = np.random.default_rng(4).standard_normal(topo_j.n_cells)
    want = jax.jit(lambda mm, rr: jmg.mg_solver(mm, topo_j, omega=1.7)(rr))(
        m, jnp.asarray(r))
    got = tmg.mg_solver(_tmat(m), topo_t, omega=1.7)(torch.from_numpy(r))
    assert_close(got, np.asarray(want), 1e-12, "V-cycle")
    op_j = jmg.grid_form(jfvx.FvMatrix(*map(jnp.asarray, m)), topo_j)
    op_t = tmg.grid_form(_tmat(m), topo_t)
    x = r.reshape(op_t.D.shape)
    want = jmg.grid_matvec(jmg.transpose_grid(op_j), jnp.asarray(x))
    got = tmg.grid_matvec(tmg.transpose_grid(op_t), torch.from_numpy(x))
    assert_close(got, np.asarray(want), 1e-12, "A^T x")
    # and it is the transpose: <A^T x, y> = <x, A y>
    y = np.random.default_rng(5).standard_normal(x.shape)
    ay = tmg.grid_matvec(op_t, torch.from_numpy(y)).numpy()
    assert abs(float((got.numpy() * y).sum()) - float((x * ay).sum())) \
        <= 1e-12 * float(np.abs(x * ay).sum())


def test_mg_pc_implicit_vjp_matches_jax(dense):
    """The implicit rule of solve(pc="mg"): its tight transpose solve runs
    with the V-cycle of A^T's own hierarchy (rel 1e-8)."""
    from dafoam_tpu.linalg import fvsolve as jfs
    from dafoam_tpu_torch.linalg import fvsolve as tfs
    topo_j, topo_t, mats, st = dense
    m, psi0 = mats["p"], st["p"]
    ct = np.random.default_rng(3).standard_normal(psi0.shape)

    @jax.jit
    def jrun(diag, src):
        f = lambda d_, s_: jfs.solve(  # noqa: E731
            m._replace(diag=d_, source=s_), jnp.asarray(psi0), topo_j,
            symmetric=True, rel_tol=1e-8, max_iters=100, pc="mg")[0]
        _, f_vjp = jax.vjp(f, diag, src)
        return f_vjp(jnp.asarray(ct))

    gdj, gsj = jrun(jnp.asarray(m.diag), jnp.asarray(m.source))
    mt = _tmat(m)
    d_t = mt.diag.clone().requires_grad_(True)
    s_t = mt.source.clone().requires_grad_(True)
    xt, _ = tfs.solve(mt._replace(diag=d_t, source=s_t),
                      torch.from_numpy(psi0), topo_t, symmetric=True,
                      rel_tol=1e-8, max_iters=100, pc="mg")
    gdt, gst = torch.autograd.grad(xt, (d_t, s_t), torch.from_numpy(ct))
    assert_close(gst, np.asarray(gsj), 1e-8, "vjp in b")
    assert_close(gdt, np.asarray(gdj), 1e-8, "vjp in diag")


# ---------------------------------------------------------------------------
# the laminar cavity: fpRemat, SIMPLE options, loop controls
# ---------------------------------------------------------------------------

def cavity_options(**over):
    """tests/test_golden.py:_case_cavity_simple's options."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DASimpleFoam", "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {n: {"type": "zeroGradient"}
                  for n in ("xmin", "xmax", "ymin", "ymax")}},
        "initialFields": {"U": zero, "p": 0.0},
        "primalMinResTol": 1e-11, "primalMaxIters": 500,
        "relaxationFactors": {"fields": {"p": 0.3},
                              "equations": {"U": 0.7}},
        "function": {"lidForce": {"type": "force", "patches": ["ymax"],
                                  "directionMode": "fixedDirection",
                                  "direction": [1.0, 0.0, 0.0],
                                  "scale": 1.0}},
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 150,
                         "gmresMaxIters": 3000},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
    }
    opts.update(over)
    return opts


def cavity_box(lib):
    kinds = {"zmin": "empty", "zmax": "empty", "xmin": "wall",
             "xmax": "wall", "ymin": "wall", "ymax": "wall"}
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(10, 10, 1, (0.1, 0.1, 0.01), kinds=kinds)


def cavity_solvers(opts):
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    pj, tj = cavity_box("jax")
    pt, tt = cavity_box("torch")
    return (jmake(opts, tj, pj),
            tmake(opts, tt, pt, device="cpu", dtype=torch.float64))


def test_fp_remat_products_equal_stored_graph():
    """adjEqnOption.fpRemat re-runs the step map for every product: two
    deflated GMRES cycles of 8 give the same iterations and psibar as the
    stored graph's (rel 1e-12), on the cavity (dense layout, mg step-map
    smoother) after 40 SIMPLE iterations."""
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = cavity_box("torch")
    adj = {"fpMaxIters": 16, "fpRelTol": 1e-14, "gmresRestart": 8,
           "gmresDeflate": 2, "fpInnerSmoother": "mg", "fpInnerScale": 0.4,
           "gmresAbsTol": 1e-30}
    s = make_solver(cavity_options(adjEqnSolMethod="fixedPoint",
                                   adjEqnOption=adj, primalMaxIters=40,
                                   primalMinResTol=0.0, primalMinIters=40,
                                   meshFaceLayout="diaDense"),
                    topo, pts, device="cpu", dtype=torch.float64)
    x = s.make_inputs()
    w, _ = s.run_primal(s.init_state(), x)
    out = {}
    for remat in (False, True):
        s.option["adjEqnOption"]["fpRemat"] = remat
        out[remat] = s.solve_adjoint(w, x, "lidForce")
    (p0, i0), (p1, i1) = out[False], out[True]
    assert i0.iters == i1.iters == 16 and i1.resid < i1.resid0
    assert abs(i1.resid - i0.resid) <= 1e-12 * i0.resid0
    for k in p0:
        assert_close(p1[k], p0[k].numpy(), 1e-12, f"psibar {k}")


def _cavity_runs(direct=False, **over):
    """Both packages' primal on the cavity. direct: build DASimpleFoam
    itself from the option dict (make_solver wraps the dict in a DAOption,
    and both packages apply U/p bounds only from the caller's own dict)."""
    opts = cavity_options(**over)
    if direct:
        from dafoam_tpu.solvers.simple import DASimpleFoam as JSimple
        from dafoam_tpu_torch.solvers.simple import DASimpleFoam as TSimple
        pj, tj = cavity_box("jax")
        pt, tt = cavity_box("torch")
        js = JSimple(opts, tj, pj)
        ts = TSimple(opts, tt, pt, device="cpu", dtype=torch.float64)
    else:
        js, ts = cavity_solvers(opts)
    jin = js.make_inputs()
    st0 = to_numpy(js.init_state())
    jst, jinfo = js.run_primal(st0, jin)
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", torch.float64)
    tst, tinfo = ts.run_primal(convert.state_from_numpy(st0, "cpu",
                                                        torch.float64), tin)
    return to_numpy(jst), jinfo, convert.state_to_numpy(tst), tinfo


def _check_runs(jst, jinfo, tst, tinfo, iters):
    assert int(jinfo.iters) == tinfo.iters == iters, (jinfo, tinfo)
    assert bool(jinfo.converged) == tinfo.converged
    assert bool(jinfo.failed) == tinfo.failed
    for k in jst:
        assert_close(tst[k], jst[k], 1e-10, k)


@pytest.mark.parametrize("over", [
    {"simple": {"consistent": True}},
    {"simple": {"momentumPredictor": False}},
    {"primalVarBounds": {"UMax": 0.3, "UMin": -0.2, "pMax": 0.02}},
], ids=["SIMPLEC", "no-momentum-predictor", "bounds"])
def test_simple_options_match_jax(over):
    bounds = "primalVarBounds" in over
    jst, jinfo, tst, tinfo = _cavity_runs(
        direct=bounds, primalMinResTol=0.0, primalMinIters=10,
        primalMaxIters=10, primalLinearSolver=dict(PINNED), **over)
    _check_runs(jst, jinfo, tst, tinfo, 10)
    if bounds:
        assert tst["U"].max() == 0.3 and tst["p"].max() <= 0.02


def test_mean_states_match_jax():
    """useMeanStates: the mean of U and p over iterations 10-19 replaces
    the final state, phi keeps its last value."""
    jst, jinfo, tst, tinfo = _cavity_runs(
        primalMinResTol=0.0, primalMinIters=20, primalMaxIters=20,
        primalLinearSolver=dict(PINNED), useMeanStates=True,
        meanStateStart=0.5)
    _check_runs(jst, jinfo, tst, tinfo, 20)


def test_func_std_exit_matches_jax():
    """primalFuncStdTol on lidForce stops the cavity's primal long before
    its residual tolerance, at the same iteration in both packages."""
    jst, jinfo, tst, tinfo = _cavity_runs(
        primalMinResTol=1e-14, primalMaxIters=120,
        primalFuncStdTol={"stdTol": 2e-3, "funcNames": ["lidForce"],
                          "nStepsFrac": 0.2})
    assert 5 < tinfo.iters < 120 and tinfo.converged and not tinfo.failed
    _check_runs(jst, jinfo, tst, tinfo, tinfo.iters)
