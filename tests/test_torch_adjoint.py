"""The fixed-point adjoint and totals of dafoam_tpu_torch against dafoam_tpu.

- ``linalg.krylov.gmres`` with deflated restarts, across three restart
  cycles and a second call seeded with the first call's recycle space:
  same iterate and residual as dafoam_tpu's gmres on a dict-valued system.
- One reverse product (I - dG^T) v and one tangent product (I - dG) v of
  the SIMPLE step map G on the 32x12 NACA0012 case (dense-DIA layout, f64,
  mg step-map smoother, damped Jacobi for U), from one state carried
  across with convert.py; with the same solvers the normalized residuals R
  of the residual-form adjoint and one vjp and one jvp of them (1e-12).
- The fixed-point totals dCD/dnu and ||dCD/dpoints|| of a converged
  primal against golden ``naca_sa``, and adjoint/tangent triangulation;
  the residual-form (Krylov) totals from the same converged state.

About the product test's state and options. The step map is not
differentiable everywhere, and the converged state sits on two kinks
whose one-sided derivatives the two packages pick by their last-ulp
rounding: (1) ``fvMatrix::relax``'s dominance max(|a_P|, sum|a_N|) is an
exact algebraic tie in every interior cell of a bounded-upwind plus
laplacian matrix; (2) the limited non-orthogonal correction has a |x| kink
where two neighbouring pressures agree to rounding. Off them the products
agree to ~1e-15 (measured); on them single entries differ by O(1) while
the totals do not move (the fixed-point totals are exact at W* for any
smooth approximate inverse, and these paths carry a factor R(W*) ~ 0). So
the product test perturbs the converged state by 2% (seeded numpy noise)
and runs with equation relaxation 1 (relax() is then the identity); the
totals test runs the golden options unchanged.
"""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint import solver as tadj
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.utils import tree
from test_torch_cases import (NU, REPO, assert_close, jax_solver,
                              naca_options, torch_solver)

torch.set_num_threads(1)

# the bench's fixed-point adjoint options (bench.py adjEqnOption) with the
# golden-case tolerance
FP_OPTIONS = {"fpRelTol": 1e-10, "fpMaxIters": 2000, "fpInnerScale": 0.4,
              "fpInnerSmoother": "mg", "fpRelaxFields": {"p": 0.7},
              "fpAcceleration": "gmres", "gmresRestart": 120,
              "gmresDeflate": 16, "gmresAbsTol": 1e-30, "pcType": "none"}
NORMALIZE = {"U": 1.0, "p": 0.5, "phi": 1.0, "nuTilda": 3 * NU}
# golden naca_sa comes from the residual-form Krylov adjoint on the
# canonical layout. dafoam_tpu's own fixed-point totals on this dense
# setup (FP_OPTIONS, primal to 1e-10) land at dCD/dnu 3.3468441233000226
# (rel 5.2e-10 from golden) and ||dCD/dpoints|| 0.07862333792018059 (rel
# 3.55e-7), measured on the CPU in f64. Bars: 1e-6, or 10x that gap where
# it is larger.
BAR_DNU = 1e-6
BAR_DPOINTS = 3.6e-6
# tests/test_golden.py:_case_naca_sa's residual-form adjoint options, with
# one unrestarted FGMRES cycle: restarted every 400 iterations the solve
# needs 2,301 of them here (dafoam_tpu: 2,313), one cycle needs 799 (both
# measured on the CPU, f64), and each costs a residual vjp and a PC
# application (~30 ms here); chip_smoke.py phase 4c runs restart 400
GOLDEN_KRYLOV = {"gmresRelTol": 1e-9, "gmresRestart": 1000,
                 "gmresMaxIters": 3000, "pcType": "segregated"}


def fp_options(**over):
    return naca_options("diaDense", adjEqnSolMethod="fixedPoint",
                        adjEqnOption=dict(FP_OPTIONS),
                        normalizeStates=dict(NORMALIZE), **over)


# ---------------------------------------------------------------------------
# gmres with deflated restarts
# ---------------------------------------------------------------------------

def _system(seed=0):
    """A nonsymmetric system on a dict vector {"b": (40, 3), "a": (50,)}
    whose spectrum is spread enough that 60 iterations do not converge."""
    rng = np.random.default_rng(seed)
    n = 170
    A = np.diag(np.linspace(0.02, 2.0, n)) \
        + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    b = {"b": rng.standard_normal((40, 3)), "a": rng.standard_normal(50)}
    return A, b


def _flat_matvec(A, flatten, unflatten):
    return lambda v: unflatten(A @ flatten(v))


def test_gmres_deflated_restarts_match_jax():
    from dafoam_tpu.linalg import krylov as jk
    from dafoam_tpu_torch.linalg import krylov as tk
    A, b = _system()
    kw = dict(restart=20, deflate=4, rel_tol=1e-14, abs_tol=1e-30,
              max_iters=60, return_aug=True)

    bj = {k: jnp.asarray(v) for k, v in b.items()}
    _, unr = jax.flatten_util.ravel_pytree(bj)
    Aj = jnp.asarray(A)
    mvj = _flat_matvec(Aj, lambda v: jax.flatten_util.ravel_pytree(v)[0],
                       unr)
    bt = {k: torch.from_numpy(v) for k, v in b.items()}
    _, unt = tree.ravel(bt)
    At = torch.from_numpy(A)
    mvt = _flat_matvec(At, lambda v: tree.ravel(v)[0], unt)

    xj, ij, Uj = jk.gmres(mvj, bj, **kw)
    xt, it, Ut = tk.gmres(mvt, bt, **kw)
    assert it.iters == int(ij.iters) == 60 and not it.converged
    for k in b:
        assert_close(xt[k], xj[k], 1e-10, k)
    assert abs(it.resid - float(ij.resid)) <= 1e-10 * float(ij.resid0)
    # a second call seeded with the carried recycle space (re-orthonormalized
    # at entry); the space itself goes both ways through convert.py
    U_in = convert.recycle_from_numpy(np.asarray(Uj), "cpu", torch.float64)
    assert_close(convert.recycle_to_numpy(Ut), np.asarray(Uj), 1e-8,
                 "recycle space")
    xj2, ij2, _ = jk.gmres(mvj, bj, x0=xj, aug0=Uj, **kw)
    xt2, it2, _ = tk.gmres(mvt, bt, x0=xt, aug0=U_in, **kw)
    assert it2.iters == int(ij2.iters)
    for k in b:
        assert_close(xt2[k], xj2[k], 1e-10, k)
    assert abs(it2.resid - float(ij2.resid)) <= 1e-10 * float(ij2.resid0)


# ---------------------------------------------------------------------------
# the fixed-point solvers on a small nonlinear contraction
# ---------------------------------------------------------------------------

def _toy(lib, asarray):
    """A step map G(w, x) on state {"b": (4, 2), "a": (6,)} and inputs
    {"x": (3,)}: tanh of a contraction plus an input term, and an
    objective J(w, x), in either package."""
    rng = np.random.default_rng(4)
    M = rng.standard_normal((14, 14))
    M = asarray(0.6 * M / np.linalg.norm(M, 2))
    P = asarray(rng.standard_normal((14, 3)))

    def flat(w):
        return lib.concatenate([w["a"].reshape(-1), w["b"].reshape(-1)])

    def step(w, x):
        v = lib.tanh(M @ flat(w) + P @ x["x"])
        return {"a": v[:6], "b": v[6:].reshape(4, 2)}, None

    def func(w, x):
        return (w["a"] ** 2).sum() * x["x"][0] + w["b"].sum() * x["x"][1]

    state = {"a": asarray(rng.standard_normal(6)),
             "b": asarray(rng.standard_normal((4, 2)))}
    inputs = {"x": asarray(rng.standard_normal(3))}
    dJdW = {"a": asarray(rng.standard_normal(6)),
            "b": asarray(rng.standard_normal((4, 2)))}
    dx = {"x": asarray(rng.standard_normal(3))}
    return step, func, state, inputs, dJdW, dx


@pytest.mark.parametrize("accel", ["gmres", "richardson"])
def test_fp_solvers_match_jax_on_a_small_map(accel):
    from dafoam_tpu.adjoint import solver as jadj

    class TorchLib:
        tanh = staticmethod(torch.tanh)
        concatenate = staticmethod(torch.cat)

    js, jf, jw, jx, jg, jdx = _toy(jnp, jnp.asarray)
    ts, tf, tw, tx, tg, tdx = _toy(TorchLib, torch.from_numpy)
    kw = dict(rel_tol=1e-12, abs_tol=1e-30, max_iters=200, relax=0.9,
              accel=accel, restart=6, deflate=2)
    scj = {"a": jnp.asarray(2.0), "b": jnp.asarray(0.5)}
    sct = {"a": torch.tensor(2.0, dtype=torch.float64),
           "b": torch.tensor(0.5, dtype=torch.float64)}
    pj, ij = jadj.adjoint_solve_fp(js, jw, jx, jg, scales=scj, **kw)
    pt, it = tadj.adjoint_solve_fp(ts, tw, tx, tg, scales=sct, **kw)
    assert it.converged and it.iters == int(ij.iters), (it, ij)
    for k in pj:
        assert_close(pt[k], pj[k], 1e-10, f"psibar {k}")
    tot_j = jadj.total_derivative_fp(js, jf, jw, jx, pj)
    tot_t = tadj.total_derivative_fp(ts, tf, tw, tx, pt)
    assert_close(tot_t["x"], tot_j["x"], 1e-10, "totals")
    if accel == "gmres":
        dj, _ = jadj.forward_total_derivative_fp(
            js, jf, jw, jx, jdx, rel_tol=1e-12, restart=6, deflate=2,
            scales=scj)
        dt, _ = tadj.forward_total_derivative_fp(
            ts, tf, tw, tx, tdx, rel_tol=1e-12, restart=6, deflate=2,
            scales=sct)
        assert_close(dt, dj, 1e-10, "tangent dJ")


# ---------------------------------------------------------------------------
# one reverse and one tangent product of the step map
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def converged():
    """The port's primal on the dense layout, converged to the golden
    tolerance, as numpy."""
    s = torch_solver(fp_options())
    inputs = s.make_inputs()
    state, info = s.run_primal(s.init_state(), inputs)
    assert info.converged and not info.failed, info
    return s, inputs, state, info


@pytest.fixture(scope="module")
def off_kink(converged):
    """Both packages' solvers with equation relaxation 1 and smaller inner
    budgets than the golden case's (one V-cycle each for p and nuTilda,
    two damped-Jacobi sweeps for U: a short JAX trace), the converged
    state perturbed by 2% and a random state-shaped vector, as numpy."""
    state0 = convert.state_to_numpy(converged[2])
    rng = np.random.default_rng(42)
    st = {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
          for k, a in state0.items()}
    v = {k: rng.standard_normal(a.shape) for k, a in st.items()}
    over = {"relaxationFactors": {"fields": {"p": 0.2},
                                  "equations": {"U": 1.0, "nuTilda": 1.0}},
            "primalLinearSolver": {"pMaxIters": 20, "pRelTol": 0.02,
                                   "uMaxIters": 5, "uRelTol": 0.05,
                                   "turbMaxIters": 20, "turbRelTol": 0.05}}
    sj = jax_solver(fp_options(**over))
    ij = sj.make_inputs()
    return SimpleNamespace(
        st=st, v=v, sj=sj, ij=ij, s=torch_solver(fp_options(**over)),
        it=convert.inputs_from_numpy(
            jax.tree_util.tree_map(np.asarray, ij), "cpu", torch.float64))


def test_step_map_products_match_jax(off_kink):
    ok = off_kink
    st, v, ij, it = ok.st, ok.v, ok.ij, ok.it
    gj, gt = ok.sj._fp_step_fn(), ok.s._fp_step_fn()
    wj = {k: jnp.asarray(a) for k, a in st.items()}
    vj = {k: jnp.asarray(a) for k, a in v.items()}

    @jax.jit
    def jax_products(w, x, vv):
        _, f_vjp = jax.vjp(lambda w_: gj(w_, x)[0], w)
        (g,) = f_vjp(vv)
        _, t = jax.jvp(lambda w_: gj(w_, x)[0], (w,), (vv,))
        return (jax.tree_util.tree_map(jnp.subtract, vv, g),
                jax.tree_util.tree_map(jnp.subtract, vv, t))

    rev_j, tan_j = jax_products(wj, ij, vj)
    wt = convert.state_from_numpy(st, "cpu", torch.float64)
    vt = convert.state_from_numpy(v, "cpu", torch.float64)
    _, f_vjp = tadj.vjp(lambda w: gt(w, it)[0], wt)
    rev_t = {k: vt[k] - g for k, g in f_vjp(vt).items()}
    _, t = tadj.jvp(lambda w: gt(w, it)[0], wt, vt)
    tan_t = {k: vt[k] - g for k, g in t.items()}
    for k in st:
        assert_close(rev_t[k], rev_j[k], 1e-10, f"(I - dG^T) v, {k}")
        assert_close(tan_t[k], tan_j[k], 1e-10, f"(I - dG) v, {k}")


def test_norm_residuals_and_products_match_jax(off_kink):
    """The normalized residuals of the residual-form adjoint and one vjp and
    one jvp of them, with off_kink's solvers at 30 SIMPLE iterations from
    the initial state perturbed by 2% (at the converged state R is a
    difference of nearly equal terms and its rounding is ~1e-12 of
    max|R|)."""
    ok = off_kink
    s = ok.s
    s.option.set("primalMaxIters", 30)
    s.option.set("primalMinResTol", 0.0)
    w30, _ = s.run_primal(s.init_state(), ok.it)
    rng = np.random.default_rng(3)
    st = {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
          for k, a in convert.state_to_numpy(w30).items()}

    @jax.jit
    def products(w, vv):
        f = lambda w_: ok.sj._norm_residuals(w_, ok.ij)  # noqa: E731
        r, f_vjp = jax.vjp(f, w)
        _, t = jax.jvp(f, (w,), (vv,))
        return r, f_vjp(vv)[0], t

    rj, gj, tj = products({k: jnp.asarray(a) for k, a in st.items()},
                          {k: jnp.asarray(a) for k, a in ok.v.items()})
    wt = convert.state_from_numpy(st, "cpu", torch.float64)
    vt = convert.state_from_numpy(ok.v, "cpu", torch.float64)
    f = lambda w: s._norm_residuals(w, ok.it)  # noqa: E731
    rt, f_vjp = tadj.vjp(f, wt)
    gt = f_vjp(vt)
    _, tt = tadj.jvp(f, wt, vt)
    assert set(rt) == set(rj) == {"U", "p", "phi", "nuTilda"}
    for k in rj:
        assert_close(rt[k], rj[k], 1e-12, f"R {k}")
        assert_close(gt[k], gj[k], 1e-12, f"dR^T v {k}")
        assert_close(tt[k], tj[k], 1e-12, f"dR v {k}")


# ---------------------------------------------------------------------------
# converged totals: golden and triangulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def totals(converged):
    s, inputs, state, _ = converged
    dk.reset_counts()
    psibar, info = s.solve_adjoint(state, inputs, "CD")
    counts = dict(dk.COUNTS)
    tot = s.total_derivative(state, inputs, "CD", psibar)
    return psibar, info, tot, counts


def test_fp_totals_meet_golden(totals):
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]
    psibar, info, tot, counts = totals
    assert info.converged and info.resid < 1e-10 * info.resid0, info
    assert all(bool(torch.isfinite(v).all()) for v in psibar.values())
    dnu = float(tot["params"]["nu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    assert abs(dnu - want["dCD_dnu"]) <= BAR_DNU * abs(want["dCD_dnu"]), dnu
    assert abs(dpts - want["dCD_dpoints_norm"]) \
        <= BAR_DPOINTS * want["dCD_dpoints_norm"], dpts
    # every reverse product went through the K3 plain versions (CPU)
    for name in ("dia_matvec_t", "dia_matvec_multi_t", "dia_cotangent",
                 "dia_cotangent_multi"):
        assert counts[name + "_plain"] > 0 and counts[name] == 0, name


def test_adjoint_and_tangent_triangulate(converged, totals):
    s, inputs, state, _ = converged
    tot = totals[2]
    rng = np.random.default_rng(9)
    dx = tree.tmap(torch.zeros_like, inputs)
    dx["points"] = torch.from_numpy(
        1e-3 * rng.standard_normal(tuple(inputs["points"].shape)))
    dx["params"]["nu"] = torch.tensor(1e-4, dtype=torch.float64)
    # the tangent solve to fpRelTol 1e-8 is enough for the 1e-6 bar (each
    # of its products runs the step map in forward mode, the slow part)
    opt = s.option["adjEqnOption"]
    opt["fpRelTol"] = 1e-8
    try:
        dJ, info = s.forward_total_derivative(state, inputs, "CD", dx)
    finally:
        opt["fpRelTol"] = FP_OPTIONS["fpRelTol"]
    assert info.converged, info
    adj = float((tot["points"] * dx["points"]).sum()
                + tot["params"]["nu"] * dx["params"]["nu"])
    assert abs(float(dJ) - adj) <= 1e-6 * abs(adj), (float(dJ), adj)


def test_residual_form_totals_meet_golden(converged):
    """The residual-form (Krylov) adjoint with golden naca_sa's adjEqnOption
    (FGMRES to rel 1e-9, segregated PC; one cycle, see GOLDEN_KRYLOV) from
    the converged dense-layout state: golden totals at the dense-layout
    bars, and the PC's transposed products ran the K3a plain versions."""
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]
    s0, inputs, state, _ = converged
    opts = naca_options("diaDense", normalizeStates=dict(NORMALIZE),
                        adjEqnOption=dict(GOLDEN_KRYLOV))
    s = torch_solver(opts)
    assert s.option["adjEqnSolMethod"] == "Krylov"      # the default
    dk.reset_counts()
    psi, info = s.solve_adjoint(state, inputs, "CD")
    counts = dict(dk.COUNTS)
    tot = s.total_derivative(state, inputs, "CD", psi)
    assert info.converged and info.resid <= 1e-9 * info.resid0, info
    dnu = float(tot["params"]["nu"])
    dpts = float(torch.linalg.norm(tot["points"]))
    assert abs(dnu - want["dCD_dnu"]) <= BAR_DNU * abs(want["dCD_dnu"]), dnu
    assert abs(dpts - want["dCD_dpoints_norm"]) \
        <= BAR_DPOINTS * want["dCD_dpoints_norm"], dpts
    for name in ("dia_matvec_t", "dia_matvec_multi_t"):
        assert counts[name + "_plain"] > 0 and counts[name] == 0, name


@pytest.mark.parametrize("key,value,error", [
    ("fpRelaxEquations", {"U": 0.9}, ValueError)])
def test_unported_adjoint_options_raise(converged, key, value, error):
    s, inputs, state, _ = converged
    path = key if key == "adjEqnSolMethod" else "adjEqnOption." + key
    missing = object()
    old = s.option.get(path, missing)
    s.option.set(path, value)
    try:
        with pytest.raises(error):
            s.solve_adjoint(state, inputs, "CD")
    finally:
        if old is missing:
            del s.option["adjEqnOption"][key]
        else:
            s.option.set(path, old)
