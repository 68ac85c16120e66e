"""The residual-form adjoint of dafoam_tpu_torch against dafoam_tpu: the
ADI line solves, the adjoint's block preconditioners, the residual-form
solvers on a small system, and the implicit rule of ``fvsolve.solve``
(the normalized residuals and their products are in test_torch_adjoint,
beside the step-map products at the same off-kink state).

The case is the golden 32x12 NACA0012 O-mesh on the dense-DIA layout
(f64): the preconditioners are built at 30 SIMPLE iterations from the
initial state, perturbed by 2% (seeded numpy noise); the line solves and
the implicit solve use the assembled matrices of
``test_torch_dia._assembled``.

Bars: line solves, PC blocks and the small-system solvers 1e-10; the
implicit solve's vjp/jvp 1e-8 (its transpose solve stops at rel 1e-10 of
its own residual, and the two packages reach that exit by different
summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from dafoam_tpu.adjoint import precond as jpc
from dafoam_tpu.adjoint import solver as jadj
from dafoam_tpu.linalg import fvsolve as jfs
from dafoam_tpu.linalg import lines as jlines
from dafoam_tpu.ops import fvmatrix as jfvx
from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint import precond as tpc
from dafoam_tpu_torch.adjoint import solver as tadj
from dafoam_tpu_torch.linalg import fvsolve as tfs
from dafoam_tpu_torch.linalg import lines as tlines
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.ops import dia_kernels as dk
from dafoam_tpu_torch.ops import fvmatrix as tfvx
from dafoam_tpu_torch.utils import tree
from test_torch_cases import NU, assert_close, naca_options, torch_solver
from test_torch_dia import _assembled, _tmat

torch.set_num_threads(1)

NORMALIZE = {"U": 1.0, "p": 0.5, "phi": 1.0, "nuTilda": 3 * NU}




def _j(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _jm(m):
    return jfvx.FvMatrix(*(jnp.asarray(a) for a in m))


def _np(t):
    return tree.tmap(lambda v: v.detach().numpy(), t)


@pytest.fixture(scope="module")
def case():
    """The port's solver on the dense layout, 30 SIMPLE iterations from the
    initial state perturbed by 2% (numpy), and a random state-shaped
    vector."""
    s = torch_solver(naca_options("diaDense", primalMaxIters=30,
                                  primalMinResTol=0.0,
                                  normalizeStates=dict(NORMALIZE)))
    it = s.make_inputs()
    st, _ = s.run_primal(s.init_state(), it)
    rng = np.random.default_rng(3)
    st = {k: a * (1.0 + 0.02 * rng.standard_normal(a.shape))
          for k, a in convert.state_to_numpy(st).items()}
    v = {k: rng.standard_normal(a.shape) for k, a in st.items()}
    return SimpleNamespace(s=s, it=it, st=st, v=v,
                           wt=convert.state_from_numpy(st, "cpu",
                                                       torch.float64))


# ---------------------------------------------------------------------------
# ADI line solves
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    topo_j, topo_t, mats, st = _assembled("diaDense")
    geom = compute_geometry(torch_solver(naca_options("diaDense")).points,
                            topo_t)
    return SimpleNamespace(topo_j=topo_j, topo_t=topo_t, mats=mats, st=st,
                           vol=geom.vol.numpy())


def _rhs(field, nc, seed):
    shape = (nc, 3) if field == "U" else (nc,)
    return np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("field,sweeps", [("p", 1), ("p", 2), ("U", 1),
                                          ("nuTilda", 1)])
def test_line_solvers_match_jax(dense, field, sweeps):
    m = dense.mats[field]
    r = _rhs(field, dense.topo_t.n_cells, 5)
    geom_j = SimpleNamespace(vol=jnp.asarray(dense.vol))
    geom_t = SimpleNamespace(vol=torch.from_numpy(dense.vol))
    mt = _tmat(m)
    want = jlines.line_solver(_jm(m), dense.topo_j, adi_sweeps=sweeps)(
        jnp.asarray(r))
    want_t = jpc.line_solver_T(_jm(m), dense.topo_j, geom_j,
                               adi_sweeps=sweeps)(jnp.asarray(r))
    got = tlines.line_solver(mt, dense.topo_t, adi_sweeps=sweeps)(
        torch.from_numpy(r))
    assert_close(got, want, 1e-10, f"line_solver {field}")
    n0 = dk.COUNTS["dia_matvec_t_plain"] + dk.COUNTS[
        "dia_matvec_multi_t_plain"]
    got = tpc.line_solver_T(mt, dense.topo_t, geom_t, adi_sweeps=sweeps)(
        torch.from_numpy(r))
    assert_close(got, want_t, 1e-10, f"line_solver_T {field}")
    # the transposed defect products ran K3a (plain on the CPU)
    assert dk.COUNTS["dia_matvec_t_plain"] + dk.COUNTS[
        "dia_matvec_multi_t_plain"] > n0


# ---------------------------------------------------------------------------
# preconditioner blocks and the assembled preconditioners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,symmetric", [("p", True), ("U", False),
                                             ("nuTilda", False)])
def test_krylov_blocks_match_jax(dense, field, symmetric):
    m = dense.mats[field]
    r = _rhs(field, dense.topo_t.n_cells, 6)
    for jf, tf, name in ((jpc._solve_T, tpc._solve_T, "_solve_T"),
                         (jpc._solve_F, tpc._solve_F, "_solve_F")):
        want = jf(_jm(m), jnp.asarray(r), dense.topo_j,
                  jnp.asarray(dense.vol),
                  symmetric=symmetric, iters=15)
        got = tf(_tmat(m), torch.from_numpy(r), dense.topo_t,
                 torch.from_numpy(dense.vol), symmetric=symmetric, iters=15)
        assert_close(got, want, 1e-10, f"{name} {field}")


@pytest.fixture(scope="module")
def pc_setup(case):
    """The port's PC matrices, scales and scaled residual operator at the
    case state, and their JAX copies."""
    s, it = case.s, case.it
    geom = s.geometry(it)
    mats = s._pc_matrices(case.wt, it, geom)
    scales = s.state_scales(geom)
    f_vjp = tadj.vjp(lambda w: s._norm_residuals(w, it), case.wt)[1]

    def matT_t(psi):
        return tadj._scale(f_vjp(tadj._scale(psi, scales, invert=True)),
                           scales)

    def matT_j(psi):    # the same operator for dafoam_tpu's PCs
        out = matT_t({k: torch.from_numpy(np.asarray(v))
                      for k, v in psi.items()})
        return _j(_np(out))

    mats_j = {k: (jfvx.FvMatrix(*(jnp.asarray(a.numpy()) for a in m)), sym)
              for k, (m, sym) in mats.items()}
    return SimpleNamespace(
        mats=mats, mats_j=mats_j, geom=geom,
        geom_j=SimpleNamespace(vol=jnp.asarray(geom.vol.numpy())),
        scales=scales, scales_j=_j(_np(scales)), matT_t=matT_t,
        matT_j=matT_j)


@pytest.mark.parametrize("pc_type", ["segregated", "lineJacobi",
                                     "coupledLine"])
def test_adjoint_pc_matches_jax(case, dense, pc_setup, pc_type):
    ps = pc_setup
    opt = {"pcType": pc_type, "pcInnerIters": 15, "pcADISweeps": 1,
           "pcCoupledSweeps": 2}
    pj = jpc.build_pc(ps.mats_j, dense.topo_j, ps.geom_j, ps.scales_j, opt)
    pt = tpc.build_pc(ps.mats, case.s.topo, ps.geom, ps.scales, opt)
    assert getattr(pt, "needs_opT", False) == (pc_type != "segregated")
    if pc_type != "segregated":
        pj, pt = pj(ps.matT_j), pt(ps.matT_t)
    want = pj(_j(case.v))
    got = pt(convert.state_from_numpy(case.v, "cpu", torch.float64))
    for k in want:
        assert_close(got[k], want[k], 1e-10, f"{pc_type} PC {k}")
    if pc_type == "segregated":     # the same blocks through make_block_pc
        got2 = tpc.make_block_pc(ps.mats, case.s.topo, ps.geom,
                                 state_scales=ps.scales, iters=15)(
            convert.state_from_numpy(case.v, "cpu", torch.float64))
        for k in want:
            assert_close(got2[k], want[k], 1e-10, f"make_block_pc {k}")


@pytest.mark.parametrize("pc_type", ["segregated", "coupledLine"])
def test_forward_pc_matches_jax(case, dense, pc_setup, pc_type):
    ps = pc_setup
    # 5 sweeps, not the default 30: BiCGStab stagnates on the forward
    # nuTilda block with this right-hand side, and from its sixth
    # iteration on it amplifies the packages' different summation orders
    # ~1e2x per iteration (measured: 2e-16 after 5, 3e-3 after 15)
    opt = {"pcType": pc_type, "pcFwdInnerIters": 5}
    want = jpc.build_forward_pc(ps.mats_j, dense.topo_j, ps.geom_j, opt)(
        _j(case.v))
    got = tpc.build_forward_pc(ps.mats, case.s.topo, ps.geom, opt)(
        convert.state_from_numpy(case.v, "cpu", torch.float64))
    for k in want:
        assert_close(got[k], want[k], 1e-10, f"forward {pc_type} PC {k}")


# ---------------------------------------------------------------------------
# the residual-form solvers on a small nonlinear system
# ---------------------------------------------------------------------------

def _toy(lib, asarray):
    """R(w, x) = w - tanh(M w + P x) on state {"b": (4, 2), "a": (6,)} and
    inputs {"x": (3,)}, an objective J(w, x), a design perturbation and a
    per-field block inverse, in either package."""
    rng = np.random.default_rng(5)
    M = rng.standard_normal((14, 14))
    M = asarray(0.9 * M / np.linalg.norm(M, 2))
    P = asarray(rng.standard_normal((14, 3)))

    def flat(w):
        return lib.concatenate([w["a"].reshape(-1), w["b"].reshape(-1)])

    def res(w, x):
        v = lib.tanh(M @ flat(w) + P @ x["x"])
        return {"a": w["a"] - v[:6], "b": w["b"] - v[6:].reshape(4, 2)}

    def func(w, x):
        return (w["a"] ** 2).sum() * x["x"][0] + w["b"].sum() * x["x"][1]

    state = {"a": asarray(rng.standard_normal(6)),
             "b": asarray(rng.standard_normal((4, 2)))}
    inputs = {"x": asarray(rng.standard_normal(3))}
    dx = {"x": asarray(rng.standard_normal(3))}
    blockinvs = {"a": lambda r: 0.8 * r}
    return res, func, state, inputs, dx, blockinvs


class _TorchLib:
    tanh = staticmethod(torch.tanh)
    concatenate = staticmethod(torch.cat)


@pytest.mark.parametrize("pc", ["block", "coupled"])
def test_residual_solvers_match_jax_on_a_small_system(pc):
    jr, jf, jw, jx, jdx, jb = _toy(jnp, jnp.asarray)
    tr, tf, tw, tx, tdx, tb = _toy(_TorchLib, torch.from_numpy)
    jg = jax.grad(lambda w: jf(w, jx))(jw)
    tg = tadj.dJdW_of(tf, tw, tx)
    scj = {"a": jnp.asarray(2.0), "b": jnp.asarray(0.5)}
    sct = {"a": torch.tensor(2.0, dtype=torch.float64),
           "b": torch.tensor(0.5, dtype=torch.float64)}
    if pc == "block":
        pcj = lambda r: {"a": 0.8 * r["a"], "b": -r["b"]}  # noqa: E731
        pct = lambda r: {"a": 0.8 * r["a"], "b": -r["b"]}  # noqa: E731
    else:
        pcj = jpc.make_coupled_pc(jb, state_scales=scj, sweeps=3,
                                  identity_fields=())
        pct = tpc.make_coupled_pc(tb, state_scales=sct, sweeps=3,
                                  identity_fields=())
    kw = dict(restart=6, rel_tol=1e-12, abs_tol=1e-30, max_iters=100,
              deflate=2)
    pj, ij = jadj.adjoint_solve(jr, jw, jx, jg, state_scales=scj,
                                res_scales=scj, precond=pcj, **kw)
    pt, it = tadj.adjoint_solve(tr, tw, tx, tg, state_scales=sct,
                                res_scales=sct, precond=pct, **kw)
    assert it.converged and it.iters == int(ij.iters), (it, ij)
    for k in pj:
        assert_close(pt[k], pj[k], 1e-10, f"psi {k}")
    # the recycle space goes out and back in, as in the fixed-point route
    p2, i2, aug = tadj.adjoint_solve(tr, tw, tx, tg, state_scales=sct,
                                     res_scales=sct, precond=pct,
                                     return_aug=True, **kw)
    assert aug.shape == (2, 14) and i2.iters == it.iters
    p3, i3 = tadj.adjoint_solve(tr, tw, tx, tg, state_scales=sct,
                                res_scales=sct, precond=pct, aug0=aug, **kw)
    assert i3.converged
    for k in pj:
        assert_close(p3[k], pj[k], 1e-9, f"psi {k} from aug0")
    tot_j = jadj.total_derivative(jr, jf, jw, jx, pj)
    tot_t = tadj.total_derivative(tr, tf, tw, tx, pt)
    assert_close(tot_t["x"], tot_j["x"], 1e-10, "totals")
    # the tangent solve takes a plain (not needs_opT) preconditioner
    fpj, fpt = (pcj, pct) if pc == "block" else (None, None)
    dj, fij = jadj.forward_total_derivative(
        jr, jf, jw, jx, jdx, restart=6, rel_tol=1e-12, precond=fpj,
        state_scales=scj, res_scales=scj)
    dt, fit = tadj.forward_total_derivative(
        tr, tf, tw, tx, tdx, restart=6, rel_tol=1e-12, precond=fpt,
        state_scales=sct, res_scales=sct)
    assert fit.iters == int(fij.iters)
    assert_close(dt, dj, 1e-10, "tangent dJ")
    # the adjoint's totals and the tangent agree
    adj = float((tot_t["x"] * tdx["x"]).sum())
    assert abs(float(dt) - adj) <= 1e-10 * abs(adj)


# ---------------------------------------------------------------------------
# the implicit rule of fvsolve.solve and the line smoother's transpose
# ---------------------------------------------------------------------------

# (field, symmetric, pc): p by CG, U by BiCGStab (the port component-major
# with a per-component diagonal, JAX cell-major), p with the line PC
IMPLICIT = [("p", True, "jacobi"), ("U", False, "jacobi"),
            ("p", True, "line")]


@pytest.mark.parametrize("field,symmetric,pc", IMPLICIT)
def test_implicit_solve_vjp_jvp_match_jax(dense, field, symmetric, pc):
    m, psi0 = dense.mats[field], dense.st[field]
    rng = np.random.default_rng(8)
    ct = rng.standard_normal(psi0.shape)
    tang = [rng.standard_normal(np.shape(a)) for a in m]
    kw = dict(symmetric=symmetric, rel_tol=0.02, max_iters=200, pc=pc)

    @jax.jit
    def jax_rules(parts, c, t):
        def f(*p):
            return jfs.solve(jfvx.FvMatrix(*p), jnp.asarray(psi0),
                             dense.topo_j, **kw)[0]
        x, f_vjp = jax.vjp(f, *parts)
        _, xdot = jax.jvp(f, tuple(parts), tuple(t))
        return x, f_vjp(c), xdot

    xj, bars_j, dot_j = jax_rules(tuple(jnp.asarray(a) for a in m),
                                  jnp.asarray(ct),
                                  tuple(jnp.asarray(a) for a in tang))
    parts = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in m]
    xt, _ = tfs.solve(tfvx.FvMatrix(*parts), torch.from_numpy(psi0),
                      dense.topo_t, **kw)
    assert_close(xt, xj, 1e-10, f"{field} solve")
    bars_t = torch.autograd.grad(xt, parts, torch.from_numpy(ct))
    for name, g, w in zip(("diag", "lower", "upper", "source"), bars_t,
                          bars_j):
        assert_close(g, w, 1e-8, f"{field} {pc} vjp {name}")
    import torch.autograd.forward_ad as fwAD
    with torch.no_grad(), fwAD.dual_level():
        duals = [fwAD.make_dual(p.detach(), torch.from_numpy(t))
                 for p, t in zip(parts, tang)]
        xd, _ = tfs.solve(tfvx.FvMatrix(*duals), torch.from_numpy(psi0),
                          dense.topo_t, **kw)
        dot_t = fwAD.unpack_dual(xd).tangent
    assert_close(dot_t, dot_j, 1e-8, f"{field} {pc} jvp")


def test_line_smoother_transpose_matches_jax(dense):
    m, psi0 = dense.mats["p"], dense.st["p"]
    ct = np.random.default_rng(9).standard_normal(psi0.shape)

    @jax.jit
    def jax_vjp(parts, x0, c):
        def f(*p):
            return jfs.solve_fixed(jfvx.FvMatrix(*p[:4]), p[4],
                                   dense.topo_j, symmetric=True, n_iters=20,
                                   smoother="line")
        x, f_vjp = jax.vjp(f, *parts, x0)
        return x, f_vjp(c)

    xj, bars_j = jax_vjp(tuple(jnp.asarray(a) for a in m),
                         jnp.asarray(psi0), jnp.asarray(ct))
    parts = [torch.from_numpy(np.array(a)).requires_grad_(True)
             for a in (*m, psi0)]
    xt = tfs.solve_fixed(tfvx.FvMatrix(*parts[:4]), parts[4], dense.topo_t,
                         symmetric=True, n_iters=20, smoother="line")
    assert_close(xt, xj, 1e-10, "line smoother")
    bars_t = torch.autograd.grad(xt, parts, torch.from_numpy(ct))
    for name, g, w in zip(("diag", "lower", "upper", "source", "psi0"),
                          bars_t, bars_j):
        assert_close(g, w, 1e-10, f"line smoother vjp {name}")
