"""CHT and FSI coupling of dafoam_tpu_torch against dafoam_tpu (CPU, f64),
on the cases of tests/test_cht.py (12x6 channel over a 12x4 slab) and
tests/test_fsi.py (10x5 channel over a 10x3 plate), both face layouts:

- the block Gauss-Seidel coupled primal at pinned counts (one outer
  iteration, each side taking the other's data once: 10 SIMPLE
  iterations, inner solves to 1e-12, the FSI plate's 8 Picard
  iterations) at 1e-10, with the interface data (CHT: the mismatch of
  the interface temperatures; FSI: the interface displacement);
- the monolithic coupled adjoint at dafoam_tpu's state, carried over with
  convert.py and, on the dense layout, to_layout, its solid state moved
  by seeded noise of 1e-6 of its normalizeStates scale: the coupled
  residual R(W) at 1e-10 and dJ/dW at 1e-12; the port's product
  dR/dW^T v at a seeded random v, every block including the coupling's
  cross blocks, equal to dafoam_tpu's at 1e-10; the port's psi solving
  dafoam_tpu's system, |S (dR/dW^T psi - dJ/dW)| <= 1e-7 |S dJ/dW| with
  both products dafoam_tpu's (S: the normalizeStates metric the solve
  runs in); and the
  port's totals with respect to both sides' inputs equal to dafoam_tpu's
  dJ/dx - psi^T dR/dx at that psi at 1e-8 (a total that cancels below
  1e-4 of its side's largest at 1e-12 of the largest).

The noise keeps every face off a kink. At the unmoved CHT state two
pairs of slab cells have equal T to rounding; there the limiter of the
laplacian's explicit non-orthogonal correction (fvm._limit_correction)
acts on a correction that is rounding noise, and its derivative, a whole
face conductance, takes that noise's sign: dafoam_tpu's jitted and eager
vjps differ there by 129 of 3.7e4, and v^T dR/dW by 800 of 4.5e4.

dafoam_tpu's side runs under jax.jit, once per case (module fixture): its
coupled primal with the interface data, and one function of psi; its
compute_geometry is jitted too (test_torch_cases.jax_geometry_jitted).
"""

import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.adjoint.solver import _grad, _requiring_grad, vjp
from dafoam_tpu_torch.coupling import cht as cht_mod
from dafoam_tpu_torch.examples import cht_heated_plate as cht_ex
from dafoam_tpu_torch.examples import fsi_flexible_wall as fsi_ex
from dafoam_tpu_torch.linalg.krylov import tnorm
from dafoam_tpu_torch.utils import tree
from test_torch_cases import (LAYOUTS, assert_close, from_layout,
                              jax_geometry_jitted, to_layout)

torch.set_num_threads(1)
F64 = torch.float64
N_OUTER = 1
N_SIMPLE = 10
ADJ = {"restart": 600, "rel_tol": 1e-12, "max_iters": 600}
# inner solves to 1e-12 (tests/test_cht.py's): a solve that stops early
# or runs past its convergence would amplify rounding step by step
TIGHT = {"pMaxIters": 500, "pRelTol": 1e-12, "uMaxIters": 300,
         "uRelTol": 1e-12, "turbMaxIters": 300, "turbRelTol": 1e-12}
NOISE = 1e-6

# the heat-transfer primal is linear: its loop stops after its first
# exact solve instead of running to its cap of 100 against 1e-10
SOLID_OVER = {"cht": {"primalMinResTol": 1e-6},
              "fsi": {"primalMinResTol": 0.0, "primalMaxIters": 8}}
CASES = {"cht": ("fluid", "Tout", ("bc", "T", "ymin")),
         "fsi": ("fluid", "drag", ("params", "E"))}


def _pin(opts, iters):
    return dict(opts, primalMinResTol=0.0, primalMaxIters=iters,
                primalLinearSolver=dict(TIGHT))


def jax_coupling(case):
    """tests/test_cht.py:build / tests/test_fsi.py:build with the fluid's
    counts pinned (the port's examples keep a copy of their options)."""
    from dafoam_tpu.coupling import CHTCoupling, FSICoupling
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.solvers import make_solver

    if case == "cht":
        ex, make = cht_ex, CHTCoupling
        pts_f, topo_f = box_hex_mesh(12, 6, 1, (1.0, 0.1, 0.01),
                                     kinds={"zmin": "empty", "zmax": "empty",
                                            "ymin": "wall", "ymax": "wall"})
        pts_s, topo_s = box_hex_mesh(12, 4, 1, (1.0, 0.05, 0.01),
                                     kinds={"zmin": "empty",
                                            "zmax": "empty"})
        pts_s = pts_s.copy()
        pts_s[:, 1] -= 0.05
    else:
        ex, make = fsi_ex, FSICoupling
        (pts_f, topo_f), (pts_s, topo_s) = fsi_ex.meshes(box=box_hex_mesh)
    fluid = make_solver(_pin(ex.fluid_options(), N_SIMPLE), topo_f, pts_f)
    solid = make_solver(ex.solid_options(**SOLID_OVER[case]), topo_s, pts_s)
    return make(fluid, solid, "ymin", "ymax")


def torch_coupling(case, layout):
    kw = {"fluid_over": _pin({"meshFaceLayout": layout}, N_SIMPLE),
          "solid_over": dict(SOLID_OVER[case], meshFaceLayout=layout)}
    if case == "cht":
        fluid, solid = cht_ex.build("cpu", F64, **kw)
        return cht_mod.CHTCoupling(fluid, solid, "ymin", "ymax")
    return fsi_ex.build("cpu", F64, **kw)


def _np_tree(t):
    import jax
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def jax_side():
    """dafoam_tpu's coupled primal per case, the state the adjoint is
    held at, a seeded random v, and one jitted function of psi: (R(W),
    dJ/dW, (dJ/dx_f, dJ/dx_s), (psi^T dR/dW, psi^T dR/dx_f, psi^T
    dR/dx_s), v^T dR/dW) there."""
    import jax
    import jax.numpy as jnp

    with jax_geometry_jitted():
        yield _jax_side(jax, jnp)


def _jax_side(jax, jnp):
    out = {}
    for case, (side, func, _) in CASES.items():
        cpl = jax_coupling(case)
        f, s = cpl.fluid, cpl.solid
        inf, ins = f.make_inputs(), s.make_inputs()

        def primal(inf, ins, cpl=cpl, case=case):
            sf, ss, _ = cpl.solve_primal(cpl.fluid.init_state(),
                                         cpl.solid.init_state(), inf, ins,
                                         n_outer=N_OUTER)
            diag = cpl.interface_mismatch(sf, ss, inf, ins) \
                if case == "cht" else \
                jnp.max(jnp.abs(cpl._solid_disp_b(ss, ins)))
            return sf, ss, diag

        sf, ss, diag = _np_tree(jax.jit(primal)(inf, ins))
        rng = np.random.default_rng(0)
        ns = s.option["normalizeStates"]
        ss_adj = {k: v + NOISE * ns[k] * rng.standard_normal(v.shape)
                  for k, v in ss.items()}

        def J(w, xf, xs, cpl=cpl, side=side, func=func, case=case):
            if case == "fsi":
                return cpl.eval_function(w, xf, xs, side, func)
            a, b = cpl._apply_coupling(xf, xs, w["fluid"], w["solid"])
            return cpl.fluid.eval_function(func, w["fluid"], a)

        def products(W, xf, xs, psi, v, cpl=cpl, J=J):
            dJ = jax.grad(J, argnums=(0, 1, 2))(W, xf, xs)
            r, f_vjp = jax.vjp(cpl.residuals, W, xf, xs)
            return r, dJ[0], dJ[1:], f_vjp(psi), f_vjp(v)[0]

        fn = jax.jit(products)
        W = {"fluid": sf, "solid": ss_adj}
        v = jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape),
                                   W)
        out[case] = {"sf": sf, "ss": ss, "ss_adj": ss_adj, "v": v,
                     "diag": float(diag), "nf": f.topo.n_faces,
                     "products": lambda psi, fn=fn, W=W, v=v, inf=inf,
                     ins=ins: _np_tree(fn(W, inf, ins, psi, v))}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", list(CASES))
def test_coupled_primal_and_totals(jax_side, case, layout):
    want = jax_side[case]
    cpl = torch_coupling(case, layout)
    f, s = cpl.fluid, cpl.solid
    inf, ins = f.make_inputs(), s.make_inputs()

    # coupled primal at pinned counts
    sf, ss, (info_f, info_s) = cpl.solve_primal(
        f.init_state(), s.init_state(), inf, ins, n_outer=N_OUTER)
    assert info_f.iters == N_SIMPLE and not info_f.failed
    got_f = from_layout(sf, f.topo)
    for k, v in want["sf"].items():
        assert_close(got_f[k], v, 1e-10, f"{case} fluid {k}")
    for k, v in want["ss"].items():
        assert_close(ss[k], v, 1e-10, f"{case} solid {k}")
    diag = cpl.interface_mismatch(sf, ss, inf, ins) if case == "cht" \
        else cpl.interface_displacement(ss, ins)
    assert abs(float(diag) - want["diag"]) <= 1e-10 * max(want["diag"],
                                                          1e-8)
    if case == "fsi":
        assert want["diag"] > 1e-9          # the plate deflects

    # the coupled residual and adjoint at dafoam_tpu's state, the solid's
    # moved off the limiter's kink
    def carried(fluid_np, solid_np):
        return {"fluid": convert.state_from_numpy(
                    to_layout(fluid_np, f.topo, want["nf"]), "cpu", F64),
                "solid": convert.state_from_numpy(solid_np, "cpu", F64)}

    W = carried(want["sf"], want["ss_adj"])
    side, func, leaf = CASES[case]
    tf, ts, info, psi = cpl.solve_adjoint(W["fluid"], W["solid"], inf, ins,
                                          side, func, return_psi=True,
                                          **ADJ)
    assert info.converged, info
    to_np = {"fluid": lambda t: from_layout(t, f.topo),
             "solid": convert.state_to_numpy}
    psi_np = {sd: to_np[sd](psi[sd]) for sd in psi}
    jr, jdJdW, (dJf, dJs), (jrw, rx_f, rx_s), jrv = \
        want["products"](psi_np)

    with torch.no_grad():
        r = cpl.residuals(W, inf, ins)
    w = _requiring_grad(W)
    with torch.enable_grad():
        J = cpl.eval_function(w, inf, ins, side, func)
    dJdW = _grad(J, w)
    _, f_vjp = vjp(lambda ww: cpl.residuals(ww, inf, ins), W)
    rv = f_vjp(carried(want["v"]["fluid"], want["v"]["solid"]))
    for sd in ("fluid", "solid"):
        for got, ref, what in ((r, jr, "R"), (dJdW, jdJdW, "dJ/dW"),
                               (rv, jrv, "v^T dR/dW")):
            bar = 1e-12 if what == "dJ/dW" else 1e-10
            for k, t in to_np[sd](got[sd]).items():
                assert_close(t, ref[sd][k], bar, f"{case} {what} {sd} {k}")

    # psi solves dafoam_tpu's system in the normalizeStates metric: its
    # true residual, not GMRES's estimate (<= 1e-12)
    scales = cht_mod.state_scales(f, s, inf, ins)
    b = cht_mod._scale_tree(carried(jdJdW["fluid"], jdJdW["solid"]), scales)
    res = tree.tmap(torch.sub, cht_mod._scale_tree(
        carried(jrw["fluid"], jrw["solid"]), scales), b)
    assert float(tnorm(res)) <= 1e-7 * float(tnorm(b))

    # the totals: dafoam_tpu's dJ/dx - psi^T dR/dx at the port's psi
    for got, dj, rx, what in ((tf, dJf, rx_f, "fluid"),
                              (ts, dJs, rx_s, "solid")):
        g, w, rxf = _flat(convert.inputs_to_numpy(got)), _flat(dj), \
            _flat(rx)
        assert g.keys() == w.keys(), (what, g.keys() ^ w.keys())
        tot = {k: w[k] - rxf[k] for k in w}
        top = max(float(np.max(np.abs(t))) for t in tot.values())
        for k in w:
            # a total that cancels to ~0 (dTout/dp_outlet: 6e-11) is held
            # at 1e-12 of the side's largest total instead of its own size
            scale = max(float(np.max(np.abs(tot[k]))), 1e-4 * top)
            err = float(np.max(np.abs(g[k] - tot[k])))
            assert err <= 1e-8 * scale, (case, what, k, err, scale)
    # the total the reference test checks against FD
    node = ts
    for k in leaf:
        node = node[k]
    assert torch.isfinite(node).all() and float(node.abs().sum()) > 0.0
