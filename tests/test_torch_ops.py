"""FV layer of dafoam_tpu_torch against dafoam_tpu, both face layouts, f64.

Geometry, boundary coefficients, the core face sums, fvc/fvm operators,
FvMatrix algebra, the turbulence-model terms, the state layout and the
Krylov solvers are evaluated on the same inputs
(the 32x12 NACA0012 O-mesh, fields made from a numpy seed) in both
packages. Each package's side runs as one program per layout (the JAX side
jitted, so it compiles once). Bar: 1e-12 relative to each result's max
norm; the Krylov solvers, pinned to fixed trip counts (rel_tol 0), 1e-10.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_cases import (LAYOUTS, assert_close, omesh_jax, omesh_torch,
                              to_numpy)

torch.set_num_threads(1)

U_SPEC = {"far": {"type": "inletOutlet"}, "wing": {"type": "fixedValue"},
          "zmin": {"type": "empty"}, "zmax": {"type": "empty"}}
P_SPEC = {"far": {"type": "fixedValue"}, "wing": {"type": "zeroGradient"},
          "zmin": {"type": "empty"}, "zmax": {"type": "empty"}}
NUT_SPEC = {"far": {"type": "inletOutlet"}, "wing": {"type": "fixedValue"},
            "zmin": {"type": "empty"}, "zmax": {"type": "empty"}}


def _data(topo, points):
    rng = np.random.default_rng(21)
    nc, nf, nb = topo.n_cells, topo.n_faces, topo.n_boundary
    return {
        "points": np.asarray(points, np.float64),
        "U": rng.standard_normal((nc, 3)) + np.array([1.0, 0.0, 0.0]),
        "p": rng.standard_normal(nc),
        "phi": rng.standard_normal(nf),
        "gamma_f": 1e-3 + rng.random(nf),
        "coef": rng.standard_normal(nc),
        "vals_i": rng.standard_normal((topo.n_internal, 3)),
        "vals_b": rng.standard_normal((nb, 3)),
        "x": rng.standard_normal(nc),
        "U_far": np.array([1.0, 0.1, 0.0]),
        "p_far": np.asarray(0.3),
        "nuTilda": 3e-3 * (0.2 + rng.random(nc)),
        "nu": np.asarray(1e-3),
        "wall_dist": 0.01 + rng.random(nc),
        "cells": rng.integers(0, nc, size=3 * nc),
        "cell_vals": rng.standard_normal((3 * nc, 3)),
    }


def _program(pkg, topo, d):
    """Every op under test, through one package's modules. ``pkg`` is the
    package's namespace of modules; ``d`` its dict of arrays."""
    core, bc, fvc, fvm, fvx = pkg["core"], pkg["bc"], pkg["fvc"], \
        pkg["fvm"], pkg["fvx"]
    ni = topo.n_internal
    out = {}
    geom = pkg["compute_geometry"](d["points"], topo)
    for f in geom._fields:
        out["geom." + f] = getattr(geom, f)
    U, p, phi = d["U"], d["p"], d["phi"]
    ubco = bc.coeffs(U_SPEC, {"far": d["U_far"]}, topo, geom, U, rank=1,
                     phi_b=phi[ni:])
    pbco = bc.coeffs(P_SPEC, {"far": d["p_far"]}, topo, geom, p, rank=0,
                     phi_b=phi[ni:])
    for name, bco in (("U", ubco), ("p", pbco)):
        for f in bco._fields:
            out[f"bc.{name}.{f}"] = getattr(bco, f)
    U_b = bc.boundary_value(ubco, U, topo)
    p_b = bc.boundary_value(pbco, p, topo)
    out["bc.U_b"], out["bc.p_b"] = U_b, p_b
    out["bc.sng_U"] = bc.boundary_sngrad(ubco, U, topo)
    # core
    out["core.fss"] = core.face_sum_signed(d["vals_i"], topo)
    out["core.fsp"] = core.face_sum_pair(d["vals_i"], 2.0 * d["vals_i"], topo)
    out["core.own"] = core.cell_to_face_own(U, topo)
    out["core.nei"] = core.cell_to_face_nei(U, topo)
    out["core.bgather"] = core.boundary_gather(U, topo)
    out["core.bscatter"] = core.boundary_scatter_add(U, d["vals_b"], topo)
    out["core.ssum"] = core.surface_sum(d["vals_i"], d["vals_b"], topo,
                                        active_b=ubco.active)
    # fvc
    out["fvc.interp"] = fvc.interpolate(geom, topo, U, U_b)
    gradU = fvc.grad(geom, topo, U, U_b)
    out["fvc.gradU"], out["fvc.gradp"] = gradU, fvc.grad(geom, topo, p, p_b)
    out["fvc.div_surface"] = fvc.div_surface(geom, topo, phi)
    out["fvc.flux"] = fvc.flux(geom, topo, U, U_b)
    out["fvc.div_tensor"] = fvc.div_tensor(geom, topo, gradU,
                                           core.boundary_gather(gradU, topo))
    out["fvc.snGrad"] = fvc.snGrad(geom, topo, p,
                                   bc.boundary_sngrad(pbco, p, topo))
    # fvm
    mats = {
        "divU": fvm.div(geom, topo, phi, U, ubco, scheme="upwind",
                        bounded=True),
        "divp": fvm.div(geom, topo, phi, p, pbco, scheme="upwind",
                        bounded=True),
        "lapp": fvm.laplacian(geom, topo, d["gamma_f"], p, pbco),
        "lapU": fvm.laplacian(geom, topo, d["gamma_f"], U, ubco,
                              grad_psi=gradU),
        "Sp": fvm.Sp(geom, topo, d["coef"], p),
    }
    for k, m in mats.items():
        for f in m._fields:
            out[f"fvm.{k}.{f}"] = getattr(m, f)
    out["fvm.lapflux"] = fvm.laplacian_flux(geom, topo, d["gamma_f"], p, pbco)
    # FvMatrix algebra
    mU = fvx.relax(mats["divU"] - mats["lapU"], U, 0.5, topo)
    mp = fvx.set_reference(mats["lapp"] - mats["Sp"], 0, 0.0)
    for f in mU._fields:
        out["fvx.relaxU." + f] = getattr(mU, f)
    out["fvx.matvecU"] = fvx.matvec(mU, U, topo)
    out["fvx.matvecp"] = fvx.matvec(mp, d["x"], topo)
    out["fvx.H"] = fvx.H(mU, U, geom, topo)
    out["fvx.A"] = fvx.A(mU, geom)
    out["fvx.H1"] = fvx.H1(mU, geom, topo)
    out["fvx.residual"] = fvx.residual(mp, d["x"], geom, topo)
    out["fvx.setref.diag"], out["fvx.setref.source"] = mp.diag, mp.source
    out["fvsolve.res0"] = pkg["fvsolve"].initial_residual_norm(
        mU, U, topo, rhs=d["vals_b"][:topo.n_cells] * 0.0 + U)
    out["core.scatter_add"] = core.scatter_add(d["cell_vals"], d["cells"],
                                               topo.n_cells)
    # turbulence models
    inputs = {"params": {"nu": d["nu"]},
              "bc": {"nuTilda": {"far": 3e-3, "wing": 0.0}}}
    st = {"U": U, "p": p, "phi": phi, "nuTilda": d["nuTilda"]}
    lam = pkg["Laminar"](topo, {}, wall_dist=d["wall_dist"])
    out["lam.nut_b"] = lam.nut_boundary(st, inputs, geom)
    for name in ("SA", "SAFv3"):
        model = pkg[name](topo, {}, wall_dist=d["wall_dist"],
                          bc_spec={"nuTilda": NUT_SPEC})
        model.setup_wall_functions({})
        stilda, fw, _ = model._stilda_fw(st, inputs, geom, gradU)
        out[f"{name}.stilda"], out[f"{name}.fw"] = stilda, fw
        out[f"{name}.nut_b"] = model.nut_boundary(st, inputs, geom)
        mt = model._assemble(st, inputs, geom, phi, gradU)
        for f in mt._fields:
            out[f"{name}.eq.{f}"] = getattr(mt, f)
        md = model.divdevreff(U, st, inputs, geom, ubco)
        for f in md._fields:
            out[f"{name}.divdevreff.{f}"] = getattr(md, f)
    layout = pkg["StateLayout"](pkg["StateInfo"](("U",), ("p",), ("nuTilda",),
                                                 ("phi",)),
                                topo.n_cells, topo.n_faces)
    out["states.pack"] = layout.pack(st)
    return out, mU, mp


def _jax_pkg():
    from dafoam_tpu.linalg import fvsolve
    from dafoam_tpu.mesh.geometry import compute_geometry
    from dafoam_tpu.models import Laminar, SpalartAllmaras, SpalartAllmarasFv3
    from dafoam_tpu.ops import bc, core, fvc, fvm
    from dafoam_tpu.ops import fvmatrix as fvx
    from dafoam_tpu.states import StateInfo, StateLayout
    return dict(core=core, bc=bc, fvc=fvc, fvm=fvm, fvx=fvx, fvsolve=fvsolve,
                compute_geometry=compute_geometry, Laminar=Laminar,
                SA=SpalartAllmaras, SAFv3=SpalartAllmarasFv3,
                StateInfo=StateInfo, StateLayout=StateLayout)


def _torch_pkg():
    from dafoam_tpu_torch.linalg import fvsolve
    from dafoam_tpu_torch.mesh.geometry import compute_geometry
    from dafoam_tpu_torch.models import (Laminar, SpalartAllmaras,
                                         SpalartAllmarasFv3)
    from dafoam_tpu_torch.ops import bc, core, fvc, fvm
    from dafoam_tpu_torch.ops import fvmatrix as fvx
    from dafoam_tpu_torch.states import StateInfo, StateLayout
    return dict(core=core, bc=bc, fvc=fvc, fvm=fvm, fvx=fvx, fvsolve=fvsolve,
                compute_geometry=compute_geometry, Laminar=Laminar,
                SA=SpalartAllmaras, SAFv3=SpalartAllmarasFv3,
                StateInfo=StateInfo, StateLayout=StateLayout)


def _topos(layout):
    from dafoam_tpu.mesh.topology import to_dia_dense as jdense
    from dafoam_tpu_torch.mesh.topology import to_dia_dense as tdense
    pj, tj = omesh_jax()
    pt, tt = omesh_torch()
    if layout == "diaDense":
        tj, tt = jdense(tj), tdense(tt)
    return (pj, tj), (pt, tt)


@pytest.fixture(scope="module", params=LAYOUTS)
def results(request):
    (pj, tj), (pt, tt) = _topos(request.param)
    data = _data(tj, pj)
    jpkg = _jax_pkg()
    jout = to_numpy(jax.jit(lambda d: _program(jpkg, tj, d)[0])(data))
    tdata = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    tout, mU, mp = _program(_torch_pkg(), tt, tdata)
    return jout, tout, (tj, tt, mU, mp, tdata)


def test_ops_match(results):
    jout, tout, _ = results
    assert set(jout) == set(tout)
    bad = []
    for k in sorted(jout):
        try:
            assert_close(tout[k], jout[k], 1e-12, k)
        except AssertionError as e:
            bad.append(str(e))
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_krylov_fixed_trip_counts(results, solver):
    """cg on the (negative definite) pressure-like matrix, bicgstab on the
    relaxed momentum matrix component-major, 12 iterations each."""
    from dafoam_tpu.linalg import krylov as jk
    from dafoam_tpu.ops import fvmatrix as jfvx
    from dafoam_tpu_torch.linalg import krylov as tk
    from dafoam_tpu_torch.ops import fvmatrix as tfvx
    _, _, (tj, tt, mU, mp, d) = results
    if solver == "cg":
        m, cm, b = mp, False, d["x"]
    else:
        m, cm, b = mU, True, d["U"].t().contiguous()
    mj = jfvx.FvMatrix(*(np.asarray(a) for a in m))
    dinv = 1.0 / (m.diag if m.diag.ndim == 1 else m.diag.t().contiguous())
    dinv_j = np.asarray(dinv)

    def jrun(bb):
        if cm:   # JAX's solve of this matrix is cell-major (vector diag)
            mv = jfvx.matvec_fn(mj, tj, pallas=False)
            f = (lambda v: mv(v.T).T)
        else:
            f = jfvx.matvec_fn(mj, tj, pallas=False)
        return getattr(jk, solver)(f, bb, precond=lambda r: dinv_j * r,
                                   rel_tol=0.0, max_iters=12)

    xj, ij = jax.jit(jrun)(np.asarray(b))
    xt, it = getattr(tk, solver)(
        tfvx.matvec_fn(m, tt, component_major=cm), b,
        precond=lambda r: dinv * r, rel_tol=0.0, max_iters=12)
    assert int(ij.iters) == it.iters == 12
    assert_close(xt, np.asarray(xj), 1e-10, solver)
    assert abs(it.resid - float(ij.resid)) <= 1e-10 * float(ij.resid0)
