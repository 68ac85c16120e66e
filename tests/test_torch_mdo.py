"""P10's geometry and optimization layer of dafoam_tpu_torch against
dafoam_tpu (CPU, f64):

- FFDBox: the embedding operator, apply and its vjp at 1e-14, on
  tests/test_mdo.py's random cloud;
- IDWarp: the neighbour table identical, the weights at 1e-14, apply and
  its vjp at 1e-13, on the random cloud and on the 10x10 cavity's lid (the
  DAFoamWarper set-up; its equal distances make ties), with the host build
  split into blocks of 7 rows;
- InputRegistry: every inputInfo type's size and apply at 1e-15, and the
  vjp of the two that stack components;
- ShapeOptProblem on the cavity with an FFD box on the lid: eval_all
  and grad at 1e-8 on both layouts, two SLSQP iterations' history at 1e-8
  on the canonical one (dafoam_tpu runs once, in a module fixture), and
  grad equal to FFD's B^T applied to the points totals;
- mesh/check.py: the report against dafoam_tpu's on the cavity and on
  the FFD-deformed cavity, on both face layouts, and a tangled mesh
  failing the gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cases import LAYOUTS, assert_close, jax_geometry_jitted

torch.set_num_threads(1)
F64 = torch.float64
N = 10
WALLS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall", "ymax": "wall"}
FFD_BOUNDS = ([-0.001, 0.07, -1.0], [0.101, 0.13, 1.01])
DV_BOUND = 0.003


def cavity_options(layout="canonical"):
    """tests/test_mphys.py's cavity (lidForce, residual-form adjoint)."""
    zero = [0.0, 0.0, 0.0]
    return {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 0.01},
        "boundaryConditions": {
            "U": {"ymax": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "xmin": {"type": "fixedValue", "value": zero},
                  "xmax": {"type": "fixedValue", "value": zero}},
            "p": {n: {"type": "zeroGradient"}
                  for n in ("xmin", "xmax", "ymin", "ymax")},
        },
        "initialFields": {"U": zero, "p": 0.0},
        "primalMinResTol": 1e-11,
        "primalMaxIters": 500,
        "relaxationFactors": {"fields": {"p": 0.3}, "equations": {"U": 0.7}},
        "function": {
            "lidForce": {"type": "force", "patches": ["ymax"],
                         "directionMode": "fixedDirection",
                         "direction": [1.0, 0.0, 0.0], "scale": 1.0},
        },
        "adjEqnOption": {"gmresRelTol": 1e-12, "gmresRestart": 300,
                         "gmresMaxIters": 3000, "pcType": "segregated"},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": layout,
    }


def cavity_mesh(pkg):
    if pkg == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(N, N, 1, (0.1, 0.1, 0.01), kinds=WALLS)


def cloud(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3))


# ---------------------------------------------------------------------------
# FFD
# ---------------------------------------------------------------------------

def test_ffd_operator_apply_vjp():
    from dafoam_tpu.mdo import FFDBox as JFFD
    from dafoam_tpu_torch.mdo import FFDBox

    pts = cloud(0, 50, 0.1, 0.9)
    box = ([0, 0, 0], [1, 1, 1])
    jf = JFFD(pts, nx=4, ny=3, nz=2, bounds=box)
    tf = FFDBox(pts, nx=4, ny=3, nz=2, bounds=box, device="cpu", dtype=F64)
    assert_close(tf._B, np.asarray(jf._B), 1e-14, "B")
    assert tf.n_controls == jf.n_controls == 72
    np.testing.assert_array_equal(tf.inside, jf.inside)

    rng = np.random.default_rng(2)
    dcp = rng.normal(size=(4, 3, 2, 3)) * 0.1
    seed = rng.normal(size=(50, 3))
    want, f_vjp = jax.vjp(lambda c: jf(jnp.asarray(pts), c),
                          jnp.asarray(dcp))
    c = torch.tensor(dcp, requires_grad=True)
    got = tf(torch.as_tensor(pts), c)
    assert_close(got, want, 1e-14, "apply")
    (g,) = torch.autograd.grad(got, c, torch.as_tensor(seed))
    assert_close(g, f_vjp(jnp.asarray(seed))[0], 1e-14, "vjp")


# ---------------------------------------------------------------------------
# IDWarp
# ---------------------------------------------------------------------------

def _warp_pair(monkeypatch, pts, surf, fixed, **kw):
    from dafoam_tpu.mdo import IDWarp as JWarp
    from dafoam_tpu_torch.mdo import warp

    monkeypatch.setattr(warp, "ROWS_PER_BLOCK", 7)
    return (JWarp(pts, surf, fixed, **kw),
            warp.IDWarp(pts, surf, fixed, device="cpu", dtype=F64, **kw))


def _lid_ids():
    from dafoam_tpu_torch.outputs import patch_point_ids

    pts, topo = cavity_mesh("torch")
    surf = patch_point_ids(topo, ["ymax"])
    fixed = set()
    for p in topo.patches:
        if p.name != "ymax" and p.kind != "empty":
            fixed.update(patch_point_ids(topo, [p.name]).tolist())
    return pts, surf, np.asarray(sorted(fixed - set(surf.tolist())))


@pytest.mark.parametrize("case", ["cloud", "lid"])
def test_idwarp_table_apply_vjp(monkeypatch, case):
    if case == "cloud":
        pts = cloud(1, 200, 0.0, 1.0)
        surf, fixed, kw = np.arange(10), np.arange(190, 200), {"k": 8}
    else:
        pts, surf, fixed = _lid_ids()
        kw = {}
    jw, tw = _warp_pair(monkeypatch, pts, surf, fixed, **kw)
    np.testing.assert_array_equal(tw.nn, np.asarray(jw._nn))
    assert_close(tw._w, np.asarray(jw._w), 1e-14, "w")

    rng = np.random.default_rng(3)
    disp = rng.normal(size=(len(surf), 3)) * 0.01
    seed = rng.normal(size=pts.shape)
    want, f_vjp = jax.vjp(lambda p, d: jw(p, d), jnp.asarray(pts),
                          jnp.asarray(disp))
    p = torch.tensor(pts, requires_grad=True)
    d = torch.tensor(disp, requires_grad=True)
    got = tw(p, d)
    assert_close(got, want, 1e-13, "apply")
    gp, gd = torch.autograd.grad(got, (p, d), torch.as_tensor(seed))
    jp, jd = f_vjp(jnp.asarray(seed))
    assert_close(gp, jp, 1e-13, "vjp points0")
    assert_close(gd, jd, 1e-13, "vjp surf_disp")
    # the surface points move exactly by their displacement
    assert_close(got.detach().numpy()[surf] - pts[surf], disp, 1e-13,
                 "surface")


# ---------------------------------------------------------------------------
# InputRegistry
# ---------------------------------------------------------------------------

INPUT_INFO = {
    "vc": {"type": "volCoord"},
    "pv": {"type": "patchVelocity", "patches": ["ymax"], "flowAxis": "x",
           "normalAxis": "y"},
    "pvs": {"type": "patchVar", "varName": "p", "patches": ["ymax"],
            "varType": "scalar", "components": [0]},
    "pvv": {"type": "patchVar", "varName": "U", "patches": ["ymax", "xmin"],
            "varType": "vector", "components": [0, 2]},
    "fld": {"type": "field", "fieldName": "betaFI"},
    "fldv": {"type": "field", "fieldName": "Uref", "fieldType": "vector"},
    "reg": {"type": "regressionPar", "modelName": "model1"},
    "fvs": {"type": "fvSourcePar", "fvSourceName": "disk"},
    "sv": {"type": "stateVar"},
    "pf": {"type": "patchField", "fieldName": "U", "fieldType": "vector",
           "patches": ["ymax", "ymin"]},
    "pfs": {"type": "patchField", "fieldName": "p", "patches": ["xmin"]},
    "fu": {"type": "fieldUnsteady", "fieldName": "betaFI", "nSteps": 3},
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_input_registry_every_type():
    from dafoam_tpu.inputs import InputRegistry as JReg
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.inputs import InputRegistry
    from dafoam_tpu_torch.solvers import make_solver as tmake

    opts = cavity_options()
    opts["fvSource"] = {"disk": {
        "type": "actuatorDisk", "smoothness": 0.1,
        "parameters": [0.05, 0.05, 0.005, 1.0, 0.0, 0.0, 0.0, 0.03, 0.02,
                       0.001]}}
    opts["regressionModel"] = {
        "active": False,
        "model1": {"modelType": "neuralNetwork",
                   "inputNames": ["VoS", "chiSA", "pGradStream"],
                   "hiddenLayerNeurons": [4], "activationFunction": "tanh",
                   "outputShift": 1.0}}
    opts["inputInfo"] = INPUT_INFO
    jpts, jtopo = cavity_mesh("jax")
    tpts, ttopo = cavity_mesh("torch")
    with jax_geometry_jitted():
        js = jmake(opts, jtopo, jpts)
    ts = tmake(opts, ttopo, tpts, device="cpu", dtype=F64)
    jr, tr = JReg(js, INPUT_INFO), InputRegistry(ts, INPUT_INFO)
    rng = np.random.default_rng(4)
    for name in INPUT_INFO:
        n = tr.size(name)
        assert n == jr.size(name), name
        assert tr.distributed(name) == jr.distributed(name), name
        arr = rng.normal(size=n)
        want = _flat(jax.tree_util.tree_map(
            np.asarray, jr.apply(name, js.make_inputs(), jnp.asarray(arr))))
        got = _flat(tr.apply(name, ts.make_inputs(), torch.as_tensor(arr)))
        assert got.keys() == want.keys(), (name, got.keys() ^ want.keys())
        for k in want:
            assert_close(got[k], want[k], 1e-15, f"{name}: {k}")
    # apply_all injects every DV in one call
    dvs = {"pv": np.array([2.0, 5.0]), "fld": np.full(N * N, 1.5)}
    got = _flat(tr.apply_all(ts.make_inputs(), dvs))
    want = _flat(jax.tree_util.tree_map(
        np.asarray, jr.apply_all(js.make_inputs(), dvs)))
    for k in want:
        assert_close(got[k], want[k], 1e-15, f"apply_all: {k}")

    # vjp through the stacked components
    for name, leaf in (("pv", ("bc", "U", "ymax")),
                       ("pvv", ("bc", "U", "xmin"))):
        arr = rng.normal(size=tr.size(name))
        seed = rng.normal(size=3)

        def jget(a, name=name, leaf=leaf):
            t = jr.apply(name, js.make_inputs(), a)
            return t[leaf[0]][leaf[1]][leaf[2]]

        _, f_vjp = jax.vjp(jget, jnp.asarray(arr))
        a = torch.tensor(arr, requires_grad=True)
        t = tr.apply(name, ts.make_inputs(), a)
        (g,) = torch.autograd.grad(t[leaf[0]][leaf[1]][leaf[2]], a,
                                   torch.as_tensor(seed))
        assert_close(g, f_vjp(jnp.asarray(seed))[0], 1e-15, f"vjp {name}")


# ---------------------------------------------------------------------------
# ShapeOptProblem on the cavity with an FFD box on the lid
# ---------------------------------------------------------------------------

IX = (1, 2)          # interior x control points of a 4x3x2 lattice, j = 1


def jax_geo(ffd, pts0):
    def geo_fn(dv):
        dcp = jnp.zeros((4, 3, 2, 3), pts0.dtype)
        for a, i in enumerate(IX):
            dcp = dcp.at[i, 1, :, 1].set(dv[a])
        return ffd(pts0, dcp)
    return geo_fn


def torch_geo(ffd, pts0):
    idx = (torch.tensor([1, 1, 2, 2]), torch.tensor([1, 1, 1, 1]),
           torch.tensor([0, 1, 0, 1]), torch.tensor([1, 1, 1, 1]))

    def geo_fn(dv):
        dcp = pts0.new_zeros((4, 3, 2, 3)).index_put(
            idx, dv.repeat_interleave(2))
        return ffd(pts0, dcp)
    return geo_fn


def _opt_run(prob, n_dv, slsqp=True):
    """Two SLSQP iterations from 0 (slsqp) or eval_all and grad at 0: the
    objective and the gradient at 0 (SLSQP's first evaluation and
    gradient) and the SLSQP history."""
    dv0 = np.zeros(n_dv)
    grads = []
    grad = prob.grad
    prob.grad = lambda *a: grads.append(grad(*a)) or grads[-1]
    if not slsqp:
        f0, st, inp = prob.eval_all(dv0)
        prob.grad(dv0, "lidForce", st, inp)
        return {"f": f0["lidForce"], "g": grads[0]}
    res = prob.run(dv0, bounds=[(-DV_BOUND, DV_BOUND)] * n_dv, maxiter=2)
    hist = [(h["dv"].copy(), h["lidForce"]) for h in prob.history]
    assert np.all(hist[0][0] == 0.0)
    return {"f": hist[0][1], "g": grads[0], "hist": hist, "x": res.x}


@pytest.fixture(scope="module")
def jax_opt():
    from dafoam_tpu.mdo import FFDBox as JFFD
    from dafoam_tpu.mdo.optimize import ShapeOptProblem
    from dafoam_tpu.solvers import make_solver

    pts, topo = cavity_mesh("jax")
    # jitMode "traced": one compile of the adjoint for both gradients, where
    # the default recompiles it at each design (same solve)
    opts = cavity_options()
    opts["adjEqnOption"] = dict(opts["adjEqnOption"], jitMode="traced")
    with jax_geometry_jitted():
        s = make_solver(opts, topo, pts)
        ffd = JFFD(pts, nx=4, ny=3, nz=2, bounds=FFD_BOUNDS)
        prob = ShapeOptProblem(s, jax_geo(ffd, jnp.asarray(pts, s.dtype)),
                               "lidForce")
        return _opt_run(prob, len(IX))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shape_opt_problem(jax_opt, layout):
    from dafoam_tpu_torch.mdo import FFDBox
    from dafoam_tpu_torch.mdo.optimize import ShapeOptProblem
    from dafoam_tpu_torch.solvers import make_solver

    pts, topo = cavity_mesh("torch")
    s = make_solver(cavity_options(layout), topo, pts, device="cpu",
                    dtype=F64)
    ffd = FFDBox(pts, nx=4, ny=3, nz=2, bounds=FFD_BOUNDS, device="cpu",
                 dtype=F64)
    prob = ShapeOptProblem(s, torch_geo(ffd, s.points), "lidForce")
    # the chain (captured totals): grad = the DV reduction of B^T dJ/dx
    totals = []
    run_totals = s.run_totals
    s.run_totals = lambda *a: totals.append(run_totals(*a)) or totals[-1]
    # SLSQP on the canonical layout; the dense one's evaluations and
    # gradients are those of the same code on other face arrays
    got = _opt_run(prob, len(IX), slsqp=layout == "canonical")
    assert abs(got["f"] - jax_opt["f"]) <= 1e-8 * abs(jax_opt["f"])
    assert_close(got["g"], jax_opt["g"], 1e-8, "grad")
    gcp = (ffd._B.T @ totals[0]["points"]).reshape(4, 3, 2, 3)
    hand = gcp[list(IX), 1, :, 1].sum(dim=1)
    assert_close(hand, got["g"], 1e-12, "hand chain")
    if layout != "canonical":
        return
    assert len(got["hist"]) == len(jax_opt["hist"]) >= 2
    for (dg, fg), (dw, fw) in zip(got["hist"], jax_opt["hist"]):
        assert_close(dg, dw, 1e-8, "SLSQP dv")
        assert abs(fg - fw) <= 1e-8 * abs(fw), (fg, fw)
    assert_close(got["x"], jax_opt["x"], 1e-8, "SLSQP x")


# ---------------------------------------------------------------------------
# mesh quality gate
# ---------------------------------------------------------------------------

def _deformed_cavity(pkg):
    pts, topo = cavity_mesh(pkg)
    ffd_pts = np.asarray(pts).copy()
    from dafoam_tpu_torch.mdo import FFDBox
    ffd = FFDBox(ffd_pts, nx=4, ny=3, nz=2, bounds=FFD_BOUNDS, device="cpu",
                 dtype=F64)
    dcp = torch.zeros(4, 3, 2, 3, dtype=F64)
    dcp[1:3, 1, :, 1] = 0.004
    return ffd(torch.as_tensor(ffd_pts), dcp).numpy(), topo


@pytest.mark.parametrize("mesh", ["cavity", "deformed"])
def test_check_mesh_report(mesh):
    from dafoam_tpu.mesh import geometry as jgeometry
    from dafoam_tpu.mesh.check import check_mesh as jcheck
    from dafoam_tpu_torch.mesh.check import check_mesh
    from dafoam_tpu_torch.mesh.geometry import compute_geometry
    from dafoam_tpu_torch.mesh.topology import to_dia_dense
    from dafoam_tpu_torch.option import DAOption

    th = DAOption({})["checkMeshThreshold"]
    if mesh == "cavity":
        jpts, jtopo = cavity_mesh("jax")
        pts, topo = cavity_mesh("torch")
    else:
        pts, topo = _deformed_cavity("torch")
        jpts, jtopo = pts, cavity_mesh("jax")[1]
    with jax_geometry_jitted():
        jgeom = jgeometry.compute_geometry(jnp.asarray(jpts), jtopo)
    jok, jrep = jcheck(jgeom, jtopo, th)
    for t in (topo, to_dia_dense(topo)):
        ok, rep = check_mesh(compute_geometry(torch.as_tensor(pts), t), t,
                             th)
        assert ok == jok and rep.keys() == jrep.keys()
        for k, v in jrep.items():
            assert abs(rep[k] - v) <= 1e-12 * max(abs(v), 1.0), (k, rep, jrep)
    # a mirrored (inside-out) mesh fails the gate
    bad = np.asarray(pts) * np.array([1.0, -1.0, 1.0])
    ok, rep = check_mesh(compute_geometry(torch.as_tensor(bad), topo), topo,
                         th)
    assert not ok and rep["incorrectlyOrientedFaces"] > 0, rep
