"""The MPhys components of dafoam_tpu_torch on its OpenMDAO shim against
dafoam_tpu (CPU, f64), on tests/test_mphys.py's 10x10 lid-driven cavity:

- the shim's reverse sweep on analytic components (tests/test_mphys.py's
  self-test, on the port's copy of the shim);
- the aero model (DAFoamMesh -> x_aero -> DAFoamWarper -> DAFoamSolver ->
  DAFoamFunctions): run_model's lidForce and states and compute_totals'
  dlidForce/dx_aero against dafoam_tpu's residual-form run at 1e-8 (one
  run, in a module fixture), for the port's residual-form route on the
  canonical layout and its fixed-point route on the dense one; one residual graph recorded per
  linearization point; the totals equal the solver's own totals chained
  through the warper's vjp;
- DAFoamForces against dafoam_tpu's at dafoam_tpu's state (output at
  1e-12, reverse product at 1e-10); DAFoamThermal and DAFoamFaceCoords on
  tests/test_mphys.py's heated slab against the port's own OutputRegistry
  and geometry, and against dafoam_tpu's components at a state and points
  moved by seeded noise (output and reverse product at 1e-12, face
  coordinates at 1e-14);
- DAFoamLinearConstraint;
- DAFoamBuilder's subsystems, OutputRegistry's function and residual
  outputs (exactly the solver's own calls), and utils/vtkio's volume and
  surface files against dafoam_tpu's;
- DAFoamBuilderUnsteady/DAFoamSolverUnsteady on the 8x8 PIMPLE cavity of
  test_torch_pimple.py (two steps): its output and its reverse product
  against the port's eval_function_history and solve_unsteady_adjoint at
  1e-12.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import assert_close, jax_geometry_jitted

torch.set_num_threads(1)
F64 = torch.float64
N = 10
WALLS = {"zmin": "empty", "zmax": "empty", "xmin": "wall", "xmax": "wall",
         "ymin": "wall", "ymax": "wall"}


def fp_options(opts):
    """tests/test_mphys.py:aero_model_fp's adjoint options."""
    opts = dict(opts, adjEqnSolMethod="fixedPoint")
    opts["adjEqnOption"] = {"fpRelTol": 1e-10, "fpMaxIters": 3000,
                            "gmresRestart": 150, "pcType": "none",
                            "fpInnerScale": 1.0}
    return opts


def options(route, layout="canonical"):
    from test_mphys import cavity_options

    opts = cavity_options()
    if route == "fixedPoint":
        opts = fp_options(opts)
    opts["meshFaceLayout"] = layout
    return opts


def aero_model(pkg, opts):
    """tests/test_mphys.py:aero_model in either package; returns (prob,
    solver, pids, the components by name)."""
    if pkg == "jax":
        from dafoam_tpu.mdo import mphys, om_shim as om
        from dafoam_tpu.mesh import box_hex_mesh
        from dafoam_tpu.outputs import patch_point_ids
        from dafoam_tpu.solvers import make_solver
        mk = make_solver
    else:
        from dafoam_tpu_torch.mdo import mphys, om_shim as om
        from dafoam_tpu_torch.mesh import box_hex_mesh
        from dafoam_tpu_torch.outputs import patch_point_ids
        from dafoam_tpu_torch.solvers import make_solver

        def mk(o, t, p):
            return make_solver(o, t, p, device="cpu", dtype=F64)
    pts, topo = box_hex_mesh(N, N, 1, (0.1, 0.1, 0.01), kinds=WALLS)
    solver = mk(opts, topo, pts)
    model = om.Group()
    model.add_subsystem("mesh", mphys.DAFoamMesh(solver=solver),
                        promotes=["*"])
    ivc = om.IndepVarComp()
    pids = patch_point_ids(topo, ["ymax"])
    ivc.add_output("x_aero", val=np.asarray(pts)[pids].ravel())
    model.add_subsystem("dvs", ivc, promotes=["*"])
    comps = {"deformer": mphys.DAFoamWarper(solver=solver),
             "solver": mphys.DAFoamSolver(solver=solver),
             "functions": mphys.DAFoamFunctions(solver=solver)}
    for name, comp in comps.items():
        model.add_subsystem(name, comp, promotes=["*"])
    prob = om.Problem(model).setup()
    return prob, solver, pids, comps


def _drive(prob):
    prob.run_model()
    J = float(np.asarray(prob["lidForce"]).ravel()[0])
    tot = prob.compute_totals(of="lidForce", wrt="x_aero")[
        ("lidForce", "x_aero")]
    return J, tot, np.asarray(prob["aero_states"]).copy()


@pytest.fixture(scope="module")
def jax_runs():
    """dafoam_tpu's aero model, residual-form route. The port's
    fixed-point route is held against it too: both routes converge to the
    same totals (rel 6.6e-10 apart in the port on this case), and a
    second dafoam_tpu model would double the file's time."""
    with jax_geometry_jitted():
        prob, solver, _, _ = aero_model("jax", options("Krylov"))
        run = _drive(prob)
    return {"Krylov": run, "fixedPoint": run, "forces": (solver, run[2])}


# ---------------------------------------------------------------------------
# the shim on analytic components
# ---------------------------------------------------------------------------

def test_shim_reverse_sweep_analytic():
    from dafoam_tpu_torch.mdo import om_shim as om

    class Doubler(om.ExplicitComponent):
        def setup(self):
            self.add_input("x", val=np.zeros(3))
            self.add_output("y", val=np.zeros(3))

        def compute(self, inputs, outputs):
            outputs["y"] = 2.0 * inputs["x"]

        def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
            if mode == "rev" and "y" in d_outputs and "x" in d_inputs:
                d_inputs["x"] = d_inputs["x"] + 2.0 * d_outputs["y"]

    class ImplicitCube(om.ImplicitComponent):
        """R(x, w) = w^3 - x = 0  ->  w = x^(1/3)."""

        def setup(self):
            self.add_input("y", val=np.ones(3))
            self.add_output("w", val=np.ones(3))

        def solve_nonlinear(self, inputs, outputs):
            outputs["w"] = np.cbrt(inputs["y"])

        def linearize(self, inputs, outputs, residuals):
            self._w = np.asarray(outputs["w"]).copy()

        def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                         d_residuals, mode):
            if mode != "rev":
                return
            psi = d_residuals["w"]
            if "w" in d_outputs:
                d_outputs["w"] = d_outputs["w"] + 3.0 * self._w ** 2 * psi
            if "y" in d_inputs:
                d_inputs["y"] = d_inputs["y"] - psi

        def solve_linear(self, d_outputs, d_residuals, mode):
            if mode == "rev":
                d_residuals["w"] = d_outputs["w"] / (3.0 * self._w ** 2)

    class Obj(om.ExplicitComponent):
        def setup(self):
            self.add_input("w", val=np.ones(3))
            self.add_output("J", val=0.0)

        def compute(self, inputs, outputs):
            outputs["J"] = float(np.sum(inputs["w"] ** 2))

        def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
            if mode == "rev" and "J" in d_outputs and "w" in d_inputs:
                d_inputs["w"] = d_inputs["w"] + 2.0 * inputs["w"] * float(
                    np.asarray(d_outputs["J"]).ravel()[0])

    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("x", val=np.array([1.0, 2.0, 3.0]))
    model.add_subsystem("dvs", ivc, promotes=["*"])
    model.add_subsystem("dbl", Doubler(), promotes=["*"])
    model.add_subsystem("imp", ImplicitCube(), promotes=["*"])
    model.add_subsystem("obj", Obj(), promotes=["*"])
    prob = om.Problem(model).setup()
    prob.run_model()
    w = np.cbrt(2.0 * np.array([1.0, 2.0, 3.0]))
    assert prob["J"] == pytest.approx(float(np.sum(w ** 2)), rel=1e-12)
    tot = prob.compute_totals(of="J", wrt="x")
    np.testing.assert_allclose(tot[("J", "x")], 2.0 * w / (3.0 * w ** 2)
                               * 2.0, rtol=1e-12)


# ---------------------------------------------------------------------------
# the aero model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,layout", [
    ("Krylov", "canonical"), ("fixedPoint", "diaDense")])
def test_run_model_and_totals(jax_runs, route, layout):
    from dafoam_tpu_torch.outputs import patch_point_ids

    prob, solver, pids, comps = aero_model("torch", options(route, layout))
    np.testing.assert_allclose(prob["x_aero0"], prob["x_aero"], atol=0.0)
    J, tot, w = _drive(prob)
    Jw, totw, ww = jax_runs[route]
    assert abs(J - Jw) <= 1e-8 * abs(Jw), (J, Jw)
    assert tot.shape == (len(pids) * 3,)
    assert_close(tot, totw, 1e-8, f"dlidForce/dx_aero {route}")
    if layout == "canonical":
        assert_close(w, ww, 1e-8, "states")
    # one residual graph at the linearization point
    assert comps["solver"].n_graphs == 1
    # the direct route: the solver's totals through the warper's vjp
    s = solver
    st = comps["solver"]._state
    x = s.make_inputs()
    x["points"] = torch.as_tensor(prob["aero_vol_coords"]).reshape(-1, 3)
    psi = s.layout.unpack(torch.as_tensor(comps["solver"]._psi_packed))
    tp = s.total_derivative(st, x, "lidForce", psi)["points"]
    xs = torch.tensor(np.asarray(prob["x_aero"]), requires_grad=True)
    with torch.enable_grad():
        vol = comps["deformer"].warp_flat(xs)
    (direct,) = torch.autograd.grad(vol, xs, tp.reshape(-1))
    assert_close(tot, direct, 1e-8, "direct route")
    assert len(patch_point_ids(s.topo, ["ymax"])) == len(pids)


# ---------------------------------------------------------------------------
# coupling-output components
# ---------------------------------------------------------------------------

def test_forces_component(jax_runs):
    from dafoam_tpu.mdo.mphys import DAFoamForces as JForces
    from dafoam_tpu_torch.mdo.mphys import DAFoamForces

    js, w = jax_runs["forces"]
    jcomp = JForces(solver=js)
    jcomp.setup()
    _, tsolver, _, _ = aero_model("torch", options("Krylov"))
    comp = DAFoamForces(solver=tsolver)
    comp.setup()
    xv = np.asarray(js.points).ravel()
    ins = {"aero_states": w, "aero_vol_coords": xv}
    outs, jouts = {}, {}
    comp.compute(ins, outs)
    jcomp.compute(ins, jouts)
    assert_close(outs["f_aero"], jouts["f_aero"], 1e-12, "f_aero")
    seed = np.random.default_rng(3).normal(size=outs["f_aero"].size)
    d, jd = ({"aero_states": np.zeros_like(w),
              "aero_vol_coords": np.zeros_like(xv)} for _ in range(2))
    comp.compute_jacvec_product(ins, d, {"f_aero": seed}, "rev")
    jcomp.compute_jacvec_product(ins, jd, {"f_aero": seed}, "rev")
    for k in d:
        assert_close(d[k], jd[k], 1e-10, k)


def test_thermal_and_facecoords():
    from dafoam_tpu_torch.mdo.mphys import DAFoamFaceCoords, DAFoamThermal
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.mesh.geometry import compute_geometry
    from dafoam_tpu_torch.outputs import OutputRegistry, patch_face_ids
    from dafoam_tpu_torch.solvers import make_solver

    T_HOT = 350.0
    pts, topo = box_hex_mesh(12, 4, 1, (1.0, 0.05, 0.01),
                             kinds={"zmin": "empty", "zmax": "empty"})
    out_info = {"T_convect": {"type": "thermalCouplingOutput",
                              "patches": ["ymax"],
                              "components": ["thermalCoupling"]}}
    opts = {
        "solverName": "DAHeatTransferFoam", "discipline": "thermal",
        "transportProperties": {"kappa": 1.0},
        "boundaryConditions": {
            "T": {"ymin": {"type": "fixedValue", "value": T_HOT},
                  "ymax": {"type": "fixedValue", "value": 300.0},
                  "xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "zeroGradient"}}},
        "initialFields": {"T": T_HOT}, "primalMinResTol": 1e-8,
        "primalMaxIters": 200, "function": {},
        "normalizeStates": {"T": T_HOT}, "outputInfo": out_info}
    s = make_solver(opts, topo, pts, device="cpu", dtype=F64)
    x = s.make_inputs()
    st, info = s.run_primal(s.init_state(), x)
    assert info.converged
    w = s.layout.pack(st).numpy()
    xv = np.asarray(pts).ravel()

    comp = DAFoamThermal(solver=s)
    comp.setup()
    outs = {}
    ins = {"thermal_states": w, "thermal_vol_coords": xv}
    comp.compute(ins, outs)
    nf = topo.patch("ymax").size
    direct = OutputRegistry(s, out_info).evaluate("T_convect", st, x)
    assert outs["T_convect"].shape == (2 * nf,)
    assert_close(outs["T_convect"], direct, 1e-15, "thermal output")
    assert (outs["T_convect"][nf:] > 0).all()
    # reverse product against autograd of the registry call
    seed = np.random.default_rng(5).normal(size=2 * nf)
    d = {"thermal_states": np.zeros_like(w),
         "thermal_vol_coords": np.zeros_like(xv)}
    comp.compute_jacvec_product(ins, d, {"T_convect": seed}, "rev")
    wt = torch.tensor(w, requires_grad=True)
    pt = torch.tensor(xv, requires_grad=True)
    with torch.enable_grad():
        out = OutputRegistry(s, out_info).evaluate(
            "T_convect", s.layout.unpack(wt), dict(x, points=pt.reshape(
                -1, 3)))
    gw, gp = torch.autograd.grad(out, (wt, pt), torch.as_tensor(seed))
    assert_close(d["thermal_states"], gw, 1e-14, "dT/dW")
    assert_close(d["thermal_vol_coords"], gp, 1e-14, "dT/dX")

    fc = DAFoamFaceCoords(solver=s)
    fc.setup()
    outs2 = {}
    fc.compute({"thermal_vol_coords": xv}, outs2)
    cf = compute_geometry(torch.as_tensor(pts), topo).cf[
        patch_face_ids(topo, ["ymax"])].numpy()
    assert_close(outs2["x_thermal_surface0"], np.concatenate([cf, cf])
                 .ravel(), 1e-15, "face coords")
    np.testing.assert_allclose(cf[:, 1], 0.05, atol=1e-12)

    # against dafoam_tpu's components, at a state and points moved by
    # seeded noise so that every face has its own near-wall T and kappa/d
    from dafoam_tpu.mdo.mphys import DAFoamFaceCoords as JFaceCoords
    from dafoam_tpu.mdo.mphys import DAFoamThermal as JThermal
    from dafoam_tpu.mesh import box_hex_mesh as jbox
    from dafoam_tpu.solvers import make_solver as jmake

    rng = np.random.default_rng(11)
    xyz = np.tile([1.0, 1.0, 0.0], xv.size // 3)
    ins = {"thermal_states": w + rng.normal(size=w.size),
           "thermal_vol_coords": xv + 1e-3 * xyz * rng.normal(size=xv.size)}
    jpts, jtopo = jbox(12, 4, 1, (1.0, 0.05, 0.01),
                       kinds={"zmin": "empty", "zmax": "empty"})
    js = jmake(opts, jtopo, jpts)
    outs, jouts, d, jd = {}, {}, {}, {}
    for c, o, dd in ((DAFoamThermal(solver=s), outs, d),
                     (JThermal(solver=js), jouts, jd)):
        c.setup()
        c.compute(ins, o)
        dd.update({k: np.zeros_like(v) for k, v in ins.items()})
        c.compute_jacvec_product(ins, dd, {"T_convect": seed}, "rev")
    assert np.ptp(jouts["T_convect"][:nf]) > 0.1
    assert np.ptp(jouts["T_convect"][nf:]) > 0.1
    assert_close(outs["T_convect"], jouts["T_convect"], 1e-12, "thermal")
    for k in d:
        assert_close(d[k], jd[k], 1e-12, f"thermal rev {k}")
    outs2, jouts2 = {}, {}
    xin = {"thermal_vol_coords": ins["thermal_vol_coords"]}
    fc.compute(xin, outs2)
    jfc = JFaceCoords(solver=js)
    jfc.setup()
    with jax_geometry_jitted():
        jfc.compute(xin, jouts2)
    assert_close(outs2["x_thermal_surface0"], jouts2["x_thermal_surface0"],
                 1e-14, "face coords")


def test_linear_constraint():
    from dafoam_tpu_torch.mdo.mphys import DAFoamLinearConstraint

    comp = DAFoamLinearConstraint(varA=["CD", "CL"], coeffA=[1.0, 2.0],
                                  varB=["CM", "CN"], coeffB=-1.0,
                                  size=1, output_name="con")
    comp.setup()
    ins = {"CD": np.array([3.0]), "CL": np.array([4.0]),
           "CM": np.array([1.0]), "CN": np.array([2.0])}
    outs = {}
    comp.compute(ins, outs)
    assert outs["con_0"][0] == pytest.approx(2.0)
    assert outs["con_1"][0] == pytest.approx(6.0)
    d_in = {k: np.zeros(1) for k in ins}
    comp.compute_jacvec_product(ins, d_in, {"con_1": np.ones(1)}, "rev")
    assert d_in["CL"][0] == pytest.approx(2.0)
    assert d_in["CN"][0] == pytest.approx(-1.0)
    assert d_in["CD"][0] == 0.0


# ---------------------------------------------------------------------------
# the unsteady component
# ---------------------------------------------------------------------------

def test_solver_unsteady_component():
    from dafoam_tpu_torch.mdo import om_shim as om
    from dafoam_tpu_torch.mdo.mphys import DAFoamBuilderUnsteady
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from test_torch_pimple import SEGREGATED, cavity_options

    opts = cavity_options(endTime=0.04, adjEqnOption=dict(SEGREGATED),
                          normalizeStates={"U": 1.0, "p": 0.5, "phi": 1.0})
    opts["inputInfo"] = {
        "aero_vol_coords": {"type": "volCoord", "components": ["solver"]}}
    opts["designSurfaces"] = ["ymax"]
    pts, topo = box_hex_mesh(8, 8, 1, (0.1, 0.1, 0.01), kinds=WALLS)
    grp = DAFoamBuilderUnsteady(solver_options=opts, mesh_pair=(pts, topo),
                                device="cpu", dtype=F64)
    model = om.Group()
    model.add_subsystem("cfd", grp, promotes=["*"])
    prob = om.Problem(model).setup()
    prob.run_model()
    s = grp.DASolver
    comp = dict((n, c) for n, c, _ in grp._subs)["solver"]
    J = float(np.asarray(prob["lidF"]).ravel()[0])
    hist, x = comp._hist, s.make_inputs()
    assert hist["U"].shape[0] == 3          # two steps of 0.02
    with torch.no_grad():
        Jd, _ = s.eval_function_history("lidF", hist, x)
    assert abs(J - float(Jd)) <= 1e-12 * abs(float(Jd)), (J, float(Jd))
    tot, _ = s.solve_unsteady_adjoint(hist, x, "lidF")
    names = ["aero_vol_coords"]
    ins = {n: np.asarray(prob[n]) for n in names}
    d = {n: np.zeros_like(v) for n, v in ins.items()}
    comp.compute_jacvec_product(ins, d, {"lidF": np.array([2.0])}, "rev")
    assert_close(d["aero_vol_coords"], 2.0 * tot["points"].reshape(-1),
                 1e-12, "dlidF/dpoints")


def test_builder_outputs_and_vtk(tmp_path):
    """DAFoamBuilder's subsystems; OutputRegistry's function and residual
    outputs against the solver's own calls; the VTK writers against
    dafoam_tpu's files (all but the title line)."""
    from dafoam_tpu.utils import vtkio as jvtk
    from dafoam_tpu_torch.mdo.mphys import DAFoamBuilder
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.outputs import OutputRegistry, patch_point_ids
    from dafoam_tpu_torch.utils import vtkio

    pts, topo = box_hex_mesh(N, N, 1, (0.1, 0.1, 0.01), kinds=WALLS)
    b = DAFoamBuilder(options("Krylov"), (pts, topo), device="cpu",
                      dtype=F64)
    b.initialize()
    s = b.get_solver()
    grp = b.get_coupling_group_subsystem()
    assert [n for n, _, _ in grp._subs] == ["deformer", "solver"]
    assert b.get_number_of_nodes() == len(patch_point_ids(topo, ["ymax"]))
    assert type(b.get_mesh_coordinate_subsystem()).__name__ == "DAFoamMesh"

    rng = np.random.default_rng(7)
    x = s.make_inputs()
    st = {k: v + torch.as_tensor(rng.normal(size=v.shape)) * 1e-2
          for k, v in s.init_state().items()}
    reg = OutputRegistry(s, {"J": {"type": "function",
                                   "functionName": "lidForce"},
                             "R": {"type": "residual"}})
    assert reg.size("J") == 1 and reg.size("R") == s.layout.n_states
    assert_close(reg.evaluate("J", st, x),
                 s.eval_function("lidForce", st, x).reshape(1), 0.0, "J")
    assert_close(reg.evaluate("R", st, x),
                 s.layout.pack(s._norm_residuals(st, x)), 0.0, "R")

    cells = {"p": rng.normal(size=topo.n_cells),
             "U": rng.normal(size=(topo.n_cells, 3))}
    faces = {"f": rng.normal(size=(topo.patch("ymax").size, 3))}
    for name, write, jwrite, args in (
            ("vol", vtkio.write_volume_vtk, jvtk.write_volume_vtk,
             (pts, topo, cells)),
            ("surf", vtkio.write_surface_vtk, jvtk.write_surface_vtk,
             (pts, topo, ["ymax"], faces))):
        write(tmp_path / f"{name}.vtk", torch.as_tensor(args[0]), *args[1:])
        jwrite(tmp_path / f"{name}_jax.vtk", *args)
        got = (tmp_path / f"{name}.vtk").read_text().splitlines()
        want = (tmp_path / f"{name}_jax.vtk").read_text().splitlines()
        assert len(got) == len(want) > 10
        assert got[0] == want[0] and got[2:] == want[2:], name
