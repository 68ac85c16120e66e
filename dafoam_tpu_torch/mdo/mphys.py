"""OpenMDAO / MPhys coupling layer.

Port of ``dafoam_tpu.mdo.mphys``, with API parity to the reference's
dafoam/mphys/mphys_dafoam.py: a Builder plus the full component roster:
DAFoamSolver (implicit, :232 with solve_nonlinear :314 / apply_linear
:375 / solve_linear :433), DAFoamMesh (:614), DAFoamFunctions (:687),
DAFoamWarper (:804), DAFoamThermal (:862), DAFoamFaceCoords (:954),
DAFoamForces (:1004), DAFoamBuilderUnsteady/DAFoamSolverUnsteady
(:1250/:1290) and DAFoamLinearConstraint (:1682).

Every ``calcJacTVecProduct`` of the reference is one backward pass over a
recorded graph, against the packed-state / flat-design-array boundary.
DAFoamSolver records its residual graph once per linearization point (at
the first ``apply_linear`` after ``linearize``) and re-walks it with
``torch.autograd.grad(..., retain_graph=True)`` for every product; the
graph is freed by the next ``solve_nonlinear`` or ``linearize``.

OpenMDAO vectors are float64 numpy; the components move them to the
solver's device and dtype and back. When openmdao is installed the
components bind to the real classes; otherwise they bind to
``dafoam_tpu_torch.mdo.om_shim``, a stand-in of the API subset used here
whose ``Problem.compute_totals`` drives the same solve_nonlinear ->
solve_linear -> apply_linear -> compute_jacvec_product reverse-sweep
cycle.
"""

from __future__ import annotations

import numpy as np
import torch

try:  # pragma: no cover - optional dependency
    import openmdao.api as om
    HAS_OM = True
except Exception:
    from dafoam_tpu_torch.mdo import om_shim as om
    HAS_OM = False

try:  # pragma: no cover
    from mphys.builder import Builder as _MphysBuilder
except Exception:
    _MphysBuilder = object

from dafoam_tpu_torch.inputs import InputRegistry
from dafoam_tpu_torch.mdo.warp import IDWarp
from dafoam_tpu_torch.mesh.check import check_mesh
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.outputs import (OutputRegistry, patch_face_ids,
                                      patch_point_ids)


# ---------------------------------------------------------------------------
# helpers shared by the components
# ---------------------------------------------------------------------------
def _np(t) -> np.ndarray:
    """A tensor as a float64 numpy array (an OpenMDAO vector)."""
    return t.detach().cpu().numpy().astype(np.float64)


def _t(solver, a) -> torch.Tensor:
    """An OpenMDAO vector as a tensor on the solver's device and dtype (a
    copy: OpenMDAO writes its vectors in place)."""
    return torch.as_tensor(np.array(a, dtype=np.float64), dtype=solver.dtype,
                           device=solver.device)


def _points_np(solver) -> np.ndarray:
    return solver.points.detach().cpu().numpy()


def _input_names(solver, component):
    """inputInfo entries attached to a given component kind."""
    info = solver.option.get("inputInfo", {}) or {}
    return [n for n, cfg in info.items()
            if component in cfg.get("components", [])]


def _output_name(solver, component):
    info = solver.option.get("outputInfo", {}) or {}
    for n, cfg in info.items():
        if component in cfg.get("components", []):
            return n, cfg
    return None, None


def _build_tree(solver, input_reg, arrs, names):
    """inputs dict with every named flat design tensor injected."""
    t = solver.make_inputs()
    for name in names:
        if name in arrs:
            t = input_reg.apply(name, t, arrs[name])
    return t


def _arrays(solver, om_inputs, names, grad=False):
    """{name: tensor} of the named OpenMDAO inputs, requiring grad if
    asked."""
    return {n: _t(solver, om_inputs[n]).requires_grad_(grad)
            for n in names if n in om_inputs}


def _backward(outputs, wrt: dict, seed, retain_graph=False):
    """{name: seed^T d outputs / d wrt[name]} (zeros where unused)."""
    names = list(wrt)
    gs = torch.autograd.grad(outputs, [wrt[n] for n in names], seed,
                             retain_graph=retain_graph, allow_unused=True)
    return {n: torch.zeros_like(wrt[n]) if g is None else g
            for n, g in zip(names, gs)}


def _input_default(solver, input_reg, name):
    cfg = solver.option["inputInfo"][name]
    if cfg["type"] == "volCoord":
        return _points_np(solver).ravel()
    return np.zeros(input_reg.size(name))


class DAFoamBuilder(_MphysBuilder):
    """MPhys builder (reference DAFoamBuilder, mphys_dafoam.py:16).

    mesh_pair: (points, topo), the volume mesh the solver runs on (the
    reference reads it from the OpenFOAM case directory instead). The
    solver lives on ``device`` in ``dtype``.
    """

    def __init__(self, options, mesh_pair, scenario="aerodynamic",
                 run_directory="", *, device="cuda", dtype=torch.float32):
        self.options_dict = options
        self.points, self.topo = mesh_pair
        self.scenario = scenario
        self.device = device
        self.dtype = dtype
        self.solver = None

    def initialize(self, comm=None):
        from dafoam_tpu_torch.solvers import make_solver

        self.solver = make_solver(self.options_dict, self.topo, self.points,
                                  device=self.device, dtype=self.dtype)

    def get_solver(self):
        return self.solver

    def get_coupling_group_subsystem(self, scenario_name=None):
        grp = om.Group()
        names = _input_names(self.solver, "solver")
        has_vol = any(
            self.solver.option["inputInfo"][n]["type"] == "volCoord"
            for n in names)
        if has_vol:
            grp.add_subsystem("deformer", DAFoamWarper(solver=self.solver),
                              promotes=["*"])
        grp.add_subsystem("solver", DAFoamSolver(solver=self.solver),
                          promotes=["*"])
        if self.scenario == "aerostructural":
            grp.add_subsystem("force", DAFoamForces(solver=self.solver),
                              promotes=["*"])
        if self.scenario == "aerothermal":
            grp.add_subsystem("thermal", DAFoamThermal(solver=self.solver),
                              promotes=["*"])
        return grp

    def get_mesh_coordinate_subsystem(self, scenario_name=None):
        return DAFoamMesh(solver=self.solver)

    def get_post_coupling_subsystem(self, scenario_name=None):
        return DAFoamFunctions(solver=self.solver)

    def get_pre_coupling_subsystem(self, scenario_name=None):
        return None

    def get_number_of_nodes(self, groupName=None):
        return len(patch_point_ids(
            self.solver.topo, self.solver.option.get("designSurfaces", [])))

    def get_ndof(self):
        return 3


class DAFoamMesh(om.ExplicitComponent):
    """Initial surface mesh coordinates of the design surfaces
    (reference DAFoamMesh, mphys_dafoam.py:614)."""

    def initialize(self):
        self.options.declare("solver", recordable=False)

    def setup(self):
        solver = self.options["solver"]
        self.discipline = solver.option.get("discipline", "aero")
        pids = patch_point_ids(solver.topo,
                               solver.option.get("designSurfaces", []))
        x0 = _points_np(solver)[pids].ravel()
        self.add_output(f"x_{self.discipline}0", val=x0, distributed=True,
                        tags=["mphys_coordinates"])

    def compute(self, inputs, outputs):
        pass


class DAFoamSolver(om.ImplicitComponent):
    """Implicit CFD component (reference DAFoamSolver, mphys_dafoam.py:232).

    Output = packed state vector; residual = the packed NORMALIZED
    residuals the adjoint is formulated in (normalizeResiduals semantics,
    DAMacroFunctions.H:28-50). solve_linear solves dR/dW^T psi = dF/dW
    matrix-free; apply_linear produces dR/dW^T psi and dR/dx^T psi from
    one residual graph per linearization point."""

    def initialize(self):
        self.options.declare("solver", recordable=False)
        self.options.declare("run_directory", default="")

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        self.stateName = f"{self.discipline}_states"
        self.input_reg = InputRegistry(solver,
                                       solver.option.get("inputInfo", {}))
        self.in_names = _input_names(solver, "solver")
        self._psi_packed = None
        self._state = None       # converged state cache
        self._tree_cache = None
        self._lin_point = None   # (packed state, {name: array}) numpy
        self._graph = None       # (w, arrs, R) recorded at that point
        self.n_graphs = 0        # residual graphs recorded so far

        self.add_output(self.stateName, distributed=True,
                        val=_np(solver.layout.pack(solver.init_state())),
                        tags=["mphys_coupling"])
        for name in self.in_names:
            self.add_input(name, val=_input_default(solver, self.input_reg,
                                                    name),
                           distributed=self.input_reg.distributed(name),
                           tags=["mphys_coupling"])

    # -- helpers --------------------------------------------------------
    def _tree(self, inputs):
        return _build_tree(self.solver, self.input_reg,
                           _arrays(self.solver, inputs, self.in_names),
                           self.in_names)

    def _packed_res_fn(self):
        solver = self.solver

        def f(w_packed, tree_):
            st = solver.layout.unpack(w_packed)
            return solver.layout.pack(solver._norm_residuals(st, tree_))

        return f

    def _write_failed_mesh(self, tree_, state=None, report=None):
        """writeFailedMesh analog (reference DASolver.C:3534): when the
        mesh gate or the primal fails and writeMinorIterations is on, dump
        the failing volume mesh (and states, when available) to
        failedMesh.vtk for post-mortem in ParaView."""
        if not self.solver.option.get("writeMinorIterations", False):
            return
        from dafoam_tpu_torch.utils.vtkio import write_volume_vtk

        cell_data = {}
        if state is not None:
            for k, v in state.items():
                a = v.detach().cpu().numpy()
                if a.shape[0] == self.solver.topo.n_cells:
                    cell_data[k] = a
        try:
            write_volume_vtk("failedMesh.vtk",
                             tree_["points"].detach().cpu().numpy(),
                             self.solver.topo, cell_data or None)
            print("wrote failedMesh.vtk", report or "")
        except Exception as e:  # never mask the AnalysisError
            print(f"writeFailedMesh failed: {e}")

    # -- nonlinear ------------------------------------------------------
    def solve_nonlinear(self, inputs, outputs):
        solver = self.solver
        self._graph = None       # the next linearization records anew
        tree_ = self._tree(inputs)
        # mesh-quality gate (reference checkMesh, mphys_dafoam.py:325-330)
        ok, _report = check_mesh(
            solver.geometry(tree_), solver.topo,
            solver.option.get("checkMeshThreshold", {}) or {})
        if not ok:
            self._write_failed_mesh(tree_, report=_report)
            raise om.AnalysisError("Mesh quality error!")
        st0 = self._state if self._state is not None else solver.init_state()
        state, info = solver.run_primal(st0, tree_)
        if bool(info.failed):
            # restart from scratch once (reference resetStateVals analog)
            state, info = solver.run_primal(solver.init_state(), tree_)
        if bool(info.failed):
            self._write_failed_mesh(tree_, state=state)
            raise om.AnalysisError("dafoam_tpu_torch primal failed")
        self._state = state
        self.last_info = info
        outputs[self.stateName] = _np(solver.layout.pack(state))

    def apply_nonlinear(self, inputs, outputs, residuals):
        solver = self.solver
        w = _t(solver, outputs[self.stateName])
        with torch.no_grad():
            r = self._packed_res_fn()(w, self._tree(inputs))
        residuals[self.stateName] = _np(r)

    def linearize(self, inputs, outputs, residuals):
        # cache the converged state + inputs the adjoint linearizes about
        solver = self.solver
        self._state = solver.layout.unpack(
            _t(solver, outputs[self.stateName]))
        self._tree_cache = self._tree(inputs)
        point = (np.array(outputs[self.stateName]),
                 {n: np.array(inputs[n]) for n in self.in_names
                  if n in inputs})
        if self._lin_point is None or not _same_point(point,
                                                      self._lin_point):
            self._graph = None
        self._lin_point = point

    # -- linear (adjoint) -------------------------------------------------
    def _linear_res_fn(self):
        """The packed residual the LINEAR system (solve_linear/apply_linear)
        is formulated in.

        Krylov mode: the normalized residuals R(W, x); solve_linear's psi
        satisfies dR/dW^T psi = dF/dW and apply_linear applies dR/dx^T psi.

        fixedPoint mode (reference runFPAdj, adjEqnSolMethod: fixedPoint):
        solve_adjoint_rhs returns psibar of the STEP-MAP system
        (I - dG/dW^T) psibar = dF/dW, which is the adjoint of the defect
        form Rt(W, x) = W - G(W, x) (same zero set as R, different
        scaling). apply_linear MUST apply dRt/dx^T = -dG/dx^T to that
        psibar: pairing psibar with the residual-form dR/dx^T corrupts
        every total (reference semantics: mphys_dafoam.py:433-574 +
        DASimpleFoam.C:189). The resulting totals dJ/dx = pJ/px +
        psibar^T dG/dx match total_derivative_fp algebraically.
        """
        solver = self.solver
        if solver._fp_adjoint():
            step = solver._fp_step_fn()

            def fp_res(w_packed, tree_):
                st = solver.layout.unpack(w_packed)
                g = step(st, tree_)[0]
                return w_packed - solver.layout.pack(g)

            return fp_res
        return self._packed_res_fn()

    def _record(self, inputs, outputs):
        """The residual graph at (outputs, inputs): W and every solver
        input as leaves that require grad."""
        solver = self.solver
        w = _t(solver, outputs[self.stateName]).requires_grad_(True)
        arrs = _arrays(solver, inputs, self.in_names, grad=True)
        with torch.enable_grad():
            R = self._linear_res_fn()(
                w, _build_tree(solver, self.input_reg, arrs, self.in_names))
        self.n_graphs += 1
        return w, arrs, R

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "fwd":
            om.issue_warning("fwd mode not implemented",
                             category=om.OpenMDAOWarning)
            return
        solver = self.solver
        if self.stateName not in d_residuals:
            return
        point = (np.asarray(outputs[self.stateName]),
                 {n: np.asarray(inputs[n]) for n in self.in_names
                  if n in inputs})
        if self._graph is None or self._lin_point is None \
                or not _same_point(point, self._lin_point):
            self._lin_point = (point[0].copy(),
                               {n: a.copy() for n, a in point[1].items()})
            self._graph = self._record(inputs, outputs)
        w, arrs, R = self._graph
        wrt = {}
        if self.stateName in d_outputs:
            wrt[self.stateName] = w
        for name in self.in_names:
            if name in d_inputs and name in arrs:
                wrt[name] = arrs[name]
        if not wrt:
            return
        g = _backward(R, wrt, _t(solver, d_residuals[self.stateName]),
                      retain_graph=True)
        if self.stateName in g:
            d_outputs[self.stateName] = (d_outputs[self.stateName]
                                         + _np(g[self.stateName]))
        for name in self.in_names:
            if name in g:
                d_inputs[name] = d_inputs[name] + _np(g[name])

    def solve_linear(self, d_outputs, d_residuals, mode):
        if mode == "fwd":
            om.issue_warning("fwd mode not implemented",
                             category=om.OpenMDAOWarning)
            return
        solver = self.solver
        if self._state is None:
            raise RuntimeError("solve_linear before solve_nonlinear")
        dFdW = solver.layout.unpack(_t(solver, d_outputs[self.stateName]))
        psi0 = None
        if (solver.option["adjEqnOption"].get("useNonZeroInitGuess", False)
                and self._psi_packed is not None):
            psi0 = solver.layout.unpack(_t(solver, self._psi_packed))
        tree_ = self._tree_cache if self._tree_cache is not None \
            else solver.make_inputs()
        psi, info = solver.solve_adjoint_rhs(self._state, tree_, dFdW,
                                             psi0=psi0)
        self.last_adjoint_info = info
        self._psi_packed = _np(solver.layout.pack(psi))
        d_residuals[self.stateName] = self._psi_packed.copy()
        if not bool(info.converged):
            om.issue_warning(
                f"adjoint GMRES not fully converged: resid={info.resid}",
                category=om.OpenMDAOWarning)


def _same_point(a, b) -> bool:
    return np.array_equal(a[0], b[0]) and a[1].keys() == b[1].keys() \
        and all(np.array_equal(a[1][n], b[1][n]) for n in a[1])


class DAFoamFunctions(om.ExplicitComponent):
    """Objective/constraint evaluation + partials (reference
    DAFoamFunctions, mphys_dafoam.py:687)."""

    def initialize(self):
        self.options.declare("solver", recordable=False)

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        self.stateName = f"{self.discipline}_states"
        self.input_reg = InputRegistry(solver,
                                       solver.option.get("inputInfo", {}))
        self.in_names = _input_names(solver, "function")
        self.add_input(self.stateName, distributed=True,
                       val=np.zeros(solver.layout.n_states),
                       tags=["mphys_coupling"])
        for name in self.in_names:
            self.add_input(name, val=_input_default(solver, self.input_reg,
                                                    name),
                           distributed=self.input_reg.distributed(name),
                           tags=["mphys_coupling"])
        for f_name in solver.option.get("function", {}):
            self.add_output(f_name, distributed=False, shape=1)

    def compute(self, inputs, outputs):
        solver = self.solver
        arrs = _arrays(solver, inputs, self.in_names)
        tree_ = _build_tree(solver, self.input_reg, arrs, self.in_names)
        st = solver.layout.unpack(_t(solver, inputs[self.stateName]))
        for f_name in solver.option["function"]:
            outputs[f_name] = float(solver.run_function(f_name, st, tree_))

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        if mode == "fwd":
            om.issue_warning("fwd mode not implemented",
                             category=om.OpenMDAOWarning)
            return
        solver = self.solver
        for f_name in solver.option["function"]:
            if f_name not in d_outputs:
                continue
            seed = float(np.asarray(d_outputs[f_name]).ravel()[0])
            if abs(seed) < 1e-36:
                continue
            w = _t(solver, inputs[self.stateName]).requires_grad_(True)
            arrs = _arrays(solver, inputs, self.in_names, grad=True)
            wrt = {n: a for n, a in arrs.items() if n in d_inputs}
            if self.stateName in d_inputs:
                wrt[self.stateName] = w
            if not wrt:
                continue
            with torch.enable_grad():
                J = solver.eval_function(
                    f_name, solver.layout.unpack(w),
                    _build_tree(solver, self.input_reg, arrs, self.in_names))
            g = _backward(J, wrt, None)
            for name, gv in g.items():
                d_inputs[name] = d_inputs[name] + seed * _np(gv)


class DAFoamWarper(om.ExplicitComponent):
    """Volume mesh warping from design-surface coordinates (reference
    DAFoamWarper, mphys_dafoam.py:804; IDWarp replaced by the in-house
    inverse-distance warp, dafoam_tpu_torch/mdo/warp.py)."""

    def initialize(self):
        self.options.declare("solver", recordable=False)

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        topo = solver.topo
        design = solver.option.get("designSurfaces", [])
        self.surf_ids = patch_point_ids(topo, design)
        pts0 = _points_np(solver)
        self.x_s0 = pts0[self.surf_ids]
        self._x_s0 = _t(solver, self.x_s0)
        # points on non-design boundary patches stay fixed
        fixed = set()
        for p in topo.patches:
            if p.name in design or p.kind == "empty":
                continue
            fixed.update(patch_point_ids(topo, [p.name]).tolist())
        fixed -= set(self.surf_ids.tolist())
        self.warp = IDWarp(pts0, self.surf_ids,
                           np.asarray(sorted(fixed), dtype=np.int64),
                           device=solver.device, dtype=solver.dtype)
        self.add_input(f"x_{self.discipline}", distributed=True,
                       val=self.x_s0.ravel(), tags=["mphys_coupling"])
        self.add_output(f"{self.discipline}_vol_coords", distributed=True,
                        val=pts0.ravel(), tags=["mphys_coupling"])

    def warp_flat(self, xs_flat: torch.Tensor) -> torch.Tensor:
        """Flat surface coordinates -> flat volume coordinates."""
        disp = xs_flat.reshape(-1, 3) - self._x_s0
        return self.warp(self.solver.points, disp).reshape(-1)

    def compute(self, inputs, outputs):
        xs = _t(self.solver, inputs[f"x_{self.discipline}"])
        with torch.no_grad():
            outputs[f"{self.discipline}_vol_coords"] = _np(
                self.warp_flat(xs))

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        if mode == "fwd":
            return
        vname = f"{self.discipline}_vol_coords"
        xname = f"x_{self.discipline}"
        if vname in d_outputs and xname in d_inputs:
            xs = _t(self.solver, inputs[xname]).requires_grad_(True)
            with torch.enable_grad():
                out = self.warp_flat(xs)
            (g,) = torch.autograd.grad(out, xs,
                                       _t(self.solver, d_outputs[vname]))
            d_inputs[xname] = d_inputs[xname] + _np(g)


class _CouplingOutputComp(om.ExplicitComponent):
    """Shared machinery for force/thermal coupling outputs: the output is a
    function of (packed states, vol coords); partials are one backward
    pass."""

    component_kind = None    # "forceCoupling" | "thermalCoupling"
    out_alias = None         # fixed OM variable name ("f_aero") or None

    def initialize(self):
        self.options.declare("solver", recordable=False)

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        self.stateName = f"{self.discipline}_states"
        self.volCoordName = f"{self.discipline}_vol_coords"
        self.out_reg = OutputRegistry(solver,
                                      solver.option.get("outputInfo", {}))
        self.outputName, cfg = _output_name(solver, self.component_kind)
        if self.outputName is None:
            raise RuntimeError(
                f"no outputInfo entry with components containing "
                f"{self.component_kind!r}")
        self.outputSize = self.out_reg.size(self.outputName)
        self.omOutName = self.out_alias or self.outputName
        self.add_input(self.volCoordName, distributed=True,
                       val=_points_np(solver).ravel(),
                       tags=["mphys_coupling"])
        self.add_input(self.stateName, distributed=True,
                       val=np.zeros(solver.layout.n_states),
                       tags=["mphys_coupling"])
        self.add_output(self.omOutName, distributed=True,
                        shape=self.outputSize, tags=["mphys_coupling"])

    def _eval_flat(self, w_packed, xv_flat):
        solver = self.solver
        tree_ = solver.make_inputs()
        tree_["points"] = xv_flat.reshape(-1, 3)
        st = solver.layout.unpack(w_packed)
        return self.out_reg.evaluate(self.outputName, st, tree_)

    def compute(self, inputs, outputs):
        solver = self.solver
        with torch.no_grad():
            outputs[self.omOutName] = _np(self._eval_flat(
                _t(solver, inputs[self.stateName]),
                _t(solver, inputs[self.volCoordName])))

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        if mode == "fwd":
            return
        solver = self.solver
        if self.omOutName not in d_outputs:
            return
        wrt = {self.stateName: _t(solver, inputs[self.stateName]),
               self.volCoordName: _t(solver, inputs[self.volCoordName])}
        for v in wrt.values():
            v.requires_grad_(True)
        with torch.enable_grad():
            out = self._eval_flat(wrt[self.stateName],
                                  wrt[self.volCoordName])
        g = _backward(out, wrt, _t(solver, d_outputs[self.omOutName]))
        for name, gv in g.items():
            if name in d_inputs:
                d_inputs[name] = d_inputs[name] + _np(gv)


class DAFoamForces(_CouplingOutputComp):
    """FSI surface-force output f_aero: NODAL forces [fX..., fY..., fZ...]
    (reference DAFoamForces mphys_dafoam.py:1004,
    DAOutputForceCoupling.C:45-68)."""

    component_kind = "forceCoupling"
    out_alias = "f_aero"


class DAFoamThermal(_CouplingOutputComp):
    """CHT coupling output [T_nearwall..., kappa/d...] (reference
    DAFoamThermal mphys_dafoam.py:862, DAOutputThermalCoupling.C:42-66)."""

    component_kind = "thermalCoupling"
    out_alias = None


class DAFoamFaceCoords(om.ExplicitComponent):
    """Coupling-face coordinates from volume coordinates (reference
    DAFoamFaceCoords mphys_dafoam.py:954, calcCouplingFaceCoords
    DASolver.C:1841). Matches the reference layout: one (x,y,z) triple per
    entry of the thermal coupling output (= 2 per face: the T half and the
    kappa/d half both carry the face centre)."""

    def initialize(self):
        self.options.declare("solver", recordable=False)

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        self.volCoordName = f"{self.discipline}_vol_coords"
        self.surfCoordName = f"x_{self.discipline}_surface0"
        name, cfg = _output_name(solver, "thermalCoupling")
        if name is None:
            raise RuntimeError("no thermalCoupling output found!")
        self.fids = patch_face_ids(solver.topo, cfg["patches"])
        reg = OutputRegistry(solver, solver.option["outputInfo"])
        self.nSurfCoords = reg.size(name) * 3
        self.add_input(self.volCoordName, distributed=True,
                       val=_points_np(solver).ravel(),
                       tags=["mphys_coupling"])
        self.add_output(self.surfCoordName, distributed=True,
                        shape=self.nSurfCoords, tags=["mphys_coupling"])

    def compute(self, inputs, outputs):
        solver = self.solver
        pts = _t(solver, inputs[self.volCoordName]).reshape(-1, 3)
        with torch.no_grad():
            geom = compute_geometry(pts, solver.topo)
            cf = geom.cf[torch.as_tensor(self.fids, device=pts.device)]
            outputs[self.surfCoordName] = _np(torch.cat([cf, cf]).ravel())

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        # load-transfer tools treat surface0 as fixed (zero seed); the
        # reference passes here too (mphys_dafoam.py:1000)
        pass


class DAFoamLinearConstraint(om.ExplicitComponent):
    """Per-pair linear combinations out_i = coeffA[i]*varA[i] +
    coeffB[i]*varB[i] (reference DAFoamLinearConstraint,
    mphys_dafoam.py:1682)."""

    def initialize(self):
        self.options.declare("varA", recordable=False)
        self.options.declare("coeffA", recordable=False, default=1.0)
        self.options.declare("varB", recordable=False)
        self.options.declare("coeffB", recordable=False, default=1.0)
        self.options.declare("size", recordable=False, default=1)
        self.options.declare("output_name", recordable=False, default="con")

    def setup(self):
        varA, varB = self.options["varA"], self.options["varB"]
        n = len(varA)
        assert len(varB) == n

        def bcast(v):
            return list(v) if isinstance(v, (list, tuple)) else [v] * n

        self.cA = [float(c) for c in bcast(self.options["coeffA"])]
        self.cB = [float(c) for c in bcast(self.options["coeffB"])]
        self.sizes = [int(s) for s in bcast(self.options["size"])]
        self.base = self.options["output_name"]
        for i in range(n):
            self.add_input(varA[i], shape=self.sizes[i],
                           val=np.zeros(self.sizes[i]))
            self.add_input(varB[i], shape=self.sizes[i],
                           val=np.zeros(self.sizes[i]))
            self.add_output(f"{self.base}_{i}", shape=self.sizes[i],
                            val=np.zeros(self.sizes[i]))

    def compute(self, inputs, outputs):
        varA, varB = self.options["varA"], self.options["varB"]
        for i in range(len(varA)):
            outputs[f"{self.base}_{i}"] = (
                self.cA[i] * np.asarray(inputs[varA[i]])
                + self.cB[i] * np.asarray(inputs[varB[i]]))

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        if mode == "fwd":
            return
        varA, varB = self.options["varA"], self.options["varB"]
        for i in range(len(varA)):
            oname = f"{self.base}_{i}"
            if oname not in d_outputs:
                continue
            seed = np.asarray(d_outputs[oname])
            if varA[i] in d_inputs:
                d_inputs[varA[i]] = d_inputs[varA[i]] + self.cA[i] * seed
            if varB[i] in d_inputs:
                d_inputs[varB[i]] = d_inputs[varB[i]] + self.cB[i] * seed


def _pull_back(out, totals, arr):
    """totals (input-shaped) pulled back onto the flat design tensor arr
    through ``out`` = the inputs dict with arr injected."""
    outs, seeds = [], []

    def walk(o, t):
        if isinstance(o, dict):
            for k in o:
                if isinstance(t, dict) and k in t:
                    walk(o[k], t[k])
        elif isinstance(o, torch.Tensor) and o.requires_grad:
            outs.append(o)
            seeds.append(torch.as_tensor(t, dtype=o.dtype, device=o.device))

    walk(out, totals)
    if not outs:
        return torch.zeros_like(arr)
    (g,) = torch.autograd.grad(outs, arr, seeds, allow_unused=True)
    return torch.zeros_like(arr) if g is None else g


class DAFoamSolverUnsteady(om.ExplicitComponent):
    """Unsteady (time-accurate) solver + adjoint component (reference
    DAFoamSolverUnsteady, mphys_dafoam.py:1290: primal writes the time
    history; compute_jacvec_product reverse-sweeps it, :1390-1679). Here
    the history is the stacked dict of solve_primal_history and the
    reverse sweep is the solver's solve_unsteady_adjoint."""

    def initialize(self):
        self.options.declare("solver", recordable=False)
        self.options.declare("run_directory", default="")

    def setup(self):
        self.solver = self.options["solver"]
        solver = self.solver
        self.discipline = solver.option.get("discipline", "aero")
        self.input_reg = InputRegistry(solver,
                                       solver.option.get("inputInfo", {}))
        self.in_names = _input_names(solver, "solver")
        for name in self.in_names:
            self.add_input(name, val=_input_default(solver, self.input_reg,
                                                    name),
                           distributed=self.input_reg.distributed(name),
                           tags=["mphys_coupling"])
        for f_name in solver.option.get("function", {}):
            self.add_output(f_name, distributed=False, shape=1)
        self._hist = None
        self._tree_cache = None

    def _tree(self, inputs):
        return _build_tree(self.solver, self.input_reg,
                           _arrays(self.solver, inputs, self.in_names),
                           self.in_names)

    def compute(self, inputs, outputs):
        solver = self.solver
        tree_ = self._tree(inputs)
        with torch.no_grad():
            stT, hist = solver.solve_primal_history(solver.init_state(),
                                                    tree_)
        if not solver.states_valid(stT):
            raise om.AnalysisError("dafoam_tpu_torch unsteady primal failed")
        self._hist, self._tree_cache = hist, tree_
        for f_name in solver.option["function"]:
            with torch.no_grad():
                J, _ = solver.eval_function_history(f_name, hist, tree_)
            outputs[f_name] = float(J)

    def compute_jacvec_product(self, inputs, d_inputs, d_outputs, mode):
        if mode == "fwd" or self._hist is None:
            return
        solver = self.solver
        tree_ = self._tree_cache
        for f_name in solver.option["function"]:
            if f_name not in d_outputs:
                continue
            seed = float(np.asarray(d_outputs[f_name]).ravel()[0])
            if abs(seed) < 1e-36:
                continue
            totals, _ = solver.solve_unsteady_adjoint(self._hist, tree_,
                                                      f_name)
            for name in self.in_names:
                if name not in d_inputs:
                    continue
                arr = _t(solver, inputs[name]).requires_grad_(True)
                with torch.enable_grad():
                    out = self.input_reg.apply(name, tree_, arr)
                g = _pull_back(out, totals, arr)
                d_inputs[name] = d_inputs[name] + seed * _np(g)


class DAFoamBuilderUnsteady(om.Group):
    """Unsteady builder group (reference DAFoamBuilderUnsteady,
    mphys_dafoam.py:1250): optional warper + unsteady solver, promoted."""

    def initialize(self):
        self.options.declare("solver_options")
        self.options.declare("mesh_pair", default=None)
        self.options.declare("run_directory", default="")
        self.options.declare("device", default="cuda")
        self.options.declare("dtype", default=torch.float32)

    def setup(self):
        from dafoam_tpu_torch.solvers import make_solver

        if getattr(self, "_built", False):
            return
        self._built = True
        opts = self.options["solver_options"]
        points, topo = self.options["mesh_pair"]
        self.DASolver = make_solver(opts, topo, points,
                                    device=self.options["device"],
                                    dtype=self.options["dtype"])
        info = opts.get("inputInfo", {}) or {}
        if any(cfg["type"] == "volCoord" and "solver" in cfg["components"]
               for cfg in info.values()):
            self.add_subsystem("warper", DAFoamWarper(solver=self.DASolver),
                               promotes=["*"])
        self.add_subsystem("solver",
                           DAFoamSolverUnsteady(solver=self.DASolver),
                           promotes=["*"])

    def get_surface_mesh(self):
        pids = patch_point_ids(
            self.DASolver.topo, self.DASolver.option.get("designSurfaces",
                                                         []))
        return _points_np(self.DASolver)[pids].ravel()
