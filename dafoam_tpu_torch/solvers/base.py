"""Solver base (port of the primal half of ``dafoam_tpu.solvers.base``).

The reference's DASolver (src/adjoint/DASolver/DASolver.H:233) owns the
mesh, primal loop control and failure handling. Here:

- ``inputs`` is a dict {points, bc: {field: {patch: value}}, params: {...}}
  of tensors on the solver's device;
- ``solve_primal`` is a Python loop over device work, run under
  ``torch.no_grad()`` by ``run_primal``;
- ``residuals`` (one function per concrete solver) and
  ``_norm_residuals``, the normalizeResiduals scaling of the reference
  (src/include/DAMacroFunctions.H:28-50);
- ``solve_adjoint`` / ``total_derivative`` / ``forward_total_derivative``:
  the residual-form adjoint dR/dW^T psi = dJ/dW (``adjEqnSolMethod:
  Krylov``, FGMRES with the block PCs of ``adjoint/precond.py``) or the
  fixed-point adjoint of the primal step map (``fixedPoint``), both with
  the state normalization of the reference (normalizeStates,
  DASolver.C:2356);
- primal failure detection (NaN/blow-up -> invalid state; reference
  DASolver::validateStates / checkPrimalFailure, DASolver.C:3787).

The JAX package's ``jitMode`` has no counterpart (PyTorch runs eagerly).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from dafoam_tpu_torch.adjoint import solver as adjsolver
from dafoam_tpu_torch.functions import evaluate_function
from dafoam_tpu_torch.linalg import fvsolve
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.states import StateInfo, StateLayout

# DAMisc parametric BC types (ops/bc.py): their numeric parameters are
# inputs, so they can be design variables
_PARAMETRIC_BC_TYPES = (
    "multiFreqScalar", "multiFreqVector", "varyingVelocity",
    "varyingVelocityInletOutlet", "homTemp", "wallHeatFluxTransfer",
    "fixedWallHeatFlux")
# spec keys that stay static (structure, not values)
_STATIC_BC_KEYS = ("type", "component", "flowComponent",
                   "normalComponent", "endTime", "value")

class PrimalInfo(NamedTuple):
    iters: int
    max_res: float            # max normalized eqn residual at exit
    converged: bool
    failed: bool              # NaN / bounds blow-up detected


class DASolverBase:
    state_info: StateInfo = StateInfo()

    def __init__(self, option, topo, points, *, device, dtype):
        self.option = option if isinstance(option, DAOption) \
            else DAOption(option)
        self.topo = topo
        self.device = torch.device(device)
        self.dtype = dtype
        # Krylov work of the inner solves: {equation: [solves, iterations]}
        self.solve_stats = {}
        self.points = self._tensor(np.asarray(points))
        self.layout = StateLayout(
            self.state_info, topo.n_cells, topo.n_faces,
            ordering=self.option.get("adjStateOrdering", "state"))
        # static BC types; values split into inputs
        self.bc_spec = {}
        self.bc_values0 = {}
        for field, patches in self.option.get("boundaryConditions",
                                              {}).items():
            self.bc_spec[field] = {}
            self.bc_values0[field] = {}
            for pname, spec in patches.items():
                self.bc_spec[field][pname] = {
                    k: v for k, v in spec.items() if k != "value"}
                if spec.get("type") in _PARAMETRIC_BC_TYPES:
                    self.bc_values0[field][pname] = {
                        k: self._tensor(v) for k, v in spec.items()
                        if k not in _STATIC_BC_KEYS}
                elif "value" in spec:
                    self.bc_values0[field][pname] = self._tensor(
                        spec["value"])
        # default empty-patch handling: every field gets "empty" on empty kinds
        for field in self.bc_spec:
            for p in topo.patches:
                if p.kind == "empty":
                    self.bc_spec[field][p.name] = {"type": "empty"}
                elif p.name not in self.bc_spec[field]:
                    self.bc_spec[field][p.name] = {"type": "zeroGradient"}

    def _tensor(self, v):
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _log_solve(self, name, info):
        st = self.solve_stats.setdefault(name, [0, 0])
        st[0] += 1
        st[1] += info.iters

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------
    def make_inputs(self) -> dict:
        params = {k: self._tensor(v)
                  for k, v in self.option["transportProperties"].items()}
        bcv = {f: {p: dict(v) if isinstance(v, dict) else v
                   for p, v in pv.items()}
               for f, pv in self.bc_values0.items()}
        return {"points": self.points, "bc": bcv, "params": params}

    def geometry(self, inputs):
        return compute_geometry(inputs["points"], self.topo)

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------
    def residuals(self, state: dict, inputs: dict) -> dict:
        raise NotImplementedError

    def solve_primal(self, state: dict, inputs: dict):
        raise NotImplementedError

    def init_state(self) -> dict:
        st = self.layout.zeros(self.dtype, device=self.device)
        for name, val in self.option.get("initialFields", {}).items():
            if name in st:
                st[name] = torch.broadcast_to(
                    self._tensor(val), st[name].shape).clone()
        return st

    # ------------------------------------------------------------------
    # residual post-scaling (normalizeResiduals semantics, reference
    # src/include/DAMacroFunctions.H:28-50)
    # ------------------------------------------------------------------
    def _apply_res_norm(self, res: dict, geom) -> dict:
        """Listed residuals stay per volume (phi: per face area, with a
        neutral 1 on the zero-area padded faces of the dense layout, whose
        R_phi row is the identity -phi); the others are volume-integrated."""
        listed = set(self.option["normalizeResiduals"])
        out = {}
        for k, v in res.items():
            if k == "phi":
                out[k] = v / torch.where(geom.magsf > 0.0, geom.magsf, 1.0) \
                    if "phiRes" in listed else v
            elif k + "Res" in listed:
                out[k] = v
            else:
                out[k] = v * (geom.vol if v.ndim == 1 else geom.vol[:, None])
        return out

    def _norm_residuals(self, state, inputs):
        geom = self.geometry(inputs)
        return self._apply_res_norm(self.residuals(state, inputs), geom)

    # ------------------------------------------------------------------
    # functions
    # ------------------------------------------------------------------
    def function_ctx(self, state, inputs, with_residuals=False) -> dict:
        """Build the evaluation context for the function registry."""
        geom = self.geometry(inputs)
        phi = state.get("phi")
        if phi is None:
            phi = geom.magsf.new_zeros((self.topo.n_faces,))
        ctx = {"state": state, "geom": geom, "topo": self.topo,
               "boundary": self.boundary_fields(state, inputs, geom),
               "phi": phi, "aux": self.aux_fields(state, inputs, geom),
               "data": inputs.get("data", {})}
        if with_residuals:
            ctx["residuals"] = self.residuals(state, inputs)
        return ctx

    def boundary_fields(self, state, inputs, geom) -> dict:
        """Override: boundary-face values of each field for functions."""
        return {}

    def aux_fields(self, state, inputs, geom) -> dict:
        """Override: derived cell fields functions may read by name."""
        return {}

    def eval_function(self, name, state, inputs):
        cfg = self.option["function"][name]
        ctx = self.function_ctx(state, inputs,
                                with_residuals=cfg["type"] == "residualNorm")
        return evaluate_function(cfg, ctx)

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def run_primal(self, state, inputs):
        with torch.no_grad():
            return self.solve_primal(state, inputs)

    def run_function(self, name, state, inputs):
        with torch.no_grad():
            return self.eval_function(name, state, inputs)

    # ------------------------------------------------------------------
    # adjoint + totals
    # ------------------------------------------------------------------
    def state_scales(self, geom) -> dict:
        """normalizeStates per state; phi scales by the face area, with a
        neutral 1 on the degenerate (zero-area) padded faces of the
        dense-DIA layout."""
        ns = self.option["normalizeStates"]
        out = {}
        for name, _k in self.state_info.ordered:
            s = ns.get(name, 1.0)
            if name == "phi":
                out[name] = s * torch.where(geom.magsf > 0.0, geom.magsf,
                                            1.0)
            else:
                out[name] = self._tensor(s)
        return out

    def make_adjoint_pc(self, state, inputs):
        """Override: the residual-form adjoint's GMRES preconditioner (or
        None)."""
        return None

    def make_forward_pc(self, state, inputs):
        """Override: PC for the FORWARD linearized system dR/dW (used by
        forward_total_derivative); None = unpreconditioned."""
        return None

    def _fp_adjoint(self) -> bool:
        """True when the fixed-point adjoint is selected (and this solver
        has the step map it needs); False for the residual form."""
        if self.option["adjEqnSolMethod"] != "fixedPoint":
            return False
        if not hasattr(self, "primal_step"):
            raise NotImplementedError(
                f"{type(self).__name__} has no primal_step; "
                "adjEqnSolMethod fixedPoint is unavailable")
        return True

    def _scales(self, inputs):
        with torch.no_grad():
            return self.state_scales(self.geometry(inputs))

    def _fp_step_fn(self):
        """The differentiable step map of the fixed-point adjoint: one
        primal step with every inner solve as a fixed smoother
        (``fvsolve.fixed_inner``, fpInnerScale x the primal's maxIters,
        fpInnerSmoother) and the fpRelaxFields FIELD-relaxation overrides.
        Field relaxation is an explicit post-solve blend, so the primal's
        W* stays an exact fixed point for any alpha; equation relaxation
        changes rAU and is refused (fpRelaxEquations)."""
        opt = self.option["adjEqnOption"]
        if opt.get("fpInnerMode", "fixed") == "implicit":
            # every inner solve keeps its Krylov solve and is differentiated
            # by the implicit rule (fvsolve._LinearSolve: tight transpose
            # solves, ~10x the cost of a fixed-mode product)
            return lambda w, x: self.primal_step(w, x)
        scale = float(opt.get("fpInnerScale", 1.0))
        smoother = str(opt.get("fpInnerSmoother", "linear"))
        rf_f = dict(opt.get("fpRelaxFields", {}) or {})
        if opt.get("fpRelaxEquations"):
            raise ValueError(
                "fpRelaxEquations is not supported: overriding implicit "
                "(equation) relaxation changes rAU and shifts the step "
                "map's fixed point away from the primal solution, "
                "silently corrupting totals. Only fpRelaxFields (explicit "
                "field relaxation) preserves the fixed point exactly.")

        @contextlib.contextmanager
        def _relax_override():
            rf = self.option["relaxationFactors"]
            if not rf_f:
                yield
                return
            old_f = rf.get("fields", {})
            rf["fields"] = dict(old_f, **rf_f)
            try:
                yield
            finally:
                rf["fields"] = old_f

        def step(w, x):
            with _relax_override(), fvsolve.fixed_inner(scale, smoother):
                return self.primal_step(w, x)

        return step

    def _fp_scales(self, inputs):
        if not self.option["adjEqnOption"].get("fpNormalize", True):
            return None
        return self._scales(inputs)

    def solve_adjoint_rhs(self, state, inputs, dJdW, psi0=None,
                          precond=None, aug0=None, return_aug=False):
        """Solve the adjoint for a caller-supplied right-hand side pytree
        (the MPhys ``solve_linear`` contract). Residual form: psi of
        dR/dW^T psi = dJdW by FGMRES with the pcType preconditioner, built
        here unless ``precond`` is given. Fixed-point mode returns psibar
        (step-map convention); pair either with total_derivative."""
        opt = self.option["adjEqnOption"]
        if self._fp_adjoint():
            # pcType only configures forward_total_derivative's PC here
            return adjsolver.adjoint_solve_fp(
                self._fp_step_fn(), state, inputs, dJdW,
                rel_tol=opt.get("fpRelTol", 1e-6),
                abs_tol=opt["gmresAbsTol"],
                max_iters=opt.get("fpMaxIters", 1000),
                relax=opt.get("fpRelaxation", 1.0),
                accel=opt.get("fpAcceleration", "gmres"),
                restart=opt["gmresRestart"], psi0=psi0,
                deflate=int(opt.get("gmresDeflate", 0)),
                scales=self._fp_scales(inputs),
                aug0=aug0, return_aug=return_aug,
                remat=bool(opt.get("fpRemat", False)))
        if precond is None and opt.get("pcType", "none") != "none":
            precond = self.make_adjoint_pc(state, inputs)
        scales = self._scales(inputs)
        return adjsolver.adjoint_solve(
            self._norm_residuals, state, inputs, dJdW,
            state_scales=scales, res_scales=scales, precond=precond,
            restart=opt["gmresRestart"], rel_tol=opt["gmresRelTol"],
            abs_tol=opt["gmresAbsTol"], max_iters=opt["gmresMaxIters"],
            psi0=psi0, deflate=int(opt.get("gmresDeflate", 0)),
            aug0=aug0, return_aug=return_aug)

    def solve_adjoint(self, state, inputs, func_name, psi0=None,
                      precond=None, aug0=None, return_aug=False):
        dJdW = adjsolver.dJdW_of(
            lambda w, x: self.eval_function(func_name, w, x), state, inputs)
        return self.solve_adjoint_rhs(state, inputs, dJdW, psi0=psi0,
                                      precond=precond, aug0=aug0,
                                      return_aug=return_aug)

    def total_derivative(self, state, inputs, func_name, psi):
        """dJ/dx for every leaf of ``inputs`` from the adjoint vector (psi
        of the residual form, psibar of the fixed-point form)."""
        func = lambda w, x: self.eval_function(func_name, w, x)  # noqa: E731
        if self._fp_adjoint():
            return adjsolver.total_derivative_fp(
                self._fp_step_fn(), func, state, inputs, psi)
        return adjsolver.total_derivative(self._norm_residuals, func, state,
                                          inputs, psi)

    def forward_total_derivative(self, state, inputs, func_name, dx):
        """dJ = dJ/dx . dx by the tangent twin of the adjoint (the
        reference's forward-mode cross-check), in the SAME normalized
        metric as the adjoint (reference normalizeJacTVecProduct,
        DASolver.C:1443)."""
        opt = self.option["adjEqnOption"]
        func = lambda w, x: self.eval_function(func_name, w, x)  # noqa: E731
        if self._fp_adjoint():
            return adjsolver.forward_total_derivative_fp(
                self._fp_step_fn(), func, state, inputs, dx,
                rel_tol=opt.get("fpRelTol", 1e-6),
                abs_tol=opt["gmresAbsTol"],
                max_iters=opt.get("fpMaxIters", 1000),
                restart=opt["gmresRestart"],
                deflate=int(opt.get("gmresDeflate", 0)),
                scales=self._fp_scales(inputs))
        scales = self._scales(inputs)
        precond = None
        if opt.get("pcType", "none") != "none":
            pc_raw = self.make_forward_pc(state, inputs)
            if pc_raw is not None:
                def precond(r):  # D_W^-1 o pc_raw o D_R adapter
                    y = pc_raw(adjsolver._scale(r, scales))
                    return adjsolver._scale(y, scales, invert=True)
        return adjsolver.forward_total_derivative(
            self._norm_residuals, func, state, inputs, dx,
            restart=opt.get("gmresRestart", 60),
            max_iters=opt.get("gmresMaxIters", 2000),
            precond=precond, state_scales=scales, res_scales=scales)

    def run_adjoint(self, func_name, state, inputs):
        return self.solve_adjoint(state, inputs, func_name)

    def run_totals(self, func_name, state, inputs, psi):
        return self.total_derivative(state, inputs, func_name, psi)

    # ------------------------------------------------------------------
    # failure detection (reference DASolver::validateStates, DASolver.C:3787)
    # ------------------------------------------------------------------
    def states_valid_t(self, state) -> torch.Tensor:
        """All states finite and below 1e15 in magnitude, as a 0-d bool
        tensor on the device (no host sync)."""
        oks = [torch.all(torch.isfinite(v) & (torch.abs(v) < 1e15))
               for v in state.values()]
        return torch.stack(oks).all()

    def states_valid(self, state) -> bool:
        """``states_valid_t`` read on the host (one sync)."""
        return bool(self.states_valid_t(state))
