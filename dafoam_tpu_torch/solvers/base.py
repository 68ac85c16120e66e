"""Solver base (port of the primal half of ``dafoam_tpu.solvers.base``).

The reference's DASolver (src/adjoint/DASolver/DASolver.H:233) owns the
mesh, primal loop control and failure handling. Here:

- ``inputs`` is a dict {points, bc: {field: {patch: value}}, params: {...}}
  of tensors on the solver's device;
- ``solve_primal`` is a Python loop over device work, run under
  ``torch.no_grad()`` by ``run_primal``;
- primal failure detection (NaN/blow-up -> invalid state; reference
  DASolver::validateStates / checkPrimalFailure, DASolver.C:3787).

The adjoint, totals and the jit-mode entry points of the JAX base class
arrive with the adjoint slice and raise here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dafoam_tpu_torch.functions import evaluate_function
from dafoam_tpu_torch.mesh.geometry import compute_geometry
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.states import StateInfo, StateLayout

# DAMisc parametric BC types of dafoam_tpu: not in this slice
_PARAMETRIC_BC_TYPES = (
    "multiFreqScalar", "multiFreqVector", "varyingVelocity",
    "varyingVelocityInletOutlet", "homTemp", "wallHeatFluxTransfer",
    "fixedWallHeatFlux")

_ADJOINT_SLICE = ("the adjoint and totals are not ported yet "
                  "(ROADMAP.md queue 1, P5)")


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
                if spec.get("type") in _PARAMETRIC_BC_TYPES:
                    raise NotImplementedError(
                        f"BC type {spec['type']!r} is not ported yet")
                self.bc_spec[field][pname] = {
                    k: v for k, v in spec.items() if k != "value"}
                if "value" in spec:
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

    # ------------------------------------------------------------------
    # inputs
    # ------------------------------------------------------------------
    def make_inputs(self) -> dict:
        params = {k: self._tensor(v)
                  for k, v in self.option["transportProperties"].items()}
        return {"points": self.points,
                "bc": {f: dict(v) for f, v in self.bc_values0.items()},
                "params": params}

    def geometry(self, inputs):
        return compute_geometry(inputs["points"], self.topo)

    # ------------------------------------------------------------------
    # abstract interface
    # ------------------------------------------------------------------
    def solve_primal(self, state: dict, inputs: dict):
        raise NotImplementedError

    def init_state(self) -> dict:
        st = self.layout.zeros(self.dtype, self.device)
        for name, val in self.option.get("initialFields", {}).items():
            if name in st:
                st[name] = torch.broadcast_to(
                    self._tensor(val), st[name].shape).clone()
        return st

    # ------------------------------------------------------------------
    # functions
    # ------------------------------------------------------------------
    def function_ctx(self, state, inputs) -> dict:
        """Build the evaluation context for the function registry."""
        geom = self.geometry(inputs)
        return {"state": state, "geom": geom, "topo": self.topo,
                "boundary": self.boundary_fields(state, inputs, geom),
                "phi": state["phi"]}

    def boundary_fields(self, state, inputs, geom) -> dict:
        """Override: boundary-face values of each field for functions."""
        return {}

    def eval_function(self, name, state, inputs):
        cfg = self.option["function"][name]
        return evaluate_function(cfg, self.function_ctx(state, inputs))

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def run_primal(self, state, inputs):
        with torch.no_grad():
            return self.solve_primal(state, inputs)

    def run_function(self, name, state, inputs):
        with torch.no_grad():
            return self.eval_function(name, state, inputs)

    def solve_adjoint(self, *args, **kw):
        raise NotImplementedError(_ADJOINT_SLICE)

    def total_derivative(self, *args, **kw):
        raise NotImplementedError(_ADJOINT_SLICE)

    run_adjoint = solve_adjoint
    run_totals = total_derivative

    # ------------------------------------------------------------------
    # failure detection (reference DASolver::validateStates, DASolver.C:3787)
    # ------------------------------------------------------------------
    def states_valid(self, state) -> bool:
        """All states finite and below 1e15 in magnitude (one host sync)."""
        oks = [torch.all(torch.isfinite(v) & (torch.abs(v) < 1e15))
               for v in state.values()]
        return bool(torch.stack(oks).all())
