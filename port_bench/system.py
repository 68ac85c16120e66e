"""The system under test and the stand-in that takes its place in the
control.

``Program`` is dafoam_tpu_torch: it reads the case's polyMesh from disk
with ``mesh.polymesh.read_polymesh`` and builds the solver with
``solvers.make_solver``, in float32 on the device, as a user does.

``Control`` is the plain reference (``reference/plain.py``) behind the
part of the solver's interface that ``drive.py`` uses, in float32 with the
state rounded to bfloat16, the precision below the configuration's
float32, after every SIMPLE iteration, and the function's value rounded
too. The arithmetic between those roundings stays float32: a SIMPLE
iteration wholly in bfloat16 does not stay finite.
"""

from __future__ import annotations

import types


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    def __init__(self, device):
        import torch
        self.device = device
        self.dtype = torch.float32

    def sync(self):
        _sync(self.device)

    def read_mesh(self, case):
        from dafoam_tpu_torch.mesh.polymesh import read_polymesh
        return read_polymesh(case["dir"])

    def make_solver(self, opts, topo, points):
        from dafoam_tpu_torch.solvers import make_solver
        return make_solver(opts, topo, points, device=self.device,
                           dtype=self.dtype)


def _bf16(t):
    import torch
    return t.to(torch.bfloat16).to(t.dtype)


class _Options(dict):
    def set(self, key, value):
        self[key] = value


class ControlSolver:
    """The plain reference as ``drive.py`` drives a solver: run_primal,
    run_function, init_state, make_inputs, option.set, solve_stats."""

    def __init__(self, case, opts):
        self.case = case
        self.option = _Options(opts)
        self.solve_stats = {}
        self.topo = None          # faces in the mesh's own order

    def make_inputs(self):
        return None

    def init_state(self):
        return {k: _bf16(v) for k, v in self.case.init_state().items()}

    def run_primal(self, state, inputs):
        import torch
        n = int(self.option["primalMaxIters"])
        for _ in range(n):
            state = {k: _bf16(v) for k, v in self.case.step(state).items()}
        finite = all(bool(torch.isfinite(v).all()) for v in state.values())
        return state, types.SimpleNamespace(iters=n, failed=not finite)

    def run_function(self, name, state, inputs):
        import torch
        cfg = self.option["function"][name]
        v = self.case.force(state, cfg["patches"], cfg["direction"],
                            cfg.get("scale", 1.0))
        return float(_bf16(torch.tensor(v, dtype=torch.float32)))


class Control:
    def __init__(self, device):
        self.device = device

    def sync(self):
        _sync(self.device)

    def read_mesh(self, case):
        return case["mesh"], None

    def make_solver(self, opts, topo, mesh):
        import torch

        from port_bench.reference.plain import Case
        return ControlSolver(Case(mesh, opts, device=self.device,
                                  dtype=torch.float32), opts)
