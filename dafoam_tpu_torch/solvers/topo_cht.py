"""Topology-optimization conjugate-heat solver (port of
``dafoam_tpu.solvers.topo_cht``).

Reference: DATopoChtFoam: incompressible SIMPLE with a temperature
equation and a porosity field alphaPorosity that blocks the flow in
"solid" cells, the design variable of fluid-path topology optimization.
Both pieces live in DASimpleFoam; this subclass requires the T field and
registers the solver name.
"""

import torch

from dafoam_tpu_torch.solvers.simple import DASimpleFoam


class DATopoChtFoam(DASimpleFoam):
    def __init__(self, option, topo, points, *, device, dtype):
        bcs = (option.get("boundaryConditions", {})
               if isinstance(option, dict) else option["boundaryConditions"])
        if "T" not in bcs:
            raise ValueError("DATopoChtFoam requires a T field "
                             "(boundaryConditions.T)")
        super().__init__(option, topo, points, device=device, dtype=dtype)

    def make_inputs(self):
        inputs = super().make_inputs()
        inputs["params"].setdefault(
            "alphaPorosity", torch.zeros((self.topo.n_cells,),
                                         dtype=self.dtype,
                                         device=self.device))
        return inputs
