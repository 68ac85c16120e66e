"""Solver registry and ``make_solver`` (port of ``dafoam_tpu.solvers``)."""

import torch

from dafoam_tpu_torch.mesh.topology import to_dia_dense
from dafoam_tpu_torch.option import DAOption
from dafoam_tpu_torch.solvers.base import DASolverBase, PrimalInfo
from dafoam_tpu_torch.solvers.heat_transfer import DAHeatTransferFoam
from dafoam_tpu_torch.solvers.hisa import DAHisaFoam
from dafoam_tpu_torch.solvers.inter import DAInterFoam
from dafoam_tpu_torch.solvers.irk_pimple import DAIrkPimpleFoam
from dafoam_tpu_torch.solvers.pimple import DAPimpleFoam
from dafoam_tpu_torch.solvers.pimple_dym import DAPimpleDyMFoam
from dafoam_tpu_torch.solvers.rho_pimple import DARhoPimpleFoam
from dafoam_tpu_torch.solvers.rho_simple import (DARhoSimpleCFoam,
                                                 DARhoSimpleFoam,
                                                 DATurboFoam)
from dafoam_tpu_torch.solvers.scalar_transport import DAScalarTransportFoam
from dafoam_tpu_torch.solvers.simple import DASimpleFoam
from dafoam_tpu_torch.solvers.solid import DASolidDisplacementFoam
from dafoam_tpu_torch.solvers.time_spectral import DATimeSpectralScalarFoam
from dafoam_tpu_torch.solvers.topo_cht import DATopoChtFoam

_SOLVER_REGISTRY = {c.__name__: c for c in (
    DAScalarTransportFoam, DAHeatTransferFoam, DASimpleFoam,
    DASolidDisplacementFoam, DARhoSimpleFoam, DARhoSimpleCFoam, DATurboFoam,
    DATopoChtFoam, DAHisaFoam, DAPimpleFoam, DARhoPimpleFoam,
    DAPimpleDyMFoam, DAInterFoam, DAIrkPimpleFoam, DATimeSpectralScalarFoam)}
# unsteadyAdjoint mode "hybrid" (time-spectral) selects these solvers
_HYBRID = {"DAScalarTransportFoam": "DATimeSpectralScalarFoam"}


def make_solver(option, topo, points, *, device, dtype):
    """Run-time solver selection (reference DASolver::New(solverName)).

    ``device`` and ``dtype`` say where and in which precision the solver
    keeps its state, geometry and matrices. meshFaceLayout "auto" picks the
    dense-DIA face layout on a CUDA device and the canonical one on the
    CPU; "diaDense" and "canonical" force a layout. unsteadyAdjoint mode
    "hybrid" selects the time-spectral form of a solver that has one.
    """
    opt = option if isinstance(option, DAOption) else DAOption(option)
    name = opt["solverName"]
    if opt["unsteadyAdjoint"].get("mode") == "hybrid":
        if name in _HYBRID:
            name = _HYBRID[name]
        elif name not in _HYBRID.values():
            raise NotImplementedError(
                f"unsteadyAdjoint mode 'hybrid' (time-spectral) is "
                f"implemented for {sorted(_HYBRID)} only, not {name!r}")
    if name not in _SOLVER_REGISTRY:
        raise KeyError(f"unknown solver {name!r}; have "
                       f"{list(_SOLVER_REGISTRY)}")
    device = torch.device(device)
    layout = opt.get("meshFaceLayout", "auto")
    if layout not in ("auto", "diaDense", "canonical"):
        raise ValueError(f"meshFaceLayout {layout!r}")
    if layout != "canonical" and topo.dia_dense() is None:
        if layout == "diaDense" or device.type == "cuda":
            dense = to_dia_dense(topo)
            if dense is not None:
                topo = dense
            elif layout == "diaDense":
                raise ValueError("mesh is not banded; diaDense layout "
                                 "unavailable (use meshFaceLayout=canonical)")
    return _SOLVER_REGISTRY[name](opt, topo, points, device=device,
                                  dtype=dtype)


__all__ = ["DASolverBase", "PrimalInfo", "DAScalarTransportFoam",
           "DAHeatTransferFoam", "DASimpleFoam", "DASolidDisplacementFoam",
           "DARhoSimpleFoam", "DARhoSimpleCFoam", "DATurboFoam",
           "DATopoChtFoam", "DAHisaFoam", "DAPimpleFoam", "DARhoPimpleFoam",
           "DAPimpleDyMFoam", "DAInterFoam", "DAIrkPimpleFoam",
           "DATimeSpectralScalarFoam", "make_solver"]
