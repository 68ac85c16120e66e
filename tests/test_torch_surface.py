"""The public surface of dafoam_tpu_torch against dafoam_tpu's (CPU).

- ``register_solver`` (used as a class decorator) adds a
  DAScalarTransportFoam subclass that ``make_solver`` then builds, with
  the layout choice of a built-in solver;
- ``register_turbulence_model`` adds a SpalartAllmaras subclass under a
  new name that ``make_turbulence_model`` and ``turbulence_model_class``
  then find;
- every name that dafoam_tpu's package and subpackage ``__init__``s
  export imports from the same place in the port and is the port's
  counterpart. The list is written out here (the port's tests import no
  dafoam_tpu module they do not need); it leaves out only
  ``parallel.shard_case`` and ``parallel.mesh_axis_sharding``, dafoam_tpu's
  GSPMD placement, which the port does not have (``parallel/__init__.py``).

Each registration is removed again in a ``finally``, so that no other
test sees it.
"""

import importlib

import pytest
import torch

torch.set_num_threads(1)

P = "dafoam_tpu_torch"
# (package, name, module that defines it): dafoam_tpu's exports
EXPORTS = [
    ("", "DAOption", "option"),
    ("", "make_solver", "solvers"),
    ("", "box_hex_mesh", "mesh.generate"),
    ("", "read_polymesh", "mesh.polymesh"),
    ("adjoint", "adjoint_solve", "adjoint.solver"),
    ("adjoint", "total_derivative", "adjoint.solver"),
    ("adjoint", "forward_total_derivative", "adjoint.solver"),
    ("coupling", "CHTCoupling", "coupling.cht"),
    ("coupling", "FSICoupling", "coupling.fsi"),
    ("functions", "evaluate_function", "functions.registry"),
    ("linalg", "cg", "linalg.krylov"),
    ("linalg", "bicgstab", "linalg.krylov"),
    ("linalg", "gmres", "linalg.krylov"),
    ("linalg", "SolveInfo", "linalg.krylov"),
    ("mdo", "FFDBox", "mdo.ffd"),
    ("mdo", "IDWarp", "mdo.warp"),
    ("mesh", "MeshTopology", "mesh.topology"),
    ("mesh", "Patch", "mesh.topology"),
    ("mesh", "MeshGeometry", "mesh.geometry"),
    ("mesh", "compute_geometry", "mesh.geometry"),
    ("mesh", "box_hex_mesh", "mesh.generate"),
    ("models", "TurbulenceModel", "models.base"),
    ("models", "Laminar", "models.base"),
    ("models", "SpalartAllmaras", "models.spalart_allmaras"),
    ("models", "SpalartAllmarasFv3", "models.spalart_allmaras"),
    ("models", "KOmegaSST", "models.komega_sst"),
    ("models", "KOmegaSSTLM", "models.komega_sst_lm"),
    ("models", "KEpsilon", "models.ktwoeq"),
    ("models", "KOmega", "models.ktwoeq"),
    ("models", "make_turbulence_model", "models"),
    ("models", "register_turbulence_model", "models"),
    ("native", "available", "native"),
    ("native", "parse_labels_ascii", "native"),
    ("native", "parse_points_ascii", "native"),
    ("native", "parse_faces_ascii", "native"),
    ("ops", "bc", "ops.bc"),
    ("ops", "fvc", "ops.fvc"),
    ("ops", "fvm", "ops.fvm"),
    ("ops", "FvMatrix", "ops.fvmatrix"),
    ("parallel", "partition_cells", "parallel.partition"),
    ("parallel", "reorder_for_partitions", "parallel.partition"),
    ("solvers", "DASolverBase", "solvers.base"),
    ("solvers", "PrimalInfo", "solvers.base"),
    ("solvers", "DAScalarTransportFoam", "solvers.scalar_transport"),
    ("solvers", "DAHeatTransferFoam", "solvers.heat_transfer"),
    ("solvers", "DASimpleFoam", "solvers.simple"),
    ("solvers", "DAPimpleFoam", "solvers.pimple"),
    ("solvers", "DASolidDisplacementFoam", "solvers.solid"),
    ("solvers", "DARhoSimpleFoam", "solvers.rho_simple"),
    ("solvers", "DARhoSimpleCFoam", "solvers.rho_simple"),
    ("solvers", "DATurboFoam", "solvers.rho_simple"),
    ("solvers", "DATopoChtFoam", "solvers.topo_cht"),
    ("solvers", "DARhoPimpleFoam", "solvers.rho_pimple"),
    ("solvers", "DAPimpleDyMFoam", "solvers.pimple_dym"),
    ("solvers", "DAInterFoam", "solvers.inter"),
    ("solvers", "DAIrkPimpleFoam", "solvers.irk_pimple"),
    ("solvers", "DAHisaFoam", "solvers.hisa"),
    ("solvers", "DATimeSpectralScalarFoam", "solvers.time_spectral"),
    ("solvers", "make_solver", "solvers"),
    ("solvers", "register_solver", "solvers"),
    ("utils", "save_checkpoint", "utils.checkpoint"),
    ("utils", "load_checkpoint", "utils.checkpoint"),
    ("utils", "Timer", "utils.timing"),
]


def _module(rel):
    return importlib.import_module(f"{P}.{rel}" if rel else P)


def _register_solver():
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import (_SOLVER_REGISTRY,
                                          DAScalarTransportFoam, make_solver,
                                          register_solver)

    @register_solver
    class MyScalarFoam(DAScalarTransportFoam):
        pass

    try:
        assert MyScalarFoam.__name__ in _SOLVER_REGISTRY
        pts, topo = box_hex_mesh(6, 4, 1, (1.0, 0.6, 0.1),
                                 kinds={"zmin": "empty", "zmax": "empty"})
        opts = {"solverName": "MyScalarFoam", "ddtScheme": "steadyState",
                "boundaryConditions": {"T": {
                    "xmin": {"type": "fixedValue", "value": 1.0},
                    "xmax": {"type": "zeroGradient"},
                    "ymin": {"type": "zeroGradient"},
                    "ymax": {"type": "zeroGradient"}}},
                "initialFields": {"T": 1.0}}
        for layout, dense in (("canonical", False), ("diaDense", True)):
            s = make_solver(dict(opts, meshFaceLayout=layout), topo, pts,
                            device="cpu", dtype=torch.float64)
            assert type(s) is MyScalarFoam
            assert (s.topo.dia_dense() is not None) is dense
            assert s.init_state()["T"].dtype == torch.float64
    finally:
        _SOLVER_REGISTRY.pop("MyScalarFoam", None)
    with pytest.raises(KeyError):
        make_solver(opts, topo, pts, device="cpu", dtype=torch.float64)


def _register_model():
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.models import (_TURB_REGISTRY, SpalartAllmaras,
                                         make_turbulence_model,
                                         register_turbulence_model,
                                         turbulence_model_class)
    from dafoam_tpu_torch.option import DAOption

    class MySA(SpalartAllmaras):
        pass

    assert register_turbulence_model("mySA", MySA) is None
    try:
        assert turbulence_model_class("mySA") is MySA
        _, topo = box_hex_mesh(4, 4, 1, (1.0, 1.0, 0.1))
        m = make_turbulence_model("mySA", topo,
                                  DAOption({"turbulenceModel": "mySA"}))
        assert type(m) is MySA and m.model_states == ("nuTilda",)
    finally:
        _TURB_REGISTRY.pop("mySA", None)
    with pytest.raises(KeyError):
        turbulence_model_class("mySA")


HOOKS = {"register_solver": _register_solver,
         "register_turbulence_model": _register_model}


@pytest.mark.parametrize(
    "case", list(HOOKS) + [f"{pkg or P}:{name}" for pkg, name, _ in EXPORTS])
def test_public_surface(case):
    if case in HOOKS:
        HOOKS[case]()
        return
    pkg, name, src = next(e for e in EXPORTS
                          if f"{e[0] or P}:{e[1]}" == case)
    got = getattr(_module(pkg), name)
    defining = _module(src)
    # a module exported by name (ops.bc) is that module itself
    want = defining if src.rsplit(".", 1)[-1] == name else \
        getattr(defining, name)
    assert got is want, (case, got, want)
