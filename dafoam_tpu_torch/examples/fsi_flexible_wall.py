"""Aerostructural coupling: channel flow over a flexible plate, with the
coupled adjoint d(wall drag)/d(Young's modulus).

The case of tests/test_fsi.py (a 10x5 laminar channel over a 10x3 plate
clamped at both ends; ``nx``, ``ny_fluid`` and ``ny_solid`` scale it).
Float64, as the reference runs it:

    python -m dafoam_tpu_torch.examples.fsi_flexible_wall [--device cpu]
"""

import argparse

import torch

from dafoam_tpu_torch.coupling import FSICoupling
from dafoam_tpu_torch.mesh import box_hex_mesh
from dafoam_tpu_torch.solvers import make_solver

E0 = 5e4
ZERO = [0.0, 0.0, 0.0]


def fluid_options(**over):
    """The channel y in [0, 0.1]; its ymin wall is the coupling patch."""
    opts = {
        "solverName": "DASimpleFoam", "turbulenceModel": "None",
        "transportProperties": {"nu": 1e-3},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": ZERO},
                  "ymax": {"type": "fixedValue", "value": ZERO}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": 0.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"U": [1.0, 0.0, 0.0], "p": 0.0},
        "primalMinResTol": 1e-10, "primalMaxIters": 800,
        "relaxationFactors": {"fields": {"p": 0.2}, "equations": {"U": 0.5}},
        "function": {"drag": {"type": "force", "patches": ["ymin"],
                              "directionMode": "fixedDirection",
                              "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
    }
    opts.update(over)
    return opts


def solid_options(**over):
    """The plate y in [-0.02, 0]; its ymax patch is the coupling patch.
    ``primalMaxIters`` is the count of Picard iterations per solve."""
    opts = {
        "solverName": "DASolidDisplacementFoam",
        "transportProperties": {"E": E0, "nuPoisson": 0.3,
                                "rhoSolid": 1000.0},
        "boundaryConditions": {
            "D": {"xmin": {"type": "fixedValue", "value": ZERO},
                  "xmax": {"type": "fixedValue", "value": ZERO},
                  "ymin": {"type": "fixedValue", "value": ZERO},
                  "ymax": {"type": "fixedGradient", "value": ZERO}},
        },
        "initialFields": {"D": ZERO},
        "primalMinResTol": 1e-9, "primalMaxIters": 300,
        "relaxationFactors": {"fields": {"D": 0.9}, "equations": {}},
        "function": {},
        "normalizeStates": {"D": 1e-4},
    }
    opts.update(over)
    return opts


def meshes(nx=10, ny_fluid=5, ny_solid=3, box=box_hex_mesh):
    """((fluid points, topology), (solid points, topology)); ``box`` is a
    ``box_hex_mesh`` with this one's signature."""
    fluid = box(nx, ny_fluid, 1, (1.0, 0.1, 0.01),
                kinds={"zmin": "empty", "zmax": "empty",
                       "ymin": "wall", "ymax": "wall"})
    pts_s, topo_s = box(nx, ny_solid, 1, (1.0, 0.02, 0.01),
                        kinds={"zmin": "empty", "zmax": "empty"})
    pts_s = pts_s.copy()
    pts_s[:, 1] -= 0.02
    return fluid, (pts_s, topo_s)


def build(device, dtype, nx=10, ny_fluid=5, ny_solid=3, fluid_over=None,
          solid_over=None):
    """The FSICoupling of the flexible wall (fluid patch ymin, solid patch
    ymax)."""
    (pts_f, topo_f), (pts_s, topo_s) = meshes(nx, ny_fluid, ny_solid)
    fluid = make_solver(fluid_options(**(fluid_over or {})), topo_f, pts_f,
                        device=device, dtype=dtype)
    solid = make_solver(solid_options(**(solid_over or {})), topo_s, pts_s,
                        device=device, dtype=dtype)
    return FSICoupling(fluid, solid, "ymin", "ymax")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--n-outer", type=int, default=8)
    args = ap.parse_args(argv)

    fsi = build(args.device, getattr(torch, args.dtype))
    fluid, solid = fsi.fluid, fsi.solid
    inf, ins = fluid.make_inputs(), solid.make_inputs()
    sf, ss, infos = fsi.solve_primal(fluid.init_state(), solid.init_state(),
                                     inf, ins, n_outer=args.n_outer)
    print("interface displacement:", float(fsi.interface_displacement(ss,
                                                                      ins)))
    print("drag:", float(fsi.eval_function({"fluid": sf, "solid": ss}, inf,
                                           ins, "fluid", "drag")))
    tot_f, tot_s, info = fsi.solve_adjoint(sf, ss, inf, ins, "fluid", "drag")
    print("d(drag)/d(E):", float(tot_s["params"]["E"]))
    return tot_s


if __name__ == "__main__":
    main()
