"""Conjugate heat transfer: fluid channel over a heated solid slab, with
the coupled adjoint d(outlet T)/d(bottom wall T).

Port of examples/cht_heated_plate.py, with its own copy of the case of
tests/test_cht.py (a 12x6 laminar channel over a 12x4 slab; ``nx``,
``ny_fluid`` and ``ny_solid`` scale it). Float64, as the reference runs it:

    python -m dafoam_tpu_torch.examples.cht_heated_plate [--device cpu]
"""

import argparse

import torch

from dafoam_tpu_torch.coupling import CHTCoupling
from dafoam_tpu_torch.mesh import box_hex_mesh
from dafoam_tpu_torch.solvers import make_solver

NU = 1e-4
T_HOT = 350.0
T_IN = 300.0
TIGHT = {"pMaxIters": 500, "pRelTol": 1e-12, "uMaxIters": 300,
         "uRelTol": 1e-12, "turbMaxIters": 300, "turbRelTol": 1e-12}


def fluid_options(**over):
    """The channel y in [0, 0.1]; its ymin patch is the coupling patch."""
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "None",
        "divSchemes": {"div(phi,U)": "upwind"},
        "transportProperties": {"nu": NU, "Pr": 0.7, "Prt": 0.85,
                                "Cp": 1004.5},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "ymax": {"type": "fixedValue", "value": zero}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": 0.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "T": {"xmin": {"type": "fixedValue", "value": T_IN},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "mixed"},         # coupling patch
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"U": [1.0, 0.0, 0.0], "p": 0.0, "T": T_IN},
        "primalMinResTol": 1e-10,
        "primalMaxIters": 600,
        "primalLinearSolver": dict(TIGHT),
        "relaxationFactors": {"fields": {"p": 0.2},
                              "equations": {"U": 0.5, "T": 0.9}},
        "function": {"Tout": {"type": "patchMean", "patches": ["xmax"],
                              "varName": "T", "scale": 1.0}},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0, "T": T_IN},
    }
    opts.update(over)
    return opts


def solid_options(**over):
    """The slab y in [-0.05, 0]; its ymax patch is the coupling patch."""
    opts = {
        "solverName": "DAHeatTransferFoam",
        "transportProperties": {"kappa": 1.0},
        "boundaryConditions": {
            "T": {"ymin": {"type": "fixedValue", "value": T_HOT},
                  "ymax": {"type": "mixed"},         # coupling patch
                  "xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "zeroGradient"}},
        },
        "initialFields": {"T": T_HOT},
        "primalMinResTol": 1e-10,
        "primalMaxIters": 200,
        "primalLinearSolver": dict(TIGHT),
        "function": {},
        "normalizeStates": {"T": T_HOT},
    }
    opts.update(over)
    return opts


def build(device, dtype, nx=12, ny_fluid=6, ny_solid=4, fluid_over=None,
          solid_over=None):
    """(fluid, solid) solvers of the heated plate."""
    pts_f, topo_f = box_hex_mesh(nx, ny_fluid, 1, (1.0, 0.1, 0.01),
                                 kinds={"zmin": "empty", "zmax": "empty",
                                        "ymin": "wall", "ymax": "wall"})
    fluid = make_solver(fluid_options(**(fluid_over or {})), topo_f, pts_f,
                        device=device, dtype=dtype)
    pts_s, topo_s = box_hex_mesh(nx, ny_solid, 1, (1.0, 0.05, 0.01),
                                 kinds={"zmin": "empty", "zmax": "empty"})
    pts_s = pts_s.copy()
    pts_s[:, 1] -= 0.05
    solid = make_solver(solid_options(**(solid_over or {})), topo_s, pts_s,
                        device=device, dtype=dtype)
    return fluid, solid


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--n-outer", type=int, default=25)
    args = ap.parse_args(argv)

    fluid, solid = build(args.device, getattr(torch, args.dtype))
    cht = CHTCoupling(fluid, solid, "ymin", "ymax")
    inf, ins = fluid.make_inputs(), solid.make_inputs()
    sf, ss, infos = cht.solve_primal(fluid.init_state(), solid.init_state(),
                                     inf, ins, n_outer=args.n_outer)
    print("interface T mismatch:",
          float(cht.interface_mismatch(sf, ss, inf, ins)))
    J = float(cht.eval_function({"fluid": sf, "solid": ss}, inf, ins,
                                "fluid", "Tout"))
    print("outlet mean T:", J)
    tot_f, tot_s, info = cht.solve_adjoint(sf, ss, inf, ins, "fluid",
                                           "Tout")
    print("d(Tout)/d(T_hot):", float(tot_s["bc"]["T"]["ymin"]))
    return tot_s


if __name__ == "__main__":
    main()
