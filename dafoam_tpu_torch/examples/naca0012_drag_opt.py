"""NACA0012 drag minimization with FFD shape variables: the north-star
workflow (mesh -> SA-RANS primal -> drag adjoint -> FFD chain -> SLSQP).

Port of examples/naca0012_drag_opt.py. Run:

    python -m dafoam_tpu_torch.examples.naca0012_drag_opt [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; float32 on the
card and float64 on the CPU unless ``--dtype`` says otherwise.
"""

import argparse

import numpy as np
import torch

from dafoam_tpu_torch.mdo import FFDBox
from dafoam_tpu_torch.mdo.optimize import ShapeOptProblem
from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
from dafoam_tpu_torch.solvers import make_solver

NU = 1e-3
U_INF = [1.0, 0.0, 0.0]


def options():
    return {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "divSchemes": {"div(phi,U)": "linearUpwind"},
        "transportProperties": {"nu": NU},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": U_INF},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": 0.0},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NU},
                        "wing": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": U_INF, "p": 0.0, "nuTilda": 3 * NU},
        "primalMinResTol": 1e-9,
        "primalMaxIters": 2000,
        "relaxationFactors": {"fields": {"p": 0.2},
                              "equations": {"U": 0.5, "nuTilda": 0.5}},
        "function": {
            "CD": {"type": "force", "patches": ["wing"],
                   "directionMode": "fixedDirection",
                   "direction": [1.0, 0.0, 0.0], "scale": 1.0},
            "CL": {"type": "force", "patches": ["wing"],
                   "directionMode": "fixedDirection",
                   "direction": [0.0, 1.0, 0.0], "scale": 1.0},
        },
        "adjEqnOption": {"gmresRelTol": 1e-8, "gmresRestart": 400,
                         "gmresMaxIters": 3000, "pcType": "segregated"},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0,
                            "nuTilda": 3 * NU},
    }


def make_geo_fn(ffd, pts0):
    """DVs: y-displacement of the xy-interior control points, the same at
    every z; returns dv -> volume points."""
    nx, ny, nz = ffd.shape
    ix, iy = np.arange(1, nx - 1), np.arange(1, ny - 1)
    I, J, K = np.meshgrid(ix, iy, np.arange(nz), indexing="ij")
    idx = tuple(torch.as_tensor(a.ravel(), device=pts0.device)
                for a in (I, J, K))
    comp = torch.full_like(idx[0], 1)

    def geo_fn(dv):
        vals = dv.reshape(len(ix), len(iy), 1).expand(-1, -1, nz)
        dcp = pts0.new_zeros((nx, ny, nz, 3)).index_put(
            (*idx, comp), vals.reshape(-1))
        return ffd(pts0, dcp)

    return geo_fn, len(ix) * len(iy)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"), default=None)
    ap.add_argument("--n-wrap", type=int, default=64)
    ap.add_argument("--n-radial", type=int, default=24)
    ap.add_argument("--maxiter", type=int, default=10)
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype or (
        "float64" if args.device == "cpu" else "float32"))

    pts, topo = omesh_naca0012(n_wrap=args.n_wrap, n_radial=args.n_radial,
                               radius=15.0, first_cell=3e-3)
    solver = make_solver(options(), topo, pts, device=args.device,
                         dtype=dtype)
    ffd = FFDBox(pts, nx=8, ny=4, nz=2,
                 bounds=([-0.1, -0.2, -1.0], [1.1, 0.2, 1.1]),
                 device=args.device, dtype=dtype)
    geo_fn, n_dv = make_geo_fn(ffd, solver.points)

    prob = ShapeOptProblem(solver, geo_fn, "CD")
    funcs, st, inp = prob.eval_all(np.zeros(n_dv))
    print("baseline CD =", funcs["CD"])
    res = prob.run(np.zeros(n_dv), bounds=[(-0.03, 0.03)] * n_dv,
                   maxiter=args.maxiter)
    print("optimized CD =", res.fun, " (%d evals)" % len(prob.history))
    return prob, res


if __name__ == "__main__":
    main()
