"""Field inversion / data-driven turbulence modeling end-to-end.

Port of examples/field_inversion_sa.py. The reference's headline ML
workflow (DARegression + betaFI field input + DAFunctionVariance;
runRegTests_DAPimpleFoamField.py): a neural network beta(features)
multiplies the SA production term, and its parameters are trained to
minimize the misfit between the solved velocity field and reference data,
with gradients from the adjoint.

The "truth" data is synthesized by solving the same channel with a
prescribed non-uniform betaFI field; the NN then recovers a beta that
reproduces the data. Float64, as the reference runs it:

    python -m dafoam_tpu_torch.examples.field_inversion_sa [--device cpu]
"""

import argparse

import numpy as np
import torch

from dafoam_tpu_torch.mesh import box_hex_mesh
from dafoam_tpu_torch.solvers import make_solver

NU = 1e-4


def build(with_nn, device, dtype):
    pts, topo = box_hex_mesh(12, 6, 1, (1.0, 0.1, 0.01),
                             kinds={"zmin": "empty", "zmax": "empty",
                                    "ymin": "wall", "ymax": "wall"})
    zero = [0.0, 0.0, 0.0]
    opts = {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"nu": NU},
        "boundaryConditions": {
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.0, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": zero},
                  "ymax": {"type": "fixedValue", "value": zero}},
            "p": {"xmin": {"type": "zeroGradient"},
                  "xmax": {"type": "fixedValue", "value": 0.0},
                  "ymin": {"type": "zeroGradient"},
                  "ymax": {"type": "zeroGradient"}},
            "nuTilda": {"xmin": {"type": "fixedValue", "value": 3 * NU},
                        "xmax": {"type": "zeroGradient"},
                        "ymin": {"type": "fixedValue", "value": 0.0},
                        "ymax": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": [1.0, 0.0, 0.0], "p": 0.0,
                          "nuTilda": 3 * NU},
        "primalMinResTol": 1e-10,
        "primalMaxIters": 1000,
        "relaxationFactors": {"fields": {"p": 0.2},
                              "equations": {"U": 0.5, "nuTilda": 0.5}},
        "function": {
            "UVar": {"type": "variance", "varName": "U", "mode": "field",
                     "components": [0, 1], "scale": 1.0},
        },
        "adjEqnOption": {"gmresRelTol": 1e-10, "gmresRestart": 300,
                         "gmresMaxIters": 2000, "pcType": "segregated"},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0,
                            "nuTilda": 3 * NU},
    }
    if with_nn:
        opts["regressionModel"] = {
            "active": True,
            "model1": {"modelType": "neuralNetwork",
                       "inputNames": ["VoS", "chiSA", "pGradStream"],
                       "hiddenLayerNeurons": [4],
                       "activationFunction": "tanh",
                       "outputShift": 1.0},
        }
    solver = make_solver(opts, topo, pts, device=device, dtype=dtype)
    return solver, solver.make_inputs(), topo


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    dtype = getattr(torch, args.dtype)

    # ---- synthesize truth: prescribed betaFI bump in the channel core ---
    solver_t, inputs_t, topo = build(False, args.device, dtype)
    with torch.no_grad():
        cc = solver_t.geometry(inputs_t).cc.cpu().numpy()
    beta_true = 1.0 + 0.4 * np.exp(-((cc[:, 1] - 0.05) / 0.03) ** 2)
    inputs_t["params"]["betaFI"] = solver_t._tensor(beta_true)
    st_t, info_t = solver_t.run_primal(solver_t.init_state(), inputs_t)
    assert bool(info_t.converged), "truth primal did not converge"
    u_data = st_t["U"]
    print(f"truth case converged ({int(info_t.iters)} iters); "
          f"beta in [{beta_true.min():.3f}, {beta_true.max():.3f}]")

    # ---- inverse problem: NN beta trained on the velocity data ----------
    solver, inputs, _ = build(True, args.device, dtype)
    inputs["data"] = {"UData": u_data}
    n_theta = solver.regression_n_params("model1")
    rng = np.random.default_rng(0)
    theta = solver._tensor(rng.normal(0.0, 0.02, n_theta))

    lr = 2.0e-2
    m = torch.zeros_like(theta)  # momentum
    state = solver.init_state()
    hist = []
    for it in range(args.iters):
        inputs["params"]["regressionPar"] = {"model1": theta}
        state, info = solver.run_primal(state, inputs)
        if not bool(info.converged):
            # resetStateVals analog: restart from scratch once
            state, info = solver.run_primal(solver.init_state(), inputs)
        J = float(solver.run_function("UVar", state, inputs))
        psi, ai = solver.run_adjoint("UVar", state, inputs)
        tot = solver.run_totals("UVar", state, inputs, psi)
        g = tot["params"]["regressionPar"]["model1"]
        m = 0.7 * m + g
        theta = theta - lr * m / (torch.linalg.norm(g) + 1e-30)
        hist.append(J)
        print(f"iter {it:2d}: UVar misfit = {J:.6e}  "
              f"|g_theta| = {float(torch.linalg.norm(g)):.3e}")

    assert hist[-1] < 0.5 * hist[0], (
        f"field inversion failed to reduce misfit: {hist[0]:.3e} -> "
        f"{hist[-1]:.3e}")
    print(f"misfit reduced {hist[0]:.3e} -> {hist[-1]:.3e} "
          f"({hist[-1] / hist[0]:.1%})")
    return hist


if __name__ == "__main__":
    main()
