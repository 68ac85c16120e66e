"""DARhoSimpleFoam of dafoam_tpu_torch against dafoam_tpu and the golden
values (CPU, f64).

- golden rho_channel (tests/test_rho_simple.py:channel, the compressible
  heated channel with the segregated PC) on both face layouts: Tout and
  mdot at rel 1e-8, dTout/dTwall and ||dTout/dpoints|| at rel 1e-6
  against tests/golden/values.json;
- DARhoSimpleFoam + Spalart-Allmaras on the 32x12 NACA0012 O-mesh at the
  free stream of chip_smoke.py's full-width compressible phase (Mach 0.5,
  Re_c 1000): the normalized residuals and one vjp at a perturbed state,
  both layouts, rel 1e-12 (on the dense layout's zero-area padded faces
  the port's phi cotangent is bounded where dafoam_tpu's is 1e36 times
  rounding noise; see rho_simple._divisor).

DARhoSimpleCFoam and DATurboFoam are in test_torch_rho_transonic.py.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from dafoam_tpu_torch import convert
from dafoam_tpu_torch.ops import dia_kernels as dk
from test_torch_cases import LAYOUTS, REPO, omesh_jax, omesh_torch, to_numpy
from test_torch_scalar_heat_solid import assert_pairs, residual_vjp_pair

torch.set_num_threads(1)
F64 = torch.float64

# the compressible free stream of chip_smoke.py's phase 9
TINF, PINF, RGAS, GAMMA = 300.0, 101325.0, 287.0, 1.4
UINF = 0.5 * math.sqrt(GAMMA * RGAS * TINF)
RHOINF = PINF / (RGAS * TINF)
MU = RHOINF * UINF * 1.0 / 1000.0
NUK = MU / RHOINF


def naca_rho_options(layout, **over):
    opts = {
        "solverName": "DARhoSimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"mu": MU, "nu": NUK, "Cp": 1004.5,
                                "R": RGAS, "Pr": 0.7, "Prt": 0.9},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": [UINF, 0.0, 0.0]},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": PINF},
                  "wing": {"type": "zeroGradient"}},
            "T": {"far": {"type": "inletOutlet", "value": TINF},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NUK},
                        "wing": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": [UINF, 0.0, 0.0], "p": PINF, "T": TINF,
                          "nuTilda": 3 * NUK},
        "relaxationFactors": {"fields": {"p": 0.2, "rho": 0.02},
                              "equations": {"U": 0.5, "T": 0.5,
                                            "nuTilda": 0.5}},
        "function": {"CD": {"type": "force", "patches": ["wing"],
                            "directionMode": "fixedDirection",
                            "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "normalizeStates": {"U": UINF, "p": PINF, "T": TINF, "phi": 1.0,
                            "nuTilda": 3 * NUK},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


@pytest.mark.parametrize("layout", LAYOUTS)
def test_golden_rho_channel(layout):
    import test_rho_simple
    from dafoam_tpu_torch.mesh import box_hex_mesh
    from dafoam_tpu_torch.solvers import make_solver
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["rho_channel"]
    # test_rho_simple.channel's options, without building its dafoam_tpu
    # solver (whose eager geometry compiles every primitive)
    class _Options:
        def __init__(self, option, topo, points):
            self.option = option

        def make_inputs(self):
            return None

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(test_rho_simple, "make_solver", _Options)
        js, _ = test_rho_simple.channel()
    pts, topo = box_hex_mesh(16, 8, 1, (1.0, 0.1, 0.01),
                             kinds={"zmin": "empty", "zmax": "empty",
                                    "ymin": "wall", "ymax": "wall"})
    opts = dict(js.option, meshFaceLayout=layout)
    s = make_solver(opts, topo, pts, device="cpu", dtype=F64)
    x = s.make_inputs()
    w, info = s.run_primal(s.init_state(), x)
    assert info.converged and not info.failed, info
    dk.reset_counts()
    psi, ai = s.run_adjoint("Tout", w, x)
    assert ai.converged, ai
    tot = s.run_totals("Tout", w, x, psi)
    # the segregated PC's transposed products (K3a, plain on the CPU)
    assert dk.COUNTS["dia_matvec_t_plain"] > 0
    assert dk.COUNTS["dia_matvec_multi_t_plain"] > 0
    got = {"Tout": float(s.run_function("Tout", w, x)),
           "mdot": float(s.run_function("mdot", w, x)),
           "dTout_dTwall": float(tot["bc"]["T"]["ymin"]),
           "dTout_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    for k, v in want.items():
        bar = 1e-6 if k.startswith("d") else 1e-8
        assert abs(got[k] - v) <= bar * abs(v), (k, got[k], v)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_naca_rho_sa_residuals_and_vjp(layout):
    from dafoam_tpu.solvers import make_solver as jmake
    from dafoam_tpu_torch.solvers import make_solver as tmake
    opts = naca_rho_options(layout)
    pj, tj = omesh_jax()
    pt, tt = omesh_torch()
    js = jmake(opts, tj, pj)
    ts = tmake(opts, tt, pt, device="cpu", dtype=F64)
    jin = js.make_inputs()
    tin = convert.inputs_from_numpy(to_numpy(jin), "cpu", F64)
    st0 = to_numpy(js.init_state())
    # the initial mass flux with every inletOutlet face an inflow
    tst0 = ts.init_state()
    for k in st0:
        np.testing.assert_allclose(tst0[k].numpy(), st0[k], rtol=1e-13,
                                   atol=1e-13 * np.abs(st0[k]).max())
    rng = np.random.default_rng(9)
    amp = {"U": 0.05, "p": 0.002, "T": 0.002, "nuTilda": 0.05, "phi": 0.05}
    st = {k: a * (1.0 + amp[k] * rng.standard_normal(a.shape))
          for k, a in st0.items()}
    want, got = residual_vjp_pair(js, ts, jin, tin, st)
    # the zero-area padded faces of the dense layout: dafoam_tpu divides
    # their flux by rho_f = 0 floored at 1e-36, which scales the rounding
    # noise of an exactly cancelling cotangent by 1e36; the port divides
    # by 1 there (rho_simple._divisor). Real faces are held at 1e-12.
    real = ts.geometry(tin).magsf.numpy() > 0.0
    want[1]["phi"] = want[1]["phi"][real]
    pad = got[1]["phi"].detach()[~torch.as_tensor(real)]
    got[1]["phi"] = got[1]["phi"][torch.as_tensor(real)]
    assert_pairs(got, want, 1e-12, f"rho SA {layout}")
    if pad.numel():
        assert float(pad.abs().max()) <= float(got[1]["phi"].abs().max())
