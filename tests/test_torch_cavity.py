"""Golden ``cavity_simple`` through dafoam_tpu_torch, and its mesh.

- ``mesh.box_hex_mesh`` (a numpy copy of dafoam_tpu's generator): points
  and every topology array equal dafoam_tpu's, element for element, on the
  golden 10x10 cavity box and a graded 3-D box.
- The laminar lid-driven cavity of tests/test_golden.py:
  _case_cavity_simple (DASimpleFoam, an all-Neumann pressure: adjustPhi
  and a reference cell) with its own options: primal to 1e-11, the
  residual-form adjoint (FGMRES restart 150 to rel 1e-10, segregated PC,
  the default) and the totals, against the locked values of
  tests/golden/values.json (lidForce rel 1e-8, dLidForce/dnu,
  dLidForce/dU_lid,x and ||dLidForce/dpoints|| rel 1e-6), in the
  canonical layout (the golden's) and in the dense-DIA layout (the
  card's). The JAX case is not re-run.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_cases import REPO
from test_torch_options import cavity_box, cavity_options

torch.set_num_threads(1)


@pytest.mark.parametrize("args,kw", [
    ((10, 10, 1, (0.1, 0.1, 0.01)),
     {"kinds": {"zmin": "empty", "zmax": "empty", "xmin": "wall",
                "xmax": "wall", "ymin": "wall", "ymax": "wall"}}),
    ((4, 3, 2, (1.0, 0.5, 0.2)),
     {"kinds": {"ymin": "wall"}, "grading": (None, 4.0, 0.5)}),
], ids=["cavity", "graded-3d"])
def test_box_hex_mesh_equals_jax(args, kw):
    from dafoam_tpu.mesh import box_hex_mesh as jbox
    from dafoam_tpu_torch.mesh import box_hex_mesh as tbox
    pj, tj = jbox(*args, **kw)
    pt, tt = tbox(*args, **kw)
    assert np.array_equal(pt, pj) and pt.dtype == pj.dtype
    for name in ("n_cells", "n_points", "n_internal"):
        assert getattr(tt, name) == getattr(tj, name), name
    for name in ("face_verts", "face_nverts", "owner", "neighbour"):
        a, b = getattr(tt, name), np.asarray(getattr(tj, name))
        assert np.array_equal(a, b) and a.dtype == b.dtype, name
    assert [(p.name, p.start, p.size, p.kind) for p in tt.patches] == \
        [(p.name, p.start, p.size, p.kind) for p in tj.patches]


@pytest.mark.parametrize("layout", ["canonical", "diaDense"])
def test_cavity_meets_golden(layout):
    from dafoam_tpu_torch.ops import dia_kernels as dk
    from dafoam_tpu_torch.solvers import make_solver
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["cavity_simple"]
    pts, topo = cavity_box("torch")
    s = make_solver(cavity_options(meshFaceLayout=layout), topo, pts,
                    device="cpu", dtype=torch.float64)
    assert (s.topo.dia_dense() is None) == (layout == "canonical")
    assert s.p_needs_ref
    x = s.make_inputs()
    w, info = s.run_primal(s.init_state(), x)
    assert info.converged and not info.failed, info
    J = float(s.run_function("lidForce", w, x))
    dk.reset_counts()
    psi, ai = s.run_adjoint("lidForce", w, x)
    counts = dict(dk.COUNTS)
    assert ai.converged and ai.resid <= 1e-10 * ai.resid0, ai
    tot = s.run_totals("lidForce", w, x, psi)
    got = {"lidForce": J,
           "dLidForce_dnu": float(tot["params"]["nu"]),
           "dLidForce_dUlid_x": float(tot["bc"]["U"]["ymax"][0]),
           "dLidForce_dpoints_norm": float(torch.linalg.norm(tot["points"]))}
    for key, val in want.items():
        bar = 1e-8 if key == "lidForce" else 1e-6
        assert abs(got[key] - val) <= bar * abs(val), (key, got[key], val)
    # the segregated PC's transposed products: K3a (plain here)
    assert counts["dia_matvec_t_plain"] > 0
    assert counts["dia_matvec_multi_t_plain"] > 0
