"""Every objective type of dafoam_tpu_torch's function registry against
dafoam_tpu's (CPU, f64): the value and its gradient with respect to every
float leaf of one evaluation context: the value at rel 1e-12, the
gradient as one vector at rel 1e-12 and each leaf at 1e-10 of its own
scale.

The context is random (numpy, one seed) on a sheared 10x10 box with
jittered interior points, so that every internal face is some 10-25
degrees off orthogonal (meshQualityKS's arccos has no derivative at a
right angle and is ill-conditioned near one), with dafoam_tpu's geometry
in both packages. dafoam_tpu runs op by op.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu_torch.functions.registry import \
    evaluate_function as t_evaluate
from dafoam_tpu_torch.utils import tree
from test_torch_cases import assert_close

torch.set_num_threads(1)
F64 = torch.float64

CASES = {
    "patchMean": {"patches": ["xmax"], "varName": "T"},
    "patchMean_vector": {"type": "patchMean", "patches": ["xmin", "ymax"],
                         "varName": "U", "component": 1},
    "variableVolSum": {"varName": "nuTilda", "index": 2, "isSquare": 1,
                       "divByTotalVol": 1},
    "variableVolSum_aux": {"type": "variableVolSum", "varName": "kappa"},
    "massFlowRate": {"patches": ["xmax"]},
    "totalPressure": {"patches": ["xmin", "xmax"]},
    "force": {"patches": ["ymin", "ymax"], "direction": [1.0, 0.2, 0.0]},
    "force_parallelToFlow": {"type": "force", "patches": ["ymin", "ymax"],
                             "directionMode": "parallelToFlow"},
    "force_normalToFlow": {"type": "force", "patches": ["ymin", "ymax"],
                           "directionMode": "normalToFlow"},
    "moment": {"patches": ["ymin"], "axis": [0.0, 0.0, 1.0],
               "center": [0.25, 0.1, 0.0]},
    "fieldMax": {"varName": "p", "coeffKS": 5.0},
    "residualNorm": {"resWeight": {"URes": 1.0, "pRes": 0.5}},
    "variance": {"varName": "T"},
    "wallHeatFlux": {"patches": ["ymin"]},
    "wallHeatFlux_total": {"type": "wallHeatFlux", "patches": ["ymin"],
                           "byUnitArea": 0},
    "vonMisesStressKS": {"coeffKS": 0.5},
    "meshQualityKS": {"coeffKS": 0.1},
    "totalPressureRatio": {"inletPatches": ["xmin"],
                           "outletPatches": ["xmax"]},
    "totalTemperatureRatio": {"inletPatches": ["xmin"],
                              "outletPatches": ["xmax"]},
    "location": {"varName": "nuTilda", "coeffKS": 5.0,
                 "center": [0.5, 0.5, 0.0]},
}


def _box(lib):
    if lib == "jax":
        from dafoam_tpu.mesh import box_hex_mesh
    else:
        from dafoam_tpu_torch.mesh import box_hex_mesh
    pts, topo = box_hex_mesh(10, 10, 1, (1.0, 1.0, 0.1),
                             kinds={"zmin": "empty", "zmax": "empty",
                                    "ymin": "wall", "ymax": "wall"})
    pts = np.asarray(pts).copy()
    inner = (pts[:, 0] > 1e-9) & (pts[:, 0] < 1 - 1e-9) \
        & (pts[:, 1] > 1e-9) & (pts[:, 1] < 1 - 1e-9)
    jit = np.random.default_rng(0).uniform(-0.01, 0.01, (len(pts), 2))
    # the same jitter on both z layers keeps the mesh extruded
    key = np.round(pts[:, :2], 9)
    _, first = np.unique(key, axis=0, return_inverse=True)
    pts[inner, :2] += jit[first.reshape(-1)][inner]
    pts[:, 0] += 0.3 * pts[:, 1]          # shear: every face ~17 deg off
    return pts, topo


@pytest.fixture(scope="module")
def context():
    from dafoam_tpu.mesh.geometry import compute_geometry
    pts, topo_j = _box("jax")
    _, topo_t = _box("torch")
    g = compute_geometry(jnp.asarray(pts), topo_j)
    rng = np.random.default_rng(2)
    nc, nf, nb = topo_j.n_cells, topo_j.n_faces, topo_j.n_boundary
    ctx = {
        "geom": {k: np.asarray(v) for k, v in g._asdict().items()},
        "state": {"U": rng.standard_normal((nc, 3)) + [2.0, 0.0, 0.0],
                  "p": rng.standard_normal(nc),
                  "T": rng.uniform(290.0, 310.0, nc),
                  "nuTilda": rng.uniform(0.1, 1.0, nc)},
        "boundary": {"U": rng.standard_normal((nb, 3)) + [2.0, 0.0, 0.0],
                     "p": rng.uniform(0.9e5, 1.1e5, nb),
                     "T": rng.uniform(290.0, 310.0, nb)},
        "phi": rng.standard_normal(nf),
        "aux": {"vonMises": rng.uniform(1.0, 3.0, nc),
                "kappa": rng.uniform(1.0, 2.0, nc)},
        "data": {"TData": rng.uniform(290.0, 310.0, nc)},
        "residuals": {"U": rng.standard_normal((nc, 3)),
                      "p": rng.standard_normal(nc)},
        "gradU_b": rng.standard_normal((nb, 3, 3)),
        "nu_eff_b": rng.uniform(1e-3, 2e-3, nb),
        "rho_ref": np.asarray(1.2),
        "rho_b": rng.uniform(1.0, 1.3, nb),
        "aoa_rad": np.asarray(0.05),
        "wall_heat_flux_b": rng.standard_normal(nb),
    }
    return ctx, topo_j, topo_t


def _build(ctx, topo, geom_cls):
    out = dict(ctx, topo=topo)
    out["geom"] = geom_cls(**ctx["geom"])
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_function(case, context):
    from dafoam_tpu.functions.registry import evaluate_function
    from dafoam_tpu.mesh.geometry import MeshGeometry as JGeom
    from dafoam_tpu_torch.mesh.geometry import MeshGeometry as TGeom
    ctx, topo_j, topo_t = context
    cfg = dict(CASES[case], scale=1.7)
    cfg.setdefault("type", case)

    def jf(c):
        return evaluate_function(cfg, _build(c, topo_j, JGeom))

    jval, jgrad = jax.value_and_grad(jf)(
        jax.tree_util.tree_map(jnp.asarray, ctx))
    tctx = tree.tmap(lambda a: torch.tensor(np.asarray(a), dtype=F64)
                     .requires_grad_(), ctx)
    tval = t_evaluate(cfg, _build(tctx, topo_t, TGeom))
    assert_close(tval.detach(), np.asarray(jval), 1e-12, f"{case} value")
    leaves = tree.leaves(tctx)
    gs = torch.autograd.grad(tval, leaves, allow_unused=True)
    jleaves = [np.asarray(w).reshape(-1)
               for w in jax.tree_util.tree_leaves(jgrad)]
    assert len(jleaves) == len(leaves)
    got = [(torch.zeros_like(x) if g is None else g).reshape(-1)
           for x, g in zip(leaves, gs)]
    # as one vector at 1e-12, each leaf at 1e-10 of its own scale
    assert_close(torch.cat(got), np.concatenate(jleaves), 1e-12,
                 f"{case} gradient")
    for i, (g, w) in enumerate(zip(got, jleaves)):
        assert_close(g, w, 1e-10, f"{case} gradient leaf {i}")
