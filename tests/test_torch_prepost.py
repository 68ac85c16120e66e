"""dafoam_tpu_torch's utils.prepost against dafoam_tpu's (CPU, f64), on
tests/test_prepost.py's 8x4 laminar channel:

- find_cell, probe_time_series, set_probe_data, field_rmse_time_series
  and deform_dyn_mesh on seeded data (numpy and tensors in), at 1e-12;
- set_boundary_layer_patch and calc_force_per_s (with its surface VTK) on
  a seeded state carried into each package, on both face layouts of the
  port: the canonical (n_boundary, 3) tractions, at 1e-12, and their sum
  times |Sf| equal to the port's force objective.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import LAYOUTS, assert_close, jax_geometry_jitted, \
    to_layout

torch.set_num_threads(1)
F64 = torch.float64
REL = 1e-12
ZERO = [0.0, 0.0, 0.0]
KINDS = {"zmin": "empty", "zmax": "empty", "ymin": "wall", "ymax": "wall"}


def channel_options(layout="canonical"):
    """tests/test_prepost.py's small_channel, plus a drag objective."""
    return {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "None",
        "transportProperties": {"nu": 0.1},
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
        "initialFields": {"U": ZERO, "p": 0.0},
        "primalMinResTol": 1e-10, "primalMaxIters": 400,
        "relaxationFactors": {"fields": {"p": 0.3},
                              "equations": {"U": 0.7}},
        "function": {"wallFx": {"type": "force",
                                "patches": ["ymin", "ymax"],
                                "directionMode": "fixedDirection",
                                "direction": [1.0, 0.0, 0.0],
                                "scale": 1.0}},
        "normalizeStates": {"U": 1.0, "p": 0.5, "phi": 1.0},
        "meshFaceLayout": layout,
    }


def _box(mod):
    return mod.box_hex_mesh(8, 4, 1, (2.0, 1.0, 0.1), kinds=KINDS)


@pytest.fixture(scope="module")
def jax_case():
    """dafoam_tpu's channel with a seeded state, its boundary-layer profile
    and its tractions (computed once)."""
    import jax.numpy as jnp
    from dafoam_tpu import mesh as jmesh
    from dafoam_tpu.solvers import make_solver
    from dafoam_tpu.utils import prepost
    pts, topo = _box(jmesh)
    rng = np.random.default_rng(11)
    nc = topo.n_cells
    state = {"U": np.array([1.0, 0.0, 0.0]) + 0.2 * rng.standard_normal(
                 (nc, 3)),
             "p": 0.3 * rng.standard_normal(nc),
             "phi": 0.01 * rng.standard_normal(topo.n_faces)}
    with jax_geometry_jitted():
        s = make_solver(channel_options(), topo, pts)
        x = s.make_inputs()
        p = s.topo.patch("xmin")
        u0 = np.full((p.size, 3), 0.25)
        bl = prepost.set_boundary_layer_patch(s, u0, "xmin", bl_height=0.4,
                                              U0=2.0)
        fps = prepost.calc_force_per_s(
            s, {k: jnp.asarray(v) for k, v in state.items()}, x,
            ["ymin", "ymax"])
    return {"state": state, "n_faces": topo.n_faces, "u0": u0, "bl": bl,
            "fps": fps, "wall_dist": np.asarray(s.wall_dist)}


def _vtk_lines(path):
    with open(path) as fh:
        lines = fh.read().splitlines()
    return lines[:1] + lines[2:]     # line 2 names the package


def test_probe_rmse_and_mesh_series():
    from dafoam_tpu.utils import prepost as jpp
    from dafoam_tpu_torch.utils import prepost as tpp
    rng = np.random.default_rng(5)
    cc = rng.random((40, 3))
    hist = rng.standard_normal((6, 40, 3))
    hist_b = rng.standard_normal((6, 40, 3))
    coord = cc[17] + 1e-3
    for mode in ("findNearestCell", "findCell"):
        assert tpp.find_cell(torch.as_tensor(cc), coord, mode=mode) == \
            jpp.find_cell(cc, coord, mode=mode) == 17
    far = [50.0, 0.0, 0.0]
    assert tpp.find_cell(cc, far, mode="findCell") == \
        jpp.find_cell(cc, far, mode="findCell") == -1
    with pytest.raises(ValueError):
        tpp.probe_time_series(hist, cc, far, mode="findCell")
    for h in (hist, hist[..., 0]):
        got = tpp.probe_time_series(torch.as_tensor(h), torch.as_tensor(cc),
                                    coord)
        assert_close(got, jpp.probe_time_series(h, cc, coord), REL, "probe")
        assert_close(tpp.field_rmse_time_series(torch.as_tensor(h),
                                                h[::-1].copy()),
                     jpp.field_rmse_time_series(h, h[::-1]), REL, "rmse")
    assert_close(tpp.field_rmse_time_series(hist, hist_b),
                 jpp.field_rmse_time_series(hist, hist_b), REL, "rmse3")
    with pytest.raises(ValueError):
        tpp.field_rmse_time_series(hist, hist[:, :3])
    for field, value in ((rng.random((40, 3)), [5.0, 1.0, 0.0]),
                         (rng.random(40), [7.0])):
        got = tpp.set_probe_data(torch.as_tensor(field), cc, coord, value)
        want = jpp.set_probe_data(field, cc, coord, value)
        assert_close(got, want, REL, "set_probe_data")
        assert got[17].tolist() == want[17].tolist()
    pts = rng.standard_normal((30, 3))
    got = tpp.deform_dyn_mesh(torch.as_tensor(pts), [0.3, -0.2, 0.0], 0.5,
                              0.1, 8)
    assert got.shape == (8, 30, 3)
    assert_close(got, jpp.deform_dyn_mesh(pts, [0.3, -0.2, 0.0], 0.5, 0.1,
                                          8), REL, "deform")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_boundary_layer_and_force_per_s(tmp_path, jax_case, layout):
    from dafoam_tpu_torch import mesh as tmesh
    from dafoam_tpu_torch.convert import state_from_numpy
    from dafoam_tpu_torch.functions.registry import _wall_force
    from dafoam_tpu_torch.solvers import make_solver
    from dafoam_tpu_torch.utils import prepost
    pts, topo = _box(tmesh)
    s = make_solver(channel_options(layout), topo, pts, device="cpu",
                    dtype=F64)
    assert (s.topo.dia_dense() is not None) == (layout == "diaDense")
    x = s.make_inputs()
    assert_close(s.wall_dist, jax_case["wall_dist"], REL, "wall_dist")
    bl = prepost.set_boundary_layer_patch(
        s, torch.as_tensor(jax_case["u0"]), "xmin", bl_height=0.4, U0=2.0)
    assert_close(bl, jax_case["bl"], REL, "boundary layer")
    assert np.all(bl[:, 1:] == 0.25)

    st = state_from_numpy(to_layout(jax_case["state"], s.topo,
                                    jax_case["n_faces"]), "cpu", F64)
    vtk = tmp_path / "fps.vtk"
    fps = prepost.calc_force_per_s(s, st, x, ["ymin", "ymax"],
                                   vtk_path=str(vtk))
    assert fps.shape == (topo.n_boundary, 3)
    assert_close(fps, jax_case["fps"], REL, "forcePerS")
    # traction times |Sf| summed along x is the drag objective
    ni = s.topo.n_internal
    mags = s.geometry(x).magsf[ni:].numpy()
    with torch.no_grad():
        f = _wall_force({"patches": ["ymin", "ymax"]}, s.function_ctx(st, x))
        fx = float(s.eval_function("wallFx", st, x))
    assert_close(fps * mags[:, None], f, REL, "traction x area")
    assert abs((fps[:, 0] * mags).sum() - fx) <= REL * abs(fx)

    # the VTK equals dafoam_tpu's, but for the title line
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.utils.vtkio import write_surface_vtk
    jpts, jtopo = box_hex_mesh(8, 4, 1, (2.0, 1.0, 0.1), kinds=KINDS)
    rows = np.concatenate([jax_case["fps"][jtopo.patch_slice(p).start
                                           - jtopo.n_internal:
                                           jtopo.patch_slice(p).stop
                                           - jtopo.n_internal]
                           for p in ("ymin", "ymax")])
    write_surface_vtk(str(tmp_path / "j.vtk"), jpts, jtopo, ["ymin", "ymax"],
                      cell_data={"forcePerS": rows})
    assert _vtk_lines(vtk) == _vtk_lines(tmp_path / "j.vtk")
