"""dafoam_tpu_torch's utils.jacdump against dafoam_tpu's (CPU, f64), on
tests/test_jacdump.py's 5x4 scalar-transport case at a seeded state:

- dense_drdwt, raw and normalized (the operator FGMRES sees), equal to
  dafoam_tpu's at 1e-12, on both face layouts of the port;
- each matrix times a seeded v equal to the port's matrix-free vjp of the
  same residual at 1e-12;
- write_jacobians writes the same npz keys and metadata as dafoam_tpu's,
  and refuses a packed state above dense_limit.
"""

import numpy as np
import pytest
import torch

from test_torch_cases import LAYOUTS, assert_close

torch.set_num_threads(1)
F64 = torch.float64
REL = 1e-12


def options(layout="canonical"):
    return {
        "solverName": "DAScalarTransportFoam",
        "ddtScheme": "steadyState",
        "transportProperties": {"DT": 0.05},
        "boundaryConditions": {
            "T": {"xmin": {"type": "fixedValue", "value": 1.0},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": 0.0},
                  "ymax": {"type": "zeroGradient"}},
            "U": {"xmin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "xmax": {"type": "zeroGradient"},
                  "ymin": {"type": "fixedValue", "value": [1.0, 0.2, 0.0]},
                  "ymax": {"type": "zeroGradient"}},
        },
        "initialFields": {"T": 0.0},
        "function": {"TMean": {"type": "patchMean", "patches": ["xmax"],
                               "varName": "T", "scale": 1.0}},
        "normalizeStates": {"T": 1.0},
        "meshFaceLayout": layout,
    }


def _mesh(mod):
    return mod.box_hex_mesh(5, 4, 1, (1.0, 1.0, 0.1),
                            kinds={"zmin": "empty", "zmax": "empty"})


def _state(nc):
    return {"T": np.random.default_rng(2).random(nc)}


@pytest.fixture(scope="module")
def jax_dump(tmp_path_factory):
    """dafoam_tpu's raw and normalized dRdWT and its npz, once."""
    import jax.numpy as jnp
    from dafoam_tpu import mesh as jmesh
    from dafoam_tpu.solvers import make_solver
    from dafoam_tpu.utils.jacdump import dense_drdwt, write_jacobians
    pts, topo = _mesh(jmesh)
    s = make_solver(options(), topo, pts)
    x = s.make_inputs()
    x["params"]["U"] = jnp.tile(jnp.asarray([1.0, 0.2, 0.0], s.dtype),
                                (topo.n_cells, 1))
    st = {k: jnp.asarray(v) for k, v in _state(topo.n_cells).items()}
    path = tmp_path_factory.mktemp("jac") / "jax.npz"
    norm = write_jacobians(str(path), s, st, x)
    with np.load(path) as z:
        npz = {k: z[k] for k in z.files}
    return {"raw": dense_drdwt(s, st, x, normalized=False), "norm": norm,
            "npz": npz}


def _port_case(layout):
    from dafoam_tpu_torch import mesh as tmesh
    from dafoam_tpu_torch.convert import state_from_numpy
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = _mesh(tmesh)
    s = make_solver(options(layout), topo, pts, device="cpu", dtype=F64)
    x = s.make_inputs()
    x["params"]["U"] = torch.tensor([1.0, 0.2, 0.0], dtype=F64).repeat(
        topo.n_cells, 1)
    return s, x, state_from_numpy(_state(topo.n_cells), "cpu", F64)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_dense_drdwt_matches_dafoam_tpu_and_vjp(tmp_path, jax_dump, layout):
    from dafoam_tpu_torch.adjoint.solver import vjp
    from dafoam_tpu_torch.utils.jacdump import dense_drdwt, write_jacobians
    s, x, st = _port_case(layout)
    raw = dense_drdwt(s, st, x, normalized=False)
    norm = dense_drdwt(s, st, x)
    assert raw.shape == norm.shape == jax_dump["raw"].shape == (20, 20)
    assert_close(raw, jax_dump["raw"], REL, "raw dRdWT")
    assert_close(norm, jax_dump["norm"], REL, "normalized dRdWT")

    # against the matrix-free operator: J^T v by one vjp
    layout_ = s.layout
    v = torch.as_tensor(np.random.default_rng(0).standard_normal(20))
    scales = s.state_scales(s.geometry(x))
    sv = layout_.pack({k: torch.broadcast_to(scales[k], st[k].shape)
                       for k in layout_.info.names()})
    for fn, mat, sc in ((s.residuals, raw, None),
                        (s._norm_residuals, norm, sv)):
        _, f_vjp = vjp(lambda w: layout_.pack(fn(layout_.unpack(w), x)),
                       layout_.pack(st))
        got = f_vjp(v if sc is None else v / sc)
        if sc is not None:
            got = got * sc
        assert_close(mat @ v.numpy(), got, REL, "J^T v")

    path = tmp_path / "jac.npz"
    J = write_jacobians(str(path), s, st, x)
    assert_close(J, norm, 0.0, "written")
    with np.load(path) as z:
        assert sorted(z.files) == sorted(jax_dump["npz"])
        for k in z.files:
            if k != "dRdWT":
                assert z[k] == jax_dump["npz"][k], k
        assert_close(z["dRdWT"], jax_dump["npz"]["dRdWT"], REL, "npz")
    assert int(np.load(path)["size_T"]) == 20


def test_dense_limit():
    from dafoam_tpu_torch.utils.jacdump import write_jacobians
    s, x, st = _port_case("canonical")
    with pytest.raises(ValueError, match="dense_limit=19"):
        write_jacobians("unused.npz", s, st, x, dense_limit=19)
