"""Shared cases for the dafoam_tpu_torch parity tests, plus the checks that
the port stands apart from JAX and reproduces the golden drag.

The NACA0012 SA case is tests/test_golden.py:_case_naca_sa (32x12 O-mesh,
f64). Helpers build it in both packages from the same options; the other
test_torch_* files import them.
"""

import ast
import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "dafoam_tpu_torch")
NU = 1e-3
UINF = [1.0, 0.0, 0.0]
LAYOUTS = ("canonical", "diaDense")


def naca_options(layout, **over):
    """_case_naca_sa's primal options, in the given face layout."""
    opts = {
        "solverName": "DASimpleFoam",
        "turbulenceModel": "SpalartAllmaras",
        "transportProperties": {"nu": NU},
        "boundaryConditions": {
            "U": {"far": {"type": "inletOutlet", "value": UINF},
                  "wing": {"type": "fixedValue", "value": [0.0, 0.0, 0.0]}},
            "p": {"far": {"type": "fixedValue", "value": 0.0},
                  "wing": {"type": "zeroGradient"}},
            "nuTilda": {"far": {"type": "inletOutlet", "value": 3 * NU},
                        "wing": {"type": "fixedValue", "value": 0.0}},
        },
        "initialFields": {"U": UINF, "p": 0.0, "nuTilda": 3 * NU},
        "primalMinResTol": 1e-10, "primalMaxIters": 1500,
        "relaxationFactors": {"fields": {"p": 0.2},
                              "equations": {"U": 0.5, "nuTilda": 0.5}},
        "primalLinearSolver": {"pMaxIters": 200, "pRelTol": 0.02,
                               "uMaxIters": 50, "uRelTol": 0.05,
                               "turbMaxIters": 50, "turbRelTol": 0.05},
        "function": {"CD": {"type": "force", "patches": ["wing"],
                            "directionMode": "fixedDirection",
                            "direction": [1.0, 0.0, 0.0], "scale": 1.0}},
        "meshFaceLayout": layout,
    }
    opts.update(over)
    return opts


def omesh_jax():
    from dafoam_tpu.mesh.airfoil import omesh_naca0012
    return omesh_naca0012(n_wrap=32, n_radial=12, radius=15.0,
                          first_cell=4e-3)


def omesh_torch():
    from dafoam_tpu_torch.mesh.airfoil import omesh_naca0012
    return omesh_naca0012(n_wrap=32, n_radial=12, radius=15.0,
                          first_cell=4e-3)


def jax_solver(opts):
    from dafoam_tpu.solvers import make_solver
    pts, topo = omesh_jax()
    return make_solver(opts, topo, pts)


def torch_solver(opts):
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = omesh_torch()
    return make_solver(opts, topo, pts, device="cpu", dtype=torch.float64)


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def jax_geometry_jitted():
    """dafoam_tpu's compute_geometry under jax.jit, one trace per mesh,
    while the block runs: run eagerly, each of its primitives compiles on
    its own (0.5-1.5 s a call on the test meshes). The same function;
    only the rounding of fused operations differs."""
    from dafoam_tpu.mesh import geometry
    from dafoam_tpu.solvers import base, simple

    eager = geometry.compute_geometry
    fns = {}

    def compute_geometry(points, topo):
        # the topology is kept beside its function, so its id is not reused
        if id(topo) not in fns:
            fns[id(topo)] = (topo, jax.jit(
                lambda p, topo=topo: eager(p, topo)))
        return fns[id(topo)][1](points)

    mp = pytest.MonkeyPatch()
    for mod in (geometry, base, simple):
        mp.setattr(mod, "compute_geometry", compute_geometry)
    try:
        yield
    finally:
        mp.undo()


def assert_close(got, want, rel, what=""):
    """max|got - want| <= rel * max|want| (norm-relative, so rows that
    cancel to ~0 are judged against the field's scale)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1e-300)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= rel * scale, \
        f"{what}: max err {err:.3e} > {rel:g} x {scale:.3e}"


def to_layout(fields, topo, n_faces_canonical):
    """Canonical-layout numpy fields -> the face layout of ``topo``: face
    arrays (last axis n_faces_canonical) scatter by face_map_old2new, the
    padded faces of the dense layout get 0; cell fields pass through."""
    fmap = getattr(topo, "face_map_old2new", None)
    out = {}
    for k, a in fields.items():
        a = np.asarray(a)
        if fmap is not None and a.shape[-1:] == (n_faces_canonical,):
            b = np.zeros(a.shape[:-1] + (topo.n_faces,), a.dtype)
            b[..., fmap] = a
            a = b
        out[k] = a
    return out


def from_layout(fields, topo):
    """The inverse of ``to_layout`` for tensors: face fields of the dense
    layout gathered back to the canonical faces."""
    fmap = getattr(topo, "face_map_old2new", None)
    out = {}
    for k, a in fields.items():
        a = a.detach().cpu().numpy()
        if fmap is not None and a.shape[-1:] == (topo.n_faces,):
            a = a[..., fmap]
        out[k] = a
    return out


# ---------------------------------------------------------------------------
# the port stands apart from jax
# ---------------------------------------------------------------------------

def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_port_has_no_jax_import():
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "dafoam_tpu"):
                    offenders.append((os.path.relpath(path, REPO), name))
    assert not offenders, offenders


def test_import_loads_neither_jax_nor_kernels():
    code = (
        "import os, sys; before = set(sys.modules)\n"
        "build = os.path.join('dafoam_tpu_torch', '_build')\n"
        "listing = lambda: sorted(os.listdir(build)) "
        "if os.path.isdir(build) else None\n"
        "built_before = listing()\n"
        "import dafoam_tpu_torch\n"
        "import dafoam_tpu_torch.solvers, dafoam_tpu_torch.convert\n"
        "from dafoam_tpu_torch.ops import dia_kernels\n"
        "new = set(sys.modules) - before\n"
        "assert not [m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dafoam_tpu')], 'jax imported'\n"
        "assert not dia_kernels.is_loaded(), 'kernel library loaded'\n"
        "assert listing() == built_before, 'import built kernels'\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, \
        out.stdout + out.stderr


# ---------------------------------------------------------------------------
# golden drag through the port (CPU, f64, canonical layout as the golden)
# ---------------------------------------------------------------------------

def test_port_reproduces_golden_cd():
    torch.set_num_threads(1)
    with open(os.path.join(REPO, "tests", "golden", "values.json")) as fh:
        want = json.load(fh)["naca_sa"]["CD"]
    s = torch_solver(naca_options("canonical"))
    inputs = s.make_inputs()
    state, info = s.run_primal(s.init_state(), inputs)
    assert info.converged and not info.failed, info
    cd = float(s.run_function("CD", state, inputs))
    assert abs(cd - want) <= 1e-8 * abs(want), (cd, want)


if __name__ == "__main__":  # pragma: no cover
    sys.exit(pytest.main([__file__, "-q"]))
