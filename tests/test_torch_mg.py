"""Batched PCR and the geometric-multigrid V-cycle of dafoam_tpu_torch
against dafoam_tpu.

PCR (plain and periodic) on random diagonally dominant batches, then
``mg.grid_structure``, ``build_hierarchy`` and ``vcycle`` (and its vjp in
the right-hand side, the path the fixed-point adjoint's step map
differentiates) on two grid-form meshes in the dense-DIA layout: the 32x12
NACA0012 O-mesh (periodic wrap ring, pressure matrix of the golden case)
and a 10x10 box (plain grid, random diagonally dominant matrix). Last,
``fvsolve.solve_fixed``'s fall-through to its "linear" smoothers on the
canonical layout.

Bar: 1e-12 (norm-relative) in f64; 1e-10 for the fixed-iteration solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dafoam_tpu.linalg import mg as jmg
from dafoam_tpu.linalg import tridiag as jtd
from dafoam_tpu.ops.fvmatrix import FvMatrix as JMatrix
from dafoam_tpu_torch.linalg import mg as tmg
from dafoam_tpu_torch.linalg import tridiag as ttd
from dafoam_tpu_torch.ops.fvmatrix import FvMatrix as TMatrix
from test_torch_cases import assert_close
from test_torch_dia import _assembled

torch.set_num_threads(1)

BAR = 1e-12


def _tridiag(n, batch, seed):
    rng = np.random.default_rng(seed)
    a, c, d = rng.standard_normal((3, n) + batch)
    b = rng.standard_normal((n,) + batch) + 6.0
    return a, b, c, d


@pytest.mark.parametrize("n", [1, 2, 7, 32, 45])
@pytest.mark.parametrize("periodic", [False, True])
def test_pcr_matches_jax(n, periodic):
    a, b, c, d = _tridiag(n, (5,), seed=n)
    if not periodic:
        a[0] = 0.0
        c[-1] = 0.0
    jf, tf = (jtd.pcr_solve_periodic, ttd.pcr_solve_periodic) if periodic \
        else (jtd.pcr_solve, ttd.pcr_solve)
    want = jf(*map(jnp.asarray, (a, b, c, d)))
    got = tf(*map(torch.from_numpy, (a, b, c, d)))
    assert_close(got, want, BAR, f"n={n}")


def _box():
    """10x10 box in the dense-DIA layout (both packages) and a random
    diagonally dominant 5-point matrix on it."""
    from dafoam_tpu.mesh import box_hex_mesh
    from dafoam_tpu.mesh.topology import to_dia_dense as j_dense
    from dafoam_tpu_torch.mesh import topology as tt
    _, topo = box_hex_mesh(10, 10, 1, (1.0, 1.0, 0.1),
                           kinds={"zmin": "empty", "zmax": "empty"})
    topo_t = tt.MeshTopology(
        n_cells=topo.n_cells, n_points=topo.n_points,
        face_verts=np.asarray(topo.face_verts),
        face_nverts=np.asarray(topo.face_nverts),
        owner=np.asarray(topo.owner), neighbour=np.asarray(topo.neighbour),
        n_internal=topo.n_internal,
        patches=tuple(tt.Patch(p.name, p.start, p.size, p.kind)
                      for p in topo.patches))
    topo_j, topo_t = j_dense(topo), tt.to_dia_dense(topo_t)
    valid = np.asarray(topo_j.dia_dense()[1]).reshape(-1)
    rng = np.random.default_rng(11)
    ni = topo_j.n_internal
    up = -rng.random(ni) * valid
    lo = -rng.random(ni) * valid
    diag = np.zeros(topo_j.n_cells)
    np.add.at(diag, topo_j.owner[:ni], -up)
    np.add.at(diag, topo_j.neighbour, -lo)
    diag += 0.5 + rng.random(topo_j.n_cells)
    m = (diag, lo, up, np.zeros(topo_j.n_cells))
    return topo_j, topo_t, m


def _omesh():
    topo_j, topo_t, mats, _ = _assembled("diaDense")
    return topo_j, topo_t, tuple(mats["p"])


@pytest.fixture(scope="module", params=["omesh 32x12", "box 10x10"])
def grid_case(request):
    return _omesh() if request.param.startswith("omesh") else _box()


def test_grid_structure_and_hierarchy(grid_case):
    topo_j, topo_t, m = grid_case
    assert tmg.grid_structure(topo_t) == jmg.grid_structure(topo_j)
    hj = jmg.build_hierarchy(JMatrix(*map(jnp.asarray, m)), topo_j)
    ht = tmg.build_hierarchy(TMatrix(*map(torch.from_numpy, m)), topo_t)
    assert ht.shape == tuple(hj.shape) and len(ht.levels) == len(hj.levels)
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.periodic == lj.periodic
        for name in ("D", "Wup", "Wdn", "Rup", "Rdn"):
            assert_close(getattr(lt, name), getattr(lj, name), BAR, name)


def test_vcycle_and_its_vjp(grid_case):
    topo_j, topo_t, m = grid_case
    hj = jmg.build_hierarchy(JMatrix(*map(jnp.asarray, m)), topo_j)
    ht = tmg.build_hierarchy(TMatrix(*map(torch.from_numpy, m)), topo_t)
    rng = np.random.default_rng(2)
    r = rng.standard_normal(topo_j.n_cells)
    ct = rng.standard_normal(topo_j.n_cells)

    @jax.jit
    def jax_vcycle_vjp(rr, cc):
        y, vjp = jax.vjp(lambda r_: jmg.vcycle(hj, r_, omega=1.7), rr)
        return y, vjp(cc)[0]

    want, want_bar = jax_vcycle_vjp(jnp.asarray(r), jnp.asarray(ct))
    rt = torch.from_numpy(r).requires_grad_(True)
    got = tmg.vcycle(ht, rt, omega=1.7)
    (got_bar,) = torch.autograd.grad(got, rt, torch.from_numpy(ct))
    assert_close(got, want, BAR, "vcycle")
    assert_close(got_bar, want_bar, BAR, "vcycle vjp")


@pytest.fixture(scope="module")
def canonical():
    return _assembled("canonical")


@pytest.mark.parametrize("field,symmetric", [("p", True), ("U", False)])
def test_solve_fixed_linear_fallback_matches_jax(canonical, field,
                                                 symmetric):
    """solve_fixed asked for "mg" on the canonical layout (no grid form, no
    dense-DIA lines) falls through to "linear": Chebyshev for the
    symmetric pressure matrix, damped Jacobi for momentum; output and its
    vjp in (matrix, psi0) against dafoam_tpu at 1e-10."""
    from dafoam_tpu.linalg import fvsolve as jfs
    from dafoam_tpu_torch.linalg import fvsolve as tfs
    topo_j, topo_t, mats, st = canonical
    m, psi0 = mats[field], st[field]
    rng = np.random.default_rng(6)
    ct = rng.standard_normal(np.shape(psi0))

    @jax.jit
    def jax_fixed(mm, ps, cc):
        y, vjp = jax.vjp(lambda m_, p_: jfs.solve_fixed(
            JMatrix(*m_), p_, topo_j, symmetric=symmetric, n_iters=12,
            smoother="mg"), tuple(mm), ps)
        return y, vjp(cc)

    want, (want_m, want_p) = jax_fixed(tuple(map(jnp.asarray, m)),
                                       jnp.asarray(psi0), jnp.asarray(ct))
    tm = [torch.from_numpy(np.array(a)).requires_grad_(True) for a in m]
    tp = torch.from_numpy(np.array(psi0)).requires_grad_(True)
    got = tfs.solve_fixed(TMatrix(*tm), tp, topo_t, symmetric=symmetric,
                          n_iters=12, smoother="mg")
    grads = torch.autograd.grad(got, tm + [tp], torch.from_numpy(ct))
    assert_close(got, want, 1e-10, "x")
    for name, g, w in zip(("diag", "lower", "upper", "source", "psi0"),
                          grads, list(want_m) + [want_p]):
        assert_close(g, w, 1e-10, name)
