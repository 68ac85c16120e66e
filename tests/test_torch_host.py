"""The port's numpy host layer equals dafoam_tpu's, element for element:
the 32x12 NACA0012 O-mesh points and topology, its band structure in both
face layouts (dia, dia_dense, ell, boundary_scatter_plan) and the wall
distance."""

import numpy as np
import pytest

from dafoam_tpu.mesh import topology as jtop
from dafoam_tpu.mesh import walldist as jwd
from dafoam_tpu_torch.mesh import topology as ttop
from dafoam_tpu_torch.mesh import walldist as twd
from dafoam_tpu_torch.option import DAOption as TOption
from test_torch_cases import LAYOUTS, omesh_jax, omesh_torch


def _both(layout):
    pj, tj = omesh_jax()
    pt, tt = omesh_torch()
    if layout == "diaDense":
        tj, tt = jtop.to_dia_dense(tj), ttop.to_dia_dense(tt)
    return (pj, tj), (pt, tt)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                      b.dtype, a.shape,
                                                      b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_topology_equal(layout):
    (pj, tj), (pt, tt) = _both(layout)
    _equal(pj, pt, "points")
    for f in ("face_verts", "face_nverts", "owner", "neighbour"):
        _equal(getattr(tj, f), getattr(tt, f), f)
    assert (tj.n_cells, tj.n_points, tj.n_internal) == \
        (tt.n_cells, tt.n_points, tt.n_internal)
    assert [(p.name, p.start, p.size, p.kind) for p in tj.patches] == \
        [(p.name, p.start, p.size, p.kind) for p in tt.patches]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_band_structures_equal(layout):
    (_, tj), (_, tt) = _both(layout)
    for a, b, what in zip(tj.dia(), tt.dia(), ("offsets", "face_idx",
                                               "kind")):
        _equal(a, b, "dia " + what)
    if layout == "diaDense":
        (oj, vj), (ot, vt) = tj.dia_dense(), tt.dia_dense()
        assert oj == ot
        _equal(vj, vt, "dia_dense valid")
        _equal(tj.face_map_old2new, tt.face_map_old2new, "face map")
    else:
        assert tj.dia_dense() is None and tt.dia_dense() is None
    for a, b, what in zip(tj.ell(), tt.ell(), ("face_id", "col",
                                               "is_owner", "valid")):
        _equal(a, b, "ell " + what)
    plan_j, plan_t = tj.boundary_scatter_plan(), tt.boundary_scatter_plan()
    assert [p[:3] for p in plan_j] == [p[:3] for p in plan_t]
    for (_, _, _, ij), (_, _, _, it) in zip(plan_j, plan_t):
        assert (ij is None) == (it is None)
        if ij is not None:
            _equal(ij, it, "plan idx")


def test_rcm_renumbering_equal():
    (_, tj), (_, tt) = _both("canonical")
    perm_j, perm_t = jtop.renumber_rcm(tj), ttop.renumber_rcm(tt)
    _equal(perm_j, perm_t, "rcm perm")
    rj = jtop.apply_cell_permutation(tj, perm_j)
    rt = ttop.apply_cell_permutation(tt, perm_t)
    for f in ("face_verts", "face_nverts", "owner", "neighbour"):
        _equal(getattr(rj, f), getattr(rt, f), "renumbered " + f)


def test_wall_distance_equal():
    (pj, tj), (_, tt) = _both("canonical")
    rng = np.random.default_rng(5)
    cc = rng.uniform(-2.0, 3.0, size=(tj.n_cells, 3))
    mask_j = jwd.wall_face_mask(tj)
    _equal(mask_j, twd.wall_face_mask(tt), "wall mask")
    want = jwd.nearest_wall_distance(cc, pj, tj, mask_j)
    got = twd.compute_wall_distance(cc, pj, tt)
    _equal(want, got, "wall distance")


def test_option_defaults_equal():
    from dafoam_tpu.option import DAOption as JOption
    assert TOption().all == JOption().all
