"""dafoam_tpu_torch's OpenFOAM polyMesh IO and native parser against
dafoam_tpu's (CPU):

- tests/fixtures/ofcase (hand-written OpenFOAM files) read by both
  packages: points, every topology array and the patches identical;
- the writer's files byte-identical to dafoam_tpu's for box_hex_mesh(4,
  3, 2) and the 32x12 NACA0012 O-mesh, and a dense-DIA topology written
  as the canonical one;
- the binary + gzip case of tests/test_polymesh_io.py read the same by
  both;
- the native and numpy parse paths agree, and ``native.COUNTS`` says which
  one ran; the payload parsers' values and their None on malformed input;
- a DASimpleFoam residual on the read-back O-mesh equal to the one on the
  generated mesh, bit for bit, on both face layouts.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from test_torch_cases import LAYOUTS, REPO, naca_options, omesh_jax, \
    omesh_torch, to_layout

torch.set_num_threads(1)
FIXTURE = os.path.join(REPO, "tests", "fixtures", "ofcase")
TOPO_ARRAYS = ("face_verts", "face_nverts", "owner", "neighbour")
FILES = ("points", "faces", "owner", "neighbour", "boundary")


def assert_same_mesh(got, want):
    (pg, tg), (pw, tw) = got, want
    np.testing.assert_array_equal(np.asarray(pg), np.asarray(pw))
    assert pg.dtype == np.float64
    assert (tg.n_cells, tg.n_points, tg.n_internal) == \
        (tw.n_cells, tw.n_points, tw.n_internal)
    for k in TOPO_ARRAYS:
        a, b = getattr(tg, k), getattr(tw, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert [(p.name, p.start, p.size, p.kind) for p in tg.patches] == \
        [(p.name, p.start, p.size, p.kind) for p in tw.patches]


def test_fixture_reads_as_in_dafoam_tpu():
    from dafoam_tpu.mesh.polymesh import read_polymesh as jread
    from dafoam_tpu_torch import native
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    native.reset_counts()
    got = read_polymesh(FIXTURE)
    assert native.COUNTS == {"labels": 2, "points": 1, "faces": 1,
                             "labels_numpy": 0, "points_numpy": 0,
                             "faces_numpy": 0}
    assert_same_mesh(got, jread(FIXTURE))
    assert set(got[1].face_nverts.tolist()) == {3, 4}


def _box_jax():
    from dafoam_tpu.mesh import box_hex_mesh
    return box_hex_mesh(4, 3, 2, (1.0, 1.0, 1.0))


def _box_torch():
    from dafoam_tpu_torch.mesh import box_hex_mesh
    return box_hex_mesh(4, 3, 2, (1.0, 1.0, 1.0))


@pytest.mark.parametrize("meshes", [(_box_jax, _box_torch),
                                    (omesh_jax, omesh_torch)],
                         ids=["box", "omesh"])
def test_writer_bytes_equal_dafoam_tpu(tmp_path, meshes):
    from dafoam_tpu.mesh.polymesh import write_polymesh as jwrite
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh, write_polymesh
    from dafoam_tpu_torch.mesh.topology import to_dia_dense
    (pj, tj), (pt, tt) = meshes[0](), meshes[1]()
    jwrite(str(tmp_path / "jax"), np.asarray(pj), tj)
    write_polymesh(str(tmp_path / "torch"), torch.as_tensor(pt), tt)
    # the dense-DIA topology (a CUDA solver's) writes the canonical mesh
    dense = to_dia_dense(tt)
    assert dense is not None and dense.n_internal > tt.n_internal
    write_polymesh(str(tmp_path / "dense"), pt, dense)
    for f in FILES:
        want = (tmp_path / "jax/constant/polyMesh" / f).read_bytes()
        for d in ("torch", "dense"):
            assert (tmp_path / d / "constant/polyMesh" / f).read_bytes() \
                == want, (d, f)
    assert_same_mesh(read_polymesh(str(tmp_path / "torch")), (pt, tt))


def _write_binary_gz(case, pts, topo):
    """tests/test_polymesh_io.py's binary case: gzipped binary points, a
    compact binary faceList, binary owner/neighbour, ASCII boundary."""
    pm = case / "constant" / "polyMesh"
    os.makedirs(pm)

    def header(cls, obj, fmt="binary"):
        return (f"FoamFile\n{{\n    version 2.0;\n    format {fmt};\n"
                f"    class {cls};\n    object {obj};\n}}\n").encode()

    with gzip.open(pm / "points.gz", "wb") as fh:
        fh.write(header("vectorField", "points"))
        fh.write(f"{len(pts)}(".encode())
        fh.write(np.asarray(pts, "<f8").tobytes())
        fh.write(b")")
    fv, fn = topo.face_verts, topo.face_nverts
    offsets = np.concatenate([[0], np.cumsum(fn)]).astype("<i4")
    flat = np.concatenate(
        [fv[f, : fn[f]] for f in range(topo.n_faces)]).astype("<i4")
    with open(pm / "faces", "wb") as fh:
        fh.write(header("compoundFaceList", "faces"))
        fh.write(str(len(offsets)).encode() + b"(" + offsets.tobytes()
                 + b")\n" + str(len(flat)).encode() + b"(" + flat.tobytes()
                 + b")")
    for name, arr in (("owner", topo.owner), ("neighbour", topo.neighbour)):
        with open(pm / name, "wb") as fh:
            fh.write(header("labelList", name))
            fh.write(str(len(arr)).encode() + b"(")
            fh.write(np.asarray(arr, "<i4").tobytes())
            fh.write(b")")
    with open(pm / "boundary", "wb") as fh:
        fh.write(header("polyBoundaryMesh", "boundary", fmt="ascii"))
        body = f"{len(topo.patches)}\n(\n"
        for p in topo.patches:
            t = "wall" if p.kind == "wall" else "patch"
            body += (f"{p.name}\n{{\n type {t};\n nFaces {p.size};\n"
                     f" startFace {p.start};\n}}\n")
        fh.write((body + ")\n").encode())


def test_binary_gz_reads_as_in_dafoam_tpu(tmp_path):
    from dafoam_tpu.mesh.polymesh import read_polymesh as jread
    from dafoam_tpu_torch import native
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh
    pts, topo = read_polymesh(FIXTURE)
    _write_binary_gz(tmp_path / "bin", pts, topo)
    native.reset_counts()
    got = read_polymesh(str(tmp_path / "bin"))
    assert native.COUNTS == {"labels": 0, "points": 0, "faces": 0,
                             "labels_numpy": 2, "points_numpy": 1,
                             "faces_numpy": 1}
    assert_same_mesh(got, jread(str(tmp_path / "bin")))
    assert_same_mesh(got, (pts, topo))


def test_native_and_numpy_paths_agree(tmp_path, monkeypatch):
    from dafoam_tpu_torch import native
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh, write_polymesh
    pts, topo = omesh_torch()
    write_polymesh(str(tmp_path), pts, topo)
    assert native.available()
    native.reset_counts()
    nat = read_polymesh(str(tmp_path))
    assert native.COUNTS["faces"] == 1 and native.COUNTS["faces_numpy"] == 0
    monkeypatch.setenv("DAFOAM_TPU_NO_NATIVE", "1")
    assert not native.available()
    native.reset_counts()
    ref = read_polymesh(str(tmp_path))
    assert native.COUNTS == {"labels": 0, "points": 0, "faces": 0,
                             "labels_numpy": 2, "points_numpy": 1,
                             "faces_numpy": 1}
    assert_same_mesh(nat, ref)
    assert_same_mesh(nat, (pts, topo))


def test_payload_parsers_and_malformed_input():
    from dafoam_tpu import native as jnative
    from dafoam_tpu_torch import native
    cases = [
        ("parse_labels_ascii", b"// a comment\n5 ( 3 1 4 1 5 )"),
        ("parse_points_ascii",
         b"2\n(\n(0 0.5 -1e-3)  /* inline */ (2.25 3 4)\n)"),
        ("parse_faces_ascii", b"2(3(0 1 2) 4(4 5 6 7))"),
    ]
    for fn, payload in cases:
        got, want = getattr(native, fn)(payload), getattr(jnative, fn)(
            payload)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        native.parse_labels_ascii(cases[0][1]), [3, 1, 4, 1, 5])
    idx, flat = native.parse_faces_ascii(cases[2][1])
    np.testing.assert_array_equal(idx, [0, 3, 7])
    np.testing.assert_array_equal(flat, [0, 1, 2, 4, 5, 6, 7])
    for fn, payload in (("parse_labels_ascii", b"not a list"),
                        ("parse_labels_ascii", b"3 ( 1 2 )"),
                        ("parse_points_ascii", b"2 ( (0 0) )"),
                        ("parse_faces_ascii", b"1(3(0 1))")):
        assert getattr(native, fn)(payload) is None, (fn, payload)
        assert getattr(jnative, fn)(payload) is None, (fn, payload)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_residual_on_read_mesh_equals_generated(tmp_path, layout):
    from dafoam_tpu_torch.convert import state_from_numpy
    from dafoam_tpu_torch.mesh.polymesh import read_polymesh, write_polymesh
    from dafoam_tpu_torch.solvers import make_solver
    pts, topo = omesh_torch()
    write_polymesh(str(tmp_path), pts, topo)
    pts2, topo2 = read_polymesh(str(tmp_path))
    opts = naca_options(layout)
    gen = make_solver(opts, topo, pts, device="cpu", dtype=torch.float64)
    red = make_solver(opts, topo2, pts2, device="cpu", dtype=torch.float64)
    assert (red.topo.dia_dense() is not None) == (layout == "diaDense")

    rng = np.random.default_rng(7)
    nc = topo.n_cells
    st = {"U": np.array([1.0, 0.0, 0.0]) + 0.1 * rng.standard_normal(
              (nc, 3)),
          "p": 0.1 * rng.standard_normal(nc),
          "nuTilda": 3e-3 * (1.0 + 0.1 * rng.random(nc)),
          "phi": 0.01 * rng.standard_normal(topo.n_faces)}
    st = state_from_numpy(to_layout(st, gen.topo, topo.n_faces), "cpu",
                          torch.float64)
    with torch.no_grad():
        rg = gen.residuals(st, gen.make_inputs())
        rr = red.residuals(st, red.make_inputs())
    assert set(rg) == set(rr)
    for k in rg:
        assert torch.equal(rg[k], rr[k]), k
