"""OpenFOAM polyMesh reader (ASCII, binary, gzip) and ASCII writer.

Port of ``dafoam_tpu.mesh.polymesh``. DAFoam reads the mesh through
pyofm (pyDAFoam.py ``_readOFGrid``: points, faces, boundary, owner,
neighbour); this reads the same on-disk format
(``constant[/region]/polyMesh/{points,faces,owner,neighbour,boundary}``)
into (points, MeshTopology), so an OpenFOAM case reaches any solver of
the port. The topology is host numpy, as every topology of the port;
``make_solver`` moves what it needs to the device. The number-heavy ASCII
payloads go through the native C++ parser (``dafoam_tpu_torch.native``);
binary files, and ASCII ones when the native path is off or refuses a
payload, take the numpy path. ``native.COUNTS`` records which path parsed
each file.
"""

from __future__ import annotations

import gzip
import os
import re

import numpy as np

from dafoam_tpu_torch import native as _native
from dafoam_tpu_torch.mesh.topology import (MeshTopology, Patch,
                                            from_dia_dense)

_KIND_MAP = {
    "wall": "wall",
    "empty": "empty",
    "symmetry": "symmetry",
    "symmetryPlane": "symmetry",
    "patch": "patch",
    "processor": "processor",
    "cyclic": "patch",
    "wedge": "patch",
}


def _read_file(path):
    for cand in (path, path + ".gz"):
        if os.path.exists(cand):
            op = gzip.open if cand.endswith(".gz") else open
            with op(cand, "rb") as f:
                return f.read()
    raise FileNotFoundError(path)


def _strip_header(data: bytes):
    """(format, payload after the FoamFile { ... } header)."""
    m = re.search(rb"FoamFile\s*\{.*?\}", data, re.S)
    if not m:
        raise ValueError("not an OpenFOAM file (no FoamFile header)")
    header = data[m.start():m.end()].decode("latin1")
    fmt = "binary" if "binary" in header else "ascii"
    return fmt, data[m.end():]


def _strip_comments(text: str) -> str:
    text = re.sub(r"//.*", "", text)
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return text


def _ascii_list(payload):
    """(count, text after the list's opening parenthesis)."""
    text = _strip_comments(payload.decode("latin1"))
    m = re.search(r"(\d+)\s*\(", text)
    return int(m.group(1)), text[m.end():]


def _read_labels(path):
    fmt, payload = _strip_header(_read_file(path))
    if fmt == "ascii":
        vals = _native.parse_labels_ascii(payload)
        if vals is not None:
            return vals
        _native.COUNTS["labels_numpy"] += 1
        n, body = _ascii_list(payload)
        vals = np.array(body[:body.index(")")].split(), dtype=np.int64)
        if vals.size != n:
            raise ValueError(f"{path}: {vals.size} labels, header says {n}")
        return vals
    # binary: "N(" then N int32 or int64 labels then ")"
    _native.COUNTS["labels_numpy"] += 1
    m = re.search(rb"(\d+)\s*\(", payload)
    n = int(m.group(1))
    raw = payload[m.end():]
    for dt in (np.dtype("<i4"), np.dtype("<i8")):
        if len(raw) >= n * dt.itemsize:
            return np.frombuffer(raw[: n * dt.itemsize],
                                 dtype=dt).astype(np.int64)
    raise ValueError(f"cannot parse binary labels in {path}")


def _read_points(path):
    fmt, payload = _strip_header(_read_file(path))
    if fmt == "ascii":
        pts = _native.parse_points_ascii(payload)
        if pts is not None:
            return pts
        _native.COUNTS["points_numpy"] += 1
        n, body = _ascii_list(payload)
        nums = re.findall(r"[-+0-9.eE]+", body)
        return np.array(nums[: 3 * n], dtype=np.float64).reshape(n, 3)
    _native.COUNTS["points_numpy"] += 1
    m = re.search(rb"(\d+)\s*\(", payload)
    n = int(m.group(1))
    raw = payload[m.end():]
    return np.frombuffer(raw[: n * 24], dtype="<f8").reshape(n, 3).copy()


def _read_faces(path):
    """Faces as CSR: (index (n+1,), flat vertex labels)."""
    fmt, payload = _strip_header(_read_file(path))
    if fmt == "ascii":
        csr = _native.parse_faces_ascii(payload)
        if csr is not None:
            return csr
        _native.COUNTS["faces_numpy"] += 1
        n, body = _ascii_list(payload)
        counts, flats = [], []
        # entries look like: 4(0 1 2 3)
        for fm in re.finditer(r"(\d+)\s*\(([^)]*)\)", body):
            k = int(fm.group(1))
            verts = np.array(fm.group(2).split(), dtype=np.int64)
            if verts.size != k:
                raise ValueError(f"{path}: a face of {k} vertices lists "
                                 f"{verts.size}")
            counts.append(k)
            flats.append(verts)
            if len(counts) == n:
                break
        if len(counts) != n:
            raise ValueError(f"{path}: {len(counts)} faces, header says {n}")
        idx = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=idx[1:])
        return idx, (np.concatenate(flats) if flats
                     else np.zeros(0, dtype=np.int64))
    # binary faces (compact faceList): index array (n+1) + flat labels
    _native.COUNTS["faces_numpy"] += 1
    m = re.search(rb"(\d+)\s*\(", payload)
    n_idx = int(m.group(1))
    raw = payload[m.end():]
    idx = np.frombuffer(raw[: n_idx * 4], dtype="<i4").astype(np.int64)
    rest = raw[n_idx * 4:]
    m2 = re.search(rb"(\d+)\s*\(", rest)
    n_flat = int(m2.group(1))
    flat = np.frombuffer(rest[m2.end(): m2.end() + n_flat * 4],
                         dtype="<i4").astype(np.int64)
    return idx, flat


def _read_boundary(path):
    _, payload = _strip_header(_read_file(path))
    text = _strip_comments(payload.decode("latin1"))
    patches = []
    for m in re.finditer(r"([A-Za-z0-9_\-.:]+)\s*\{([^{}]*)\}", text):
        name, body = m.group(1), m.group(2)
        if "nFaces" not in body:
            continue

        def get(key):
            return re.search(key + r"\s+([^;]+);", body).group(1).strip()

        patches.append((name, get("type"), int(get("startFace")),
                        int(get("nFaces"))))
    return patches


def read_polymesh(case_dir: str, region: str = ""):
    """Read an OpenFOAM case's polyMesh -> (points (n_points, 3) float64
    numpy, MeshTopology)."""
    pm = os.path.join(case_dir, "constant", region, "polyMesh")
    points = _read_points(os.path.join(pm, "points"))
    fidx, fflat = _read_faces(os.path.join(pm, "faces"))
    owner = _read_labels(os.path.join(pm, "owner")).astype(np.int32)
    neighbour = _read_labels(os.path.join(pm, "neighbour")).astype(np.int32)
    bnd = _read_boundary(os.path.join(pm, "boundary"))

    n_internal = neighbour.shape[0]
    n_cells = int(max(owner.max(), neighbour.max() if n_internal else 0)) + 1

    # CSR -> padded (n_faces, max_nv); pad slots repeat the FIRST vertex
    # (a degenerate repeat adds zero area in the geometry's sums)
    fn64 = fidx[1:] - fidx[:-1]
    max_nv = int(fn64.max())
    cols = np.arange(max_nv, dtype=np.int64)[None, :]
    pos = np.where(cols < fn64[:, None], fidx[:-1, None] + cols,
                   fidx[:-1, None])

    topo = MeshTopology(
        n_cells=n_cells,
        n_points=points.shape[0],
        face_verts=fflat[pos].astype(np.int32),
        face_nverts=fn64.astype(np.int32),
        owner=owner,
        neighbour=neighbour,
        n_internal=n_internal,
        patches=tuple(Patch(name=name, start=start, size=nfaces,
                            kind=_KIND_MAP.get(ptype, "patch"))
                      for name, ptype, start, nfaces
                      in sorted(bnd, key=lambda t: t[2])),
    )
    topo.validate()
    return points, topo


# ---------------------------------------------------------------------------
# writer (round trips; also exports the port's meshes to OpenFOAM)
# ---------------------------------------------------------------------------

_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "constant/polyMesh";
    object      {obj};
}}
"""
_KIND_OUT = {"wall": "wall", "empty": "empty", "symmetry": "symmetry",
             "patch": "patch", "processor": "processor"}


def write_polymesh(case_dir: str, points, topo, region: str = ""):
    """Write points/faces/owner/neighbour/boundary in OpenFOAM ASCII, byte
    for byte as ``dafoam_tpu``'s writer. ``points`` may be a tensor on any
    device. A dense-DIA topology (``solver.topo`` on a CUDA device) is
    written as the canonical topology it was built from, without its
    zero-area padded faces. Returns the polyMesh directory."""
    topo = from_dia_dense(topo)
    pm = os.path.join(case_dir, "constant", region, "polyMesh")
    os.makedirs(pm, exist_ok=True)
    if hasattr(points, "detach"):
        points = points.detach().cpu().numpy()
    pts = np.asarray(points)

    with open(os.path.join(pm, "points"), "w") as fh:
        fh.write(_HEADER.format(cls="vectorField", obj="points"))
        fh.write(f"{pts.shape[0]}\n(\n")
        for p in pts:
            fh.write("(%.17g %.17g %.17g)\n" % tuple(p))
        fh.write(")\n")

    with open(os.path.join(pm, "faces"), "w") as fh:
        fh.write(_HEADER.format(cls="faceList", obj="faces"))
        fh.write(f"{topo.n_faces}\n(\n")
        for verts, k in zip(topo.face_verts.tolist(),
                            topo.face_nverts.tolist()):
            fh.write(f"{k}(" + " ".join(map(str, verts[:k])) + ")\n")
        fh.write(")\n")

    for name, arr in (("owner", topo.owner), ("neighbour", topo.neighbour)):
        with open(os.path.join(pm, name), "w") as fh:
            fh.write(_HEADER.format(cls="labelList", obj=name))
            fh.write(f"{arr.shape[0]}\n(\n")
            fh.write("\n".join(map(str, arr.tolist())))
            fh.write("\n)\n")

    with open(os.path.join(pm, "boundary"), "w") as fh:
        fh.write(_HEADER.format(cls="polyBoundaryMesh", obj="boundary"))
        fh.write(f"{len(topo.patches)}\n(\n")
        for p in topo.patches:
            fh.write(f"    {p.name}\n    {{\n"
                     f"        type            {_KIND_OUT.get(p.kind, 'patch')};\n"
                     f"        nFaces          {p.size};\n"
                     f"        startFace       {p.start};\n    }}\n")
        fh.write(")\n")
    return pm
