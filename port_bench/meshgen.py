"""The benchmark's own NACA0012 O-mesh: a vectorised numpy generator and an
OpenFOAM ASCII polyMesh writer with a cache inside the checkout.

The geometry is that of the program's ``mesh/airfoil.omesh_naca0012``
(cosine-clustered NACA0012 surface, algebraic radial lines with geometric
wall clustering, a circular far field, 30 wrap-direction smoothing sweeps;
patches wing, far, zmin, zmax), and the faces come out in OpenFOAM's
canonical order: internal faces by (owner, neighbour) with owner <
neighbour, then each patch's faces in turn. The mesh is an input of the
benchmark: the program reads it from disk, the reference takes the arrays.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np

PATCHES = ("wing", "far", "zmin", "zmax")
KINDS = {"wing": "wall", "far": "patch", "zmin": "empty", "zmax": "empty"}


def _surface(n_wrap):
    m = n_wrap // 2
    beta = np.linspace(0.0, np.pi, m + 1)
    xc = 0.5 * (1.0 + np.cos(beta))
    t = 0.12
    yt = 5.0 * t * (0.2969 * np.sqrt(xc) - 0.1260 * xc - 0.3516 * xc ** 2
                    + 0.2843 * xc ** 3 - 0.1036 * xc ** 4)
    lower = np.stack([xc, -yt], axis=-1)
    upper = np.stack([xc[::-1], yt[::-1]], axis=-1)
    return np.concatenate([lower[:-1], upper[:-1]], axis=0)


def _radial_ratio(f, n):
    """The growth ratio r with f (r^n - 1) / (r - 1) = 1: the program's
    Newton iteration where it converges, which it does up to a few hundred
    radial cells; beyond, r^n overflows from its start at 1.2, the
    iteration stalls at its floor of 1.0001 and the first cells collapse
    (first spacing 1e-32 and 543,790 inverted cells at 1024 x 1024), so
    a bisection on the logarithm of the sum takes over."""
    r = 1.2
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(100):
            g = f * (r ** n - 1.0) / (r - 1.0) - 1.0
            dg = f * ((n * r ** (n - 1)) * (r - 1.0) - (r ** n - 1.0)) \
                / (r - 1.0) ** 2
            r_new = r - g / dg
            if not np.isfinite(r_new) or r_new <= 1.0001:
                r_new = max(1.0001, (r + 1.0001) / 2)
            if abs(r_new - r) < 1e-14:
                r = r_new
                break
            r = r_new
        if abs(f * (r ** n - 1.0) / (r - 1.0) - 1.0) < 1e-9:
            return r

    def log_sum(q):
        return np.log(f) + np.log(np.expm1(n * np.log(q))) - np.log(q - 1.0)

    lo, hi = 1.0 + 1e-12, 2.0
    with np.errstate(over="ignore"):
        for _ in range(200):
            mid = 0.5 * (lo + hi)
            if log_sum(mid) > 0.0:
                hi = mid
            else:
                lo = mid
    return 0.5 * (lo + hi)


def omesh(n_wrap, n_radial, radius=15.0, first_cell=4e-3, span=0.1):
    """NACA0012 O-mesh of n_wrap x n_radial cells and one cell in z.

    Returns a dict of numpy arrays: points (n_points, 3) float64, faces
    (n_faces, 4) int64 vertex lists, owner (n_faces,), neighbour
    (n_internal,), and patches [(name, kind, start, size)].
    """
    nw, nr = int(n_wrap), int(n_radial)
    surf = _surface(nw)
    center = np.array([0.5, 0.0])
    theta_s = np.unwrap(np.arctan2(surf[:, 1] - center[1],
                                   surf[:, 0] - center[0]))
    theta_u = theta_s[0] + (theta_s[-1] - theta_s[0]
                            + (theta_s[1] - theta_s[0])) * np.arange(nw) / nw
    theta_f = 0.75 * theta_u + 0.25 * theta_s
    far = center + radius * np.stack([np.cos(theta_f), np.sin(theta_f)], -1)
    d_total = np.linalg.norm(far - surf, axis=-1).mean()
    f = first_cell / d_total
    r = _radial_ratio(f, nr)
    s = np.concatenate([[0.0], np.cumsum(f * r ** np.arange(nr))])
    s = s / s[-1]
    pts2d = surf[:, None, :] * (1.0 - s[None, :, None]) \
        + far[:, None, :] * s[None, :, None]
    w_s = (0.5 * s[1:-1]) ** 0.75
    for _ in range(30):
        inner = pts2d[:, 1:-1, :]
        avg = 0.5 * (np.roll(inner, 1, axis=0) + np.roll(inner, -1, axis=0))
        pts2d[:, 1:-1, :] = inner + w_s[None, :, None] * (avg - inner)

    npl = nw * (nr + 1)
    pts = np.empty((2, nr + 1, nw, 3))
    pts[:, :, :, 0] = pts2d[:, :, 0].T[None]
    pts[:, :, :, 1] = pts2d[:, :, 1].T[None]
    pts[0, :, :, 2] = 0.0
    pts[1, :, :, 2] = span
    pts = pts.reshape(-1, 3)

    i = np.arange(nw)[None, :]
    j = np.arange(nr)[:, None]
    ip = (i + 1) % nw

    def pid(ii, jj, k):
        return ii + nw * jj + npl * k

    def cid(ii, jj):
        return ii + nw * jj

    shape = (nr, nw)
    # wrap-direction faces between (i, j) and (i + 1, j)
    wv = np.stack([pid(ip, j, 0), pid(ip, j + 1, 0), pid(ip, j + 1, 1),
                   pid(ip, j, 1)], -1)
    wo = np.broadcast_to(cid(i, j), shape)
    wn = np.broadcast_to(cid(ip, j), shape)
    # radial faces between (i, j) and (i, j + 1), j + 1 < nr
    jr = np.arange(nr - 1)[:, None]
    rv = np.stack([pid(i, jr + 1, 0), pid(i, jr + 1, 1), pid(ip, jr + 1, 1),
                   pid(ip, jr + 1, 0)], -1)
    ro = np.broadcast_to(cid(i, jr), (nr - 1, nw))
    rn = np.broadcast_to(cid(i, jr + 1), (nr - 1, nw))
    verts = np.concatenate([wv.reshape(-1, 4), rv.reshape(-1, 4)])
    own = np.concatenate([wo.reshape(-1), ro.reshape(-1)])
    nei = np.concatenate([wn.reshape(-1), rn.reshape(-1)])
    flip = own > nei
    verts[flip] = verts[flip][:, ::-1]
    own, nei = np.where(flip, nei, own), np.where(flip, own, nei)
    order = np.lexsort((nei, own))
    verts, own, nei = verts[order], own[order], nei[order]

    i1 = np.arange(nw)
    i1p = (i1 + 1) % nw
    wing = np.stack([pid(i1, 0, 0), pid(i1p, 0, 0), pid(i1p, 0, 1),
                     pid(i1, 0, 1)], -1)
    farf = np.stack([pid(i1, nr, 0), pid(i1, nr, 1), pid(i1p, nr, 1),
                     pid(i1p, nr, 0)], -1)
    zmin = np.stack([pid(i, j, 0), pid(i, j + 1, 0), pid(ip, j + 1, 0),
                     pid(ip, j, 0)], -1).reshape(-1, 4)
    zmax = np.stack([pid(i, j, 1), pid(ip, j, 1), pid(ip, j + 1, 1),
                     pid(i, j + 1, 1)], -1).reshape(-1, 4)
    cells = cid(i, j).reshape(-1)
    bfaces = {"wing": (wing, cid(i1, 0)), "far": (farf, cid(i1, nr - 1)),
              "zmin": (zmin, cells), "zmax": (zmax, cells)}
    faces = [verts]
    owner = [own]
    patches = []
    start = verts.shape[0]
    for name in PATCHES:
        fv, fo = bfaces[name]
        faces.append(fv)
        owner.append(fo)
        patches.append((name, KINDS[name], start, fv.shape[0]))
        start += fv.shape[0]
    return {"points": pts, "faces": np.concatenate(faces).astype(np.int64),
            "owner": np.concatenate(owner).astype(np.int64),
            "neighbour": nei.astype(np.int64), "patches": patches,
            "n_cells": nw * nr}


_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    location    "constant/polyMesh";
    object      {obj};
}}
"""


def write_polymesh(case_dir, mesh):
    """Write ``mesh`` (as ``omesh`` returns it) as an OpenFOAM ASCII
    polyMesh under ``case_dir/constant/polyMesh``."""
    pm = os.path.join(case_dir, "constant", "polyMesh")
    os.makedirs(pm, exist_ok=True)

    def dump(name, cls, arr, fmt):
        with open(os.path.join(pm, name), "w") as fh:
            fh.write(_HEADER.format(cls=cls, obj=name))
            fh.write(f"{arr.shape[0]}\n(\n")
            np.savetxt(fh, arr, fmt=fmt)
            fh.write(")\n")

    dump("points", "vectorField", mesh["points"], "(%.17g %.17g %.17g)")
    dump("faces", "faceList", mesh["faces"], "4(%d %d %d %d)")
    dump("owner", "labelList", mesh["owner"], "%d")
    dump("neighbour", "labelList", mesh["neighbour"], "%d")
    with open(os.path.join(pm, "boundary"), "w") as fh:
        fh.write(_HEADER.format(cls="polyBoundaryMesh", obj="boundary"))
        fh.write(f"{len(mesh['patches'])}\n(\n")
        for name, kind, start, size in mesh["patches"]:
            fh.write(f"    {name}\n    {{\n"
                     f"        type            {kind};\n"
                     f"        nFaces          {size};\n"
                     f"        startFace       {start};\n    }}\n")
        fh.write(")\n")
    return pm


def mesh_key(spec):
    """A short name for a mesh specification (the generator's arguments)."""
    blob = json.dumps(spec, sort_keys=True).encode()
    return f"naca0012_{spec['n_wrap']}x{spec['n_radial']}_" \
        + hashlib.sha256(blob).hexdigest()[:10]


def cached_case(cache_root, spec, mesh=None):
    """The case directory of ``spec``'s mesh under ``cache_root``, written
    there first if it is not yet (into a fixed side directory, then renamed
    into place). Returns (case_dir, seconds spent writing, 0 on a hit)."""
    case = os.path.join(cache_root, mesh_key(spec))
    if os.path.isfile(os.path.join(case, "constant", "polyMesh",
                                   "boundary")):
        return case, 0.0
    t0 = time.perf_counter()
    side = case + ".partial"
    shutil.rmtree(side, ignore_errors=True)
    write_polymesh(side, mesh if mesh is not None else omesh(**spec))
    shutil.rmtree(case, ignore_errors=True)
    os.replace(side, case)
    return case, time.perf_counter() - t0
