"""Structured hex mesh generator (blockMesh-lite); numpy copy of
``dafoam_tpu.mesh.generate``.

Produces the same data the OpenFOAM polyMesh reader produces, in canonical
ordering (internal faces upper-triangular by (owner, neighbour), boundary
faces grouped per patch, outward normals), array for array equal to the
JAX package's generator.
"""

from __future__ import annotations

import numpy as np

from dafoam_tpu_torch.mesh.topology import MeshTopology, Patch


def box_hex_mesh(
    nx: int,
    ny: int,
    nz: int = 1,
    lengths=(1.0, 1.0, 0.1),
    kinds: dict | None = None,
    grading=None,
):
    """Uniform (optionally graded) hex mesh of a box.

    Returns (points (np,3) float64 numpy, MeshTopology). Patch names:
    xmin/xmax/ymin/ymax/zmin/zmax; override kinds per patch via ``kinds``
    (e.g. {"zmin": "empty", "zmax": "empty"} for 2-D cases).
    """
    kinds = kinds or {}
    lx, ly, lz = lengths

    def axis_coords(n, ln, g):
        if g is None or g == 1.0:
            return np.linspace(0.0, ln, n + 1)
        # geometric expansion ratio g = last/first cell size
        r = g ** (1.0 / max(n - 1, 1))
        sizes = r ** np.arange(n)
        sizes = sizes / sizes.sum() * ln
        return np.concatenate([[0.0], np.cumsum(sizes)])

    gx, gy, gz = (grading or (None, None, None))
    xs = axis_coords(nx, lx, gx)
    ys = axis_coords(ny, ly, gy)
    zs = axis_coords(nz, lz, gz)

    npx, npy, npz = nx + 1, ny + 1, nz + 1
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    # point id p = i + npx*(j + npy*k)
    pts = np.stack(
        [X.transpose(2, 1, 0).ravel(), Y.transpose(2, 1, 0).ravel(),
         Z.transpose(2, 1, 0).ravel()], axis=-1)

    def pid(i, j, k):
        return i + npx * (j + npy * k)

    def cid(i, j, k):
        return i + nx * (j + ny * k)

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")

    faces = []   # (v0,v1,v2,v3, owner, neighbour) ; neighbour -1 => boundary

    def quad_x(i, j, k):  # +x normal at x-plane i
        return [pid(i, j, k), pid(i, j + 1, k), pid(i, j + 1, k + 1), pid(i, j, k + 1)]

    def quad_y(i, j, k):  # +y normal
        return [pid(i, j, k), pid(i, j, k + 1), pid(i + 1, j, k + 1), pid(i + 1, j, k)]

    def quad_z(i, j, k):  # +z normal
        return [pid(i, j, k), pid(i + 1, j, k), pid(i + 1, j + 1, k), pid(i, j + 1, k)]

    int_faces = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = cid(i, j, k)
                if i + 1 < nx:
                    int_faces.append((quad_x(i + 1, j, k), c, cid(i + 1, j, k)))
                if j + 1 < ny:
                    int_faces.append((quad_y(i, j + 1, k), c, cid(i, j + 1, k)))
                if k + 1 < nz:
                    int_faces.append((quad_z(i, j, k + 1), c, cid(i, j, k + 1)))
    # canonical upper-triangular ordering
    int_faces.sort(key=lambda t: (t[1], t[2]))

    patch_faces: dict[str, list] = {n: [] for n in
                                    ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax")}
    for k in range(nz):
        for j in range(ny):
            patch_faces["xmin"].append((quad_x(0, j, k)[::-1], cid(0, j, k)))
            patch_faces["xmax"].append((quad_x(nx, j, k), cid(nx - 1, j, k)))
    for k in range(nz):
        for i in range(nx):
            patch_faces["ymin"].append((quad_y(i, 0, k)[::-1], cid(i, 0, k)))
            patch_faces["ymax"].append((quad_y(i, ny, k), cid(i, ny - 1, k)))
    for j in range(ny):
        for i in range(nx):
            patch_faces["zmin"].append((quad_z(i, j, 0)[::-1], cid(i, j, 0)))
            patch_faces["zmax"].append((quad_z(i, j, nz), cid(i, j, nz - 1)))

    n_internal = len(int_faces)
    verts = [f[0] for f in int_faces]
    owner = [f[1] for f in int_faces]
    neighbour = [f[2] for f in int_faces]

    patches = []
    start = n_internal
    for name in ("xmin", "xmax", "ymin", "ymax", "zmin", "zmax"):
        fl = patch_faces[name]
        patches.append(Patch(name=name, start=start, size=len(fl),
                             kind=kinds.get(name, "patch")))
        for v, o in fl:
            verts.append(v)
            owner.append(o)
        start += len(fl)

    topo = MeshTopology(
        n_cells=nx * ny * nz,
        n_points=pts.shape[0],
        face_verts=np.asarray(verts, dtype=np.int32),
        face_nverts=np.full(len(verts), 4, dtype=np.int32),
        owner=np.asarray(owner, dtype=np.int32),
        neighbour=np.asarray(neighbour, dtype=np.int32),
        n_internal=n_internal,
        patches=tuple(patches),
    )
    topo.validate()
    return pts, topo
