"""NACA 4-digit airfoil O-mesh generator (the north-star case geometry).

The reference's NACA0012 fixtures come from the external reg_test_files
repo; this generates an equivalent structured O-mesh natively: cosine-
clustered surface points, algebraic radial lines with geometric wall
clustering, circular farfield. Patches: "wing" (wall), "far" (farfield),
"zmin"/"zmax" (empty).
"""

from __future__ import annotations

import numpy as np

from dafoam_tpu_torch.mesh.topology import build_topology


def naca4_thickness(x, t=0.12):
    """Symmetric NACA thickness with closed trailing edge."""
    return 5.0 * t * (0.2969 * np.sqrt(x) - 0.1260 * x - 0.3516 * x ** 2
                      + 0.2843 * x ** 3 - 0.1036 * x ** 4)


def naca0012_surface(n_wrap: int):
    """Closed surface loop, n_wrap points, TE -> lower -> LE -> upper -> TE.

    Counter-clockwise when viewed from +z.
    """
    # cosine clustering along chord; n_wrap must be even
    m = n_wrap // 2
    beta = np.linspace(0.0, np.pi, m + 1)
    xc = 0.5 * (1.0 + np.cos(beta))        # 1 -> 0
    yt = naca4_thickness(xc)
    # lower surface from TE (x=1) to LE (x=0), then upper from LE to TE
    lower = np.stack([xc, -yt], axis=-1)          # m+1 points
    upper = np.stack([xc[::-1], yt[::-1]], axis=-1)  # m+1 points
    loop = np.concatenate([lower[:-1], upper[:-1]], axis=0)  # n_wrap points
    return loop


def omesh_naca0012(n_wrap=64, n_radial=24, radius=20.0, first_cell=2e-3,
                   span=0.1):
    """O-mesh: (points (np,3), MeshTopology).

    n_wrap x n_radial cells, 1 cell in z. Radial spacing grows
    geometrically from `first_cell` at the wall.
    """
    surf = naca0012_surface(n_wrap)                     # (nw, 2)
    center = np.array([0.5, 0.0])
    theta_s = np.unwrap(np.arctan2(surf[:, 1] - center[1],
                                   surf[:, 0] - center[0]))
    # farfield angles: blend of uniform spacing (good cell shapes in the
    # farfield) with surface angles (radial-line continuity); pure surface
    # angles inherit the cosine TE/LE clustering and produce sheared,
    # highly-skewed outer cells.
    theta_u = theta_s[0] + (theta_s[-1] - theta_s[0] +
                            (theta_s[1] - theta_s[0])) * \
        np.arange(n_wrap) / n_wrap
    theta_f = 0.75 * theta_u + 0.25 * theta_s
    far = center + radius * np.stack([np.cos(theta_f), np.sin(theta_f)], -1)

    # radial distribution: geometric clustering at the wall
    d_total = np.linalg.norm(far - surf, axis=-1).mean()
    n = n_radial
    # solve ratio r: first_cell * (r^n - 1)/(r - 1) = 1 (normalized)
    f = first_cell / d_total
    r = 1.2
    for _ in range(100):
        g = f * (r ** n - 1.0) / (r - 1.0) - 1.0
        dg = f * ((n * r ** (n - 1)) * (r - 1.0) - (r ** n - 1.0)) / (r - 1.0) ** 2
        r_new = r - g / dg
        if not np.isfinite(r_new) or r_new <= 1.0001:
            r_new = max(1.0001, (r + 1.0001) / 2)
        if abs(r_new - r) < 1e-14:
            r = r_new
            break
        r = r_new
    s = np.concatenate([[0.0], np.cumsum(f * r ** np.arange(n))])
    s = s / s[-1]                                      # (n_radial+1,)

    # algebraic radial lines
    pts2d = surf[:, None, :] * (1.0 - s[None, :, None]) \
        + far[:, None, :] * s[None, :, None]           # (nw, nr+1, 2)

    # wrap-direction smoothing of interior levels (weight grows away from
    # the wall): evens out shear without disturbing the boundary layer
    w_s = (0.5 * s[1:-1]) ** 0.75
    for _ in range(30):
        inner = pts2d[:, 1:-1, :]
        avg = 0.5 * (np.roll(inner, 1, axis=0) + np.roll(inner, -1, axis=0))
        pts2d[:, 1:-1, :] = inner + w_s[None, :, None] * (avg - inner)

    nw = n_wrap
    nr = n_radial
    npl = nw * (nr + 1)                                # points per z-plane

    def pid(i, j, k):
        return (i % nw) + nw * j + npl * k

    pts = np.zeros((2 * npl, 3))
    for k, z in enumerate((0.0, span)):
        for j in range(nr + 1):
            for i in range(nw):
                pts[pid(i, j, k)] = (pts2d[i, j, 0], pts2d[i, j, 1], z)

    def cid(i, j):
        return (i % nw) + nw * j

    internal = []
    wing, farp, zmin, zmax = [], [], [], []
    for j in range(nr):
        for i in range(nw):
            # wrap-direction face between cell (i,j) and (i+1,j): ALL internal
            # quad at wrap position i+1, normal pointing +wrap (ccw)
            v = [pid(i + 1, j, 0), pid(i + 1, j + 1, 0),
                 pid(i + 1, j + 1, 1), pid(i + 1, j, 1)]
            internal.append((v, cid(i, j), cid(i + 1, j)))
            # radial-direction face between (i,j) and (i,j+1)
            if j + 1 < nr:
                v = [pid(i, j + 1, 0), pid(i, j + 1, 1),
                     pid(i + 1, j + 1, 1), pid(i + 1, j + 1, 0)]
                internal.append((v, cid(i, j), cid(i, j + 1)))
            # boundary faces
            if j == 0:
                # airfoil wall, normal pointing INTO the airfoil (-radial)
                v = [pid(i, 0, 0), pid(i + 1, 0, 0),
                     pid(i + 1, 0, 1), pid(i, 0, 1)]
                wing.append((v, cid(i, 0)))
            if j == nr - 1:
                v = [pid(i, nr, 0), pid(i, nr, 1),
                     pid(i + 1, nr, 1), pid(i + 1, nr, 0)]
                farp.append((v, cid(i, nr - 1)))
            # z planes (normal -z and +z)
            v0 = [pid(i, j, 0), pid(i, j + 1, 0),
                  pid(i + 1, j + 1, 0), pid(i + 1, j, 0)]
            zmin.append((v0, cid(i, j)))
            v1 = [pid(i, j, 1), pid(i + 1, j, 1),
                  pid(i + 1, j + 1, 1), pid(i, j + 1, 1)]
            zmax.append((v1, cid(i, j)))

    topo = build_topology(
        n_cells=nw * nr, n_points=pts.shape[0],
        internal_faces=internal,
        patch_faces={"wing": wing, "far": farp, "zmin": zmin, "zmax": zmax},
        patch_kinds={"wing": "wall", "zmin": "empty", "zmax": "empty"},
    )
    return pts, topo
