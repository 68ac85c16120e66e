"""Static unstructured-mesh topology (host side, numpy).

A copy of ``dafoam_tpu.mesh.topology``: the arrays are plain numpy and
never live on the device, so both packages build identical topologies.
The copy exists because importing ``dafoam_tpu.mesh`` pulls in jax.

Face conventions follow OpenFOAM:
  - internal faces come first, boundary faces after, grouped per patch;
  - a face's unit normal points from ``owner`` to ``neighbour`` (outward for
    boundary faces);
  - internal faces are sorted by (owner, neighbour) upper-triangular order.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class Patch:
    """One boundary patch: a contiguous run of boundary faces.

    ``start`` indexes into the global face list (internal faces first).
    """

    name: str
    start: int
    size: int
    kind: str = "patch"  # patch | wall | empty | symmetry | processor


@dataclasses.dataclass(frozen=True, eq=False)
class MeshTopology:
    """Static mesh connectivity. All arrays are numpy (host).

    Attributes
    ----------
    n_cells       : number of cells
    n_points      : number of mesh points
    face_verts    : (n_faces, max_nv) int32 point indices per face, padded by
                    repeating the first vertex (degenerate triangles add 0)
    face_nverts   : (n_faces,) int32 true vertex count per face
    owner         : (n_faces,) int32 owner cell of every face
    neighbour     : (n_internal,) int32 neighbour cell of internal faces
    n_internal    : number of internal faces
    patches       : boundary patches, ordered, covering faces
                    [n_internal, n_faces)
    """

    n_cells: int
    n_points: int
    face_verts: np.ndarray
    face_nverts: np.ndarray
    owner: np.ndarray
    neighbour: np.ndarray
    n_internal: int
    patches: tuple[Patch, ...]

    # ---- derived sizes -------------------------------------------------
    @property
    def n_faces(self) -> int:
        return int(self.owner.shape[0])

    @property
    def n_boundary(self) -> int:
        return self.n_faces - self.n_internal

    def patch(self, name: str) -> Patch:
        for p in self.patches:
            if p.name == name:
                return p
        raise KeyError(f"no patch named {name!r}; have {[p.name for p in self.patches]}")

    def patch_slice(self, name: str) -> slice:
        """Global-face-index slice of a patch."""
        p = self.patch(name)
        return slice(p.start, p.start + p.size)

    def patch_bslice(self, name: str) -> slice:
        """Boundary-face-index slice (0 == first boundary face)."""
        p = self.patch(name)
        return slice(p.start - self.n_internal, p.start - self.n_internal + p.size)

    def boundary_owner(self) -> np.ndarray:
        return self.owner[self.n_internal:]

    def boundary_scatter_plan(self):
        """Per-patch plan for boundary<->cell movement (cached).

        2-D meshes have two "empty" plane patches with n_cells faces each.
        A patch whose owners are the identity is folded with a plain
        vector add, one whose owners are a permutation of the cells with
        the inverse-permutation gather; other (small, physical) patches
        keep an indexed scatter.

        Returns a list of (mode, bstart, size, idx): mode "identity" (idx
        None), "perm" with idx = inverse permutation (cell -> patch-face),
        or "scatter" with idx = owner cells of the patch's faces.
        """
        cached = getattr(self, "_bscatter_plan", None)
        if cached is not None:
            return cached
        ni = self.n_internal
        plan = []
        for p in self.patches:
            own_p = self.owner[p.start:p.start + p.size]
            b0 = p.start - ni
            if p.size == self.n_cells and \
                    np.array_equal(own_p, np.arange(self.n_cells)):
                plan.append(("identity", b0, p.size, None))
            elif p.size == self.n_cells and \
                    np.array_equal(np.sort(own_p), np.arange(self.n_cells)):
                inv = np.empty(self.n_cells, dtype=np.int32)
                inv[own_p] = np.arange(p.size, dtype=np.int32)
                plan.append(("perm", b0, p.size, inv))
            else:
                plan.append(("scatter", b0, p.size, own_p.astype(np.int32)))
        object.__setattr__(self, "_bscatter_plan", plan)
        return plan

    def ell(self):
        """Gather-form (ELL) cell-to-face adjacency.

        For each cell, up to K incident internal faces with (face id,
        neighbour cell, owner? flag). Padded rows point at face 0 with
        weight 0. Cached on first use (static topology).

        Returns (face_id (nc,K) i32, col (nc,K) i32, is_owner (nc,K) f64
        in {0,1}, valid (nc,K) f64).
        """
        cached = getattr(self, "_ell_cache", None)
        if cached is not None:
            return cached
        nc = self.n_cells
        ni = self.n_internal
        own = self.owner[:ni]
        nei = self.neighbour
        deg = np.zeros(nc, dtype=np.int64)
        np.add.at(deg, own, 1)
        np.add.at(deg, nei, 1)
        K = int(deg.max()) if nc else 0
        face_id = np.zeros((nc, K), dtype=np.int32)
        col = np.zeros((nc, K), dtype=np.int32)
        is_owner = np.zeros((nc, K), dtype=np.float64)
        valid = np.zeros((nc, K), dtype=np.float64)
        slot = np.zeros(nc, dtype=np.int64)
        for f in range(ni):
            c, d = own[f], nei[f]
            s = slot[c]
            face_id[c, s], col[c, s], is_owner[c, s], valid[c, s] = f, d, 1.0, 1.0
            slot[c] += 1
            s = slot[d]
            face_id[d, s], col[d, s], is_owner[d, s], valid[d, s] = f, c, 0.0, 1.0
            slot[d] += 1
        object.__setattr__(self, "_ell_cache",
                           (face_id, col, is_owner, valid))
        return self._ell_cache

    def dia_dense(self):
        """Dense offset-major internal-face layout metadata, or None.

        Set by ``to_dia_dense``: internal face ``i*nc + c`` connects cell
        ``c`` to ``c + offsets[i]`` when ``valid[i, c]``; invalid slots are
        DEGENERATE faces (zero area) whose contributions vanish through the
        geometry weighting of every FV operator. With this layout all
        cell<->face movement is broadcasts and static shifts.

        Returns (offsets tuple[int], valid (K, nc) float64) or None.
        """
        return getattr(self, "_dia_dense", None)

    def dia(self, max_offsets: int = 64):
        """Banded (DIA) structure for the LDU matvec.

        Returns (offsets (n_off,), face_idx (n_off, nc) i32, kind (n_off,
        nc) i8) with kind 1 = owner row (coeff = upper[face]), 2 =
        neighbour row (coeff = lower[face]), 0 = empty. The coefficient
        gather happens once per assembled matrix; every matvec after it is
        diag*x + sum_o coef_o * shift(x, o). Returns None when the mesh has
        more distinct diagonals than max_offsets.
        """
        cached = getattr(self, "_dia_cache", "missing")
        if cached != "missing":
            return cached
        dd = self.dia_dense()
        if dd is not None:
            # synthesize directly from the dense layout: face i*nc+c sits
            # at (offset_i, cell c) for owner rows and
            # (-offset_i, cell c+offset_i) for neighbour rows; padded slots
            # carry zero coefficients so kind=1 everywhere is safe.
            offs, valid = dd
            nc = self.n_cells
            uniq = np.asarray(sorted(set(offs) | {-o for o in offs}),
                              dtype=np.int64)
            face_idx = np.zeros((uniq.size, nc), dtype=np.int32)
            kind = np.zeros((uniq.size, nc), dtype=np.int8)
            pos = {int(o): i for i, o in enumerate(uniq)}
            base = np.arange(nc, dtype=np.int32)
            for i, o in enumerate(offs):
                face_idx[pos[o]] = i * nc + base
                kind[pos[o]] = 1
                j = pos[-o]
                face_idx[j, o:] = i * nc + base[:nc - o]
                kind[j, o:] = 2
            result = (uniq, face_idx, kind)
            object.__setattr__(self, "_dia_cache", result)
            return result
        nc = self.n_cells
        ni = self.n_internal
        own = self.owner[:ni].astype(np.int64)
        nei = self.neighbour.astype(np.int64)
        offs_all = np.concatenate([nei - own, own - nei])
        uniq = np.unique(offs_all)
        result = None
        if uniq.size <= max_offsets:
            off_of = {int(o): i for i, o in enumerate(uniq)}
            face_idx = np.zeros((uniq.size, nc), dtype=np.int32)
            kind = np.zeros((uniq.size, nc), dtype=np.int8)
            ok = True
            for f in range(ni):
                c, d = own[f], nei[f]
                i = off_of[int(d - c)]
                j = off_of[int(c - d)]
                if kind[i, c] or kind[j, d]:   # duplicate face between pair
                    ok = False
                    break
                face_idx[i, c], kind[i, c] = f, 1      # owner row, upper
                face_idx[j, d], kind[j, d] = f, 2      # neighbour row, lower
            if ok:
                result = (uniq.astype(np.int64), face_idx, kind)
        object.__setattr__(self, "_dia_cache", result)
        return result

    def validate(self) -> None:
        nf = self.n_faces
        if self.face_verts.shape[0] != nf or self.face_nverts.shape[0] != nf:
            raise ValueError("face arrays do not cover every face")
        if self.neighbour.shape[0] != self.n_internal:
            raise ValueError("neighbour must cover the internal faces")
        for arr in (self.owner, self.neighbour):
            if (arr < 0).any() or (arr >= self.n_cells).any():
                raise ValueError("cell index out of range")
        cover = 0
        for p in self.patches:
            if p.start != self.n_internal + cover:
                raise ValueError(f"patch {p.name} does not follow its "
                                 "predecessor")
            cover += p.size
        if cover != self.n_boundary:
            raise ValueError("patches do not cover the boundary faces")


def build_topology(n_cells: int, n_points: int, internal_faces,
                   patch_faces, patch_kinds=None) -> MeshTopology:
    """Canonicalize a raw face soup into a MeshTopology.

    internal_faces: list of (verts, owner, neighbour) with normal pointing
    owner->neighbour (will be flipped/sorted into canonical order);
    patch_faces: {name: [(verts, owner)]} with outward normals, in the
    order patches should be laid out.
    """
    patch_kinds = patch_kinds or {}
    fixed = []
    for verts, own, nei in internal_faces:
        if own > nei:
            verts = list(verts)[::-1]
            own, nei = nei, own
        fixed.append((verts, own, nei))
    fixed.sort(key=lambda t: (t[1], t[2]))

    all_verts = [f[0] for f in fixed]
    owner = [f[1] for f in fixed]
    neighbour = [f[2] for f in fixed]
    n_internal = len(fixed)

    patches = []
    start = n_internal
    for name, faces in patch_faces.items():
        patches.append(Patch(name=name, start=start, size=len(faces),
                             kind=patch_kinds.get(name, "patch")))
        for verts, own in faces:
            all_verts.append(list(verts))
            owner.append(own)
        start += len(faces)

    max_nv = max(len(v) for v in all_verts)
    fv = np.zeros((len(all_verts), max_nv), dtype=np.int32)
    fn = np.zeros((len(all_verts),), dtype=np.int32)
    for i, v in enumerate(all_verts):
        fv[i, : len(v)] = v
        fv[i, len(v):] = v[0]
        fn[i] = len(v)

    topo = MeshTopology(
        n_cells=n_cells,
        n_points=n_points,
        face_verts=fv,
        face_nverts=fn,
        owner=np.asarray(owner, dtype=np.int32),
        neighbour=np.asarray(neighbour, dtype=np.int32),
        n_internal=n_internal,
        patches=tuple(patches),
    )
    topo.validate()
    return topo


def renumber_rcm(topo: MeshTopology) -> np.ndarray:
    """Reverse Cuthill–McKee cell ordering for the cell adjacency graph.

    Returns ``perm`` with ``perm[new] = old``.
    """
    n = topo.n_cells
    own = topo.owner[: topo.n_internal]
    nei = topo.neighbour
    # adjacency in CSR
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, own, 1)
    np.add.at(deg, nei, 1)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=ptr[1:])
    adj = np.empty(ptr[-1], dtype=np.int64)
    fill = ptr[:-1].copy()
    for a, b in ((own, nei), (nei, own)):
        for i in range(a.shape[0]):
            adj[fill[a[i]]] = b[i]
            fill[a[i]] += 1
    visited = np.zeros(n, dtype=bool)
    order: list[int] = []
    deg_order = np.argsort(deg, kind="stable")
    for seed in deg_order:
        if visited[seed]:
            continue
        queue = [int(seed)]
        visited[seed] = True
        qi = 0
        while qi < len(queue):
            c = queue[qi]
            qi += 1
            order.append(c)
            nbrs = sorted(adj[ptr[c]:ptr[c + 1]].tolist(), key=lambda x: deg[x])
            for nb in nbrs:
                if not visited[nb]:
                    visited[nb] = True
                    queue.append(nb)
    return np.array(order[::-1], dtype=np.int64)  # reverse CM


def apply_cell_permutation(topo: MeshTopology, perm: np.ndarray) -> MeshTopology:
    """Relabel cells with ``perm[new] = old`` and restore canonical face order.

    Internal faces are re-sorted into upper-triangular (owner, neighbour)
    order with owner < neighbour (flipping face orientation where needed);
    boundary faces keep their patch-relative order.
    """
    n = topo.n_cells
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)

    own = inv[topo.owner].astype(np.int32)
    nei_i = inv[topo.neighbour].astype(np.int32)
    own_i = own[: topo.n_internal].copy()

    face_verts = topo.face_verts.copy()
    face_nverts = topo.face_nverts.copy()

    flip = own_i > nei_i
    own_i2 = np.where(flip, nei_i, own_i)
    nei_i2 = np.where(flip, own_i, nei_i)
    # flip vertex order of flipped faces so the normal still points owner->nei
    for f in np.nonzero(flip)[0]:
        k = face_nverts[f]
        face_verts[f, :k] = face_verts[f, :k][::-1]
        # padding slots must repeat slot 0 (geometry relies on it when
        # subtracting pad contributions from face-centre sums)
        face_verts[f, k:] = face_verts[f, 0]

    key = own_i2.astype(np.int64) * n + nei_i2.astype(np.int64)
    forder = np.argsort(key, kind="stable")

    new_owner = np.concatenate([own_i2[forder], own[topo.n_internal:]])
    new_nei = nei_i2[forder]
    fv = np.concatenate([face_verts[: topo.n_internal][forder], face_verts[topo.n_internal:]])
    fn = np.concatenate([face_nverts[: topo.n_internal][forder], face_nverts[topo.n_internal:]])

    out = MeshTopology(
        n_cells=n,
        n_points=topo.n_points,
        face_verts=fv,
        face_nverts=fn,
        owner=new_owner.astype(np.int32),
        neighbour=new_nei.astype(np.int32),
        n_internal=topo.n_internal,
        patches=topo.patches,
    )
    out.validate()
    return out


def to_dia_dense(topo: MeshTopology, max_offsets: int = 16):
    """Repack internal faces into the dense offset-major DIA layout.

    New internal face ``i*nc + c`` is the face connecting cell ``c`` to
    ``c + offsets[i]`` (owner-canonical), or a DEGENERATE zero-area face
    (all vertices = point 0) when that pair is not connected. Degenerate
    faces contribute exactly zero to every FV operator because all face
    coefficients are proportional to the face area / flux. Boundary faces
    are unchanged (patch starts shift by the internal-face padding).

    Returns the new MeshTopology (with ``dia_dense()`` metadata and
    ``face_map_old2new`` for converting face arrays) or None when the mesh
    is not banded with <= max_offsets distinct diagonals.
    """
    nc, ni = topo.n_cells, topo.n_internal
    own = topo.owner[:ni].astype(np.int64)
    nei = topo.neighbour.astype(np.int64)
    offs = np.unique(nei - own)
    if offs.size > max_offsets or (offs <= 0).any():
        return None
    K = offs.size
    pos = {int(o): i for i, o in enumerate(offs)}
    # detect duplicate faces between a cell pair (non-simple graph)
    taken = np.zeros((K, nc), dtype=bool)
    new_of_old = np.empty(ni, dtype=np.int64)
    for f in range(ni):
        i = pos[int(nei[f] - own[f])]
        if taken[i, own[f]]:
            return None
        taken[i, own[f]] = True
        new_of_old[f] = i * nc + own[f]
    valid = taken.astype(np.float64)

    n_dense = K * nc
    maxnv = topo.face_verts.shape[1]
    fv = np.zeros((n_dense + topo.n_boundary, maxnv), dtype=np.int32)
    fn = np.full((n_dense + topo.n_boundary,), 3, dtype=np.int32)
    owner_new = np.empty(n_dense + topo.n_boundary, dtype=np.int32)
    nei_new = np.empty(n_dense, dtype=np.int32)
    cells = np.arange(nc, dtype=np.int64)
    for i, o in enumerate(offs):
        owner_new[i * nc: (i + 1) * nc] = cells
        nei_new[i * nc: (i + 1) * nc] = np.minimum(cells + int(o), nc - 1)
    # owner<neighbour must hold: clamp the tail's neighbour is == owner for
    # c >= nc-o; bump owner to keep own<nei on those (they are invalid
    # zero-area faces; indices only need to be in range and distinct)
    bad = owner_new[:n_dense] >= nei_new
    owner_new[:n_dense][bad] = 0
    nei_new[bad] = 1
    fv[new_of_old] = topo.face_verts[:ni]
    fn[new_of_old] = topo.face_nverts[:ni]
    owner_new[new_of_old] = topo.owner[:ni]
    nei_new[new_of_old] = topo.neighbour
    # boundary block unchanged
    fv[n_dense:] = topo.face_verts[ni:]
    fn[n_dense:] = topo.face_nverts[ni:]
    owner_new[n_dense:] = topo.owner[ni:]
    shift = n_dense - ni
    patches = tuple(Patch(name=p.name, start=p.start + shift, size=p.size,
                          kind=p.kind) for p in topo.patches)

    out = MeshTopology(
        n_cells=nc, n_points=topo.n_points,
        face_verts=fv, face_nverts=fn,
        owner=owner_new, neighbour=nei_new,
        n_internal=n_dense, patches=patches)
    out.validate()
    object.__setattr__(out, "_dia_dense",
                       (tuple(int(o) for o in offs), valid))
    face_map = np.concatenate(
        [new_of_old, np.arange(ni, topo.n_faces) + shift])
    object.__setattr__(out, "face_map_old2new", face_map)
    return out


def from_dia_dense(topo: MeshTopology) -> MeshTopology:
    """The canonical topology a dense-DIA one was built from.

    ``to_dia_dense`` keeps ``face_map_old2new``; gathering every face array
    through it drops the degenerate padded faces and restores the
    canonical internal-face order and patch starts. A topology without the
    dense layout is returned as it is.
    """
    if topo.dia_dense() is None:
        return topo
    fmap = getattr(topo, "face_map_old2new", None)
    if fmap is None:
        raise ValueError("dense-DIA topology without face_map_old2new")
    ni = fmap.shape[0] - topo.n_boundary
    shift = topo.n_internal - ni
    out = MeshTopology(
        n_cells=topo.n_cells, n_points=topo.n_points,
        face_verts=topo.face_verts[fmap], face_nverts=topo.face_nverts[fmap],
        owner=topo.owner[fmap], neighbour=topo.neighbour[fmap[:ni]],
        n_internal=ni,
        patches=tuple(Patch(name=p.name, start=p.start - shift, size=p.size,
                            kind=p.kind) for p in topo.patches))
    out.validate()
    return out
