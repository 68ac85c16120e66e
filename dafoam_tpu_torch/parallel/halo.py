"""Halo-exchange LDU matvec over partition blocks.

Port of ``dafoam_tpu.parallel.halo``. The reference's MPI decomposition
handles cross-processor faces through coupled processor patches inside
every fvm/fvc operator (DAJacCon.H:100-109); here, as in dafoam_tpu:

- cells are relabelled into contiguous per-partition blocks
  (``parallel.partition.reorder_for_partitions``);
- every cut face is DUPLICATED on both incident partitions (the OpenFOAM
  processor-patch trick): the owner partition applies it to the owner
  row, the neighbour partition (ghost copy) applies it to the neighbour
  row, so after one bidirectional exchange of cell values, and of the
  ghost faces' ``lower`` coefficients, every row sum is local;
- the halo exchange is one message per partition distance and direction:
  its volume is proportional to the cut, not to the domain.

``HaloMatvec`` has two transports of the same plan:

- local (``group=None``): all P partitions live in one process on one
  device, held as (P, .) blocks; the exchange of every distance and
  direction is one index gather between blocks (cells, and the ghost
  faces' coefficients). Autograd and ``torch.autograd.forward_ad`` go
  through its plain tensor operations;
- distributed (``group``: a ``torch.distributed`` process group of P
  ranks, one partition each; NCCL for CUDA tensors, gloo on the CPU): the
  exchange is ``batch_isend_irecv`` in one autograd Function whose
  backward sends the cotangents back along the reversed permutation and
  whose jvp exchanges the tangent. Operands and output are REPLICATED:
  every rank passes the global (diag, lower, upper, x) and gets the global
  y, assembled by an all-gather of the blocks; every rank's gradients and
  tangents equal the one-process product's. Keeping them replicated costs
  more than the halo: each product all-gathers the whole y (every rank
  receives n_cells - n_cells/P values) and each vjp all-reduces
  full-size cotangents of diag, lower, upper and x, so this transport's
  traffic per product is O(n_cells), not O(cut).

The local product of a partition is ``d*x + index_add(coeff[src] *
ext[col] * valid, row)`` over its entry table, as the reference's
``segment_sum``; it stays plain torch.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist


class HaloPlan(NamedTuple):
    """Static decomposition plan (numpy, host). Per-partition tables are
    padded to common sizes and stacked with a leading partition axis;
    padded slots point at index 0 (``valid`` 0 for entries)."""

    n_shards: int
    n_cells: int
    ncl: int                  # cells per partition
    nfl: int                  # owned internal faces per partition (padded)
    ext_size: int             # local cells + all halo buffers
    dists: tuple              # partition distances with cut faces
    # cell halo: FORWARD (owner needs x[nei]): partition q sends x[fsend]
    # to q-d; BACKWARD (ghost/neighbour partition needs x[own]): q sends
    # x[bsend] to q+d
    cell_send_fwd: tuple      # per-distance (P, Hf) int32 local cell idx
    cell_send_bwd: tuple      # per-distance (P, Hb) int32
    # face-coeff halo: ghost faces need `lower` of owner-partition faces
    face_send: tuple          # per-distance (P, Fh) int32 local FACE idx
    face_pack: np.ndarray     # (P, nfl) int64 global internal-face id
    # matvec entries: y[row] += coeff_ext[src] * x_ext[col] * valid
    row: np.ndarray           # (P, E) int32
    col: np.ndarray           # (P, E) int32
    src: np.ndarray           # (P, E) int32
    valid: np.ndarray         # (P, E) float64
    cut_faces: int            # total cut faces (comm volume diagnostic)


def _group_positions(group, n_groups):
    """Rank of each item within its group, items taken in the given order:
    (position per item, count per group)."""
    order = np.argsort(group, kind="stable")
    counts = np.bincount(group, minlength=n_groups)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.empty(group.size, dtype=np.int64)
    pos[order] = np.arange(group.size) - np.repeat(starts, counts)
    return pos, counts


def _table(group, pos, values, n_groups, width, dtype=np.int32):
    """(n_groups, max(1, width)) table with values[i] at (group[i],
    pos[i]) and 0 in the padded slots."""
    t = np.zeros((n_groups, max(1, width)), dtype=dtype)
    t[group, pos] = values
    return t


def _send_list(shard, cells, n_shards, n_cells, ncl):
    """Per-shard sorted distinct ``cells`` (one distance's send list):
    the padded table of local cell indices, and each item's position in
    its shard's list."""
    uniq, inv = np.unique(shard * n_cells + cells, return_inverse=True)
    ushard, ucell = uniq // n_cells, uniq % n_cells
    upos, counts = _group_positions(ushard, n_shards)
    width = int(counts.max()) if counts.size else 0
    table = _table(ushard, upos, ucell - ushard * ncl, n_shards, width)
    return table, upos[inv.reshape(-1)]


def build_halo_plan(topo, n_shards: int) -> HaloPlan:
    """Cells must already be relabelled into contiguous partition blocks
    (reorder_for_partitions) with n_cells % n_shards == 0.

    The same arrays as dafoam_tpu's per-face loops, built with numpy."""
    nc, ni = topo.n_cells, topo.n_internal
    Pn = int(n_shards)
    if nc % Pn:
        raise ValueError(f"n_cells {nc} not divisible by {Pn} partitions")
    ncl = nc // Pn
    own = topo.owner[:ni].astype(np.int64)
    nei = topo.neighbour.astype(np.int64)
    po, pn = own // ncl, nei // ncl
    if not (po <= pn).all():
        raise ValueError("faces must be owner-sorted upper-triangular "
                         "(a canonical, partition-reordered topology)")
    dist_f = pn - po
    cut = np.nonzero(dist_f)[0]
    dists = [int(d) for d in np.unique(dist_f[cut])]

    # ---- per-partition owned-face blocks -------------------------------
    jloc, nface = _group_positions(po, Pn)
    nfl = max(1, int(nface.max()) if nface.size else 0)
    face_pack = _table(po, jloc, np.arange(ni), Pn, nfl, np.int64)

    # ---- halo send lists and the positions of each cut face in them ----
    cell_send_fwd, cell_send_bwd, face_send = [], [], []
    hpos, bpos, gpos = {}, {}, {}
    for d in dists:
        sel = cut[dist_f[cut] == d]                  # in face order
        t, hpos[d] = _send_list(pn[sel], nei[sel], Pn, nc, ncl)
        cell_send_fwd.append(t)
        t, bpos[d] = _send_list(po[sel], own[sel], Pn, nc, ncl)
        cell_send_bwd.append(t)
        gpos[d], cnt = _group_positions(po[sel], Pn)
        face_send.append(_table(po[sel], gpos[d], jloc[sel], Pn,
                                int(cnt.max())))

    # ext cell layout: [local | fwd(d1) | fwd(d2)... | bwd(d1) | bwd(d2)...]
    off = ncl
    fwd_off, bwd_off = {}, {}
    for d, a in zip(dists, cell_send_fwd):
        fwd_off[d] = off
        off += a.shape[1]
    for d, a in zip(dists, cell_send_bwd):
        bwd_off[d] = off
        off += a.shape[1]
    ext_size = off
    # coeff ext layout: [upper_local | lower_local | lower_halo(d1) | ...]
    fcoef_off, off2 = {}, 2 * nfl
    for d, a in zip(dists, face_send):
        fcoef_off[d] = off2
        off2 += a.shape[1]

    # ---- entry table: per partition, by face, then owner row first -----
    inner = np.nonzero(dist_f == 0)[0]
    o_l, n_l = own - po * ncl, nei - po * ncl
    parts = [(po[inner], inner, 0, o_l[inner], n_l[inner], jloc[inner]),
             (po[inner], inner, 1, n_l[inner], o_l[inner],
              nfl + jloc[inner])]
    for d in dists:
        sel = cut[dist_f[cut] == d]
        parts.append((po[sel], sel, 0, o_l[sel], fwd_off[d] + hpos[d],
                      jloc[sel]))                        # owner row
        parts.append((pn[sel], sel, 0, nei[sel] - pn[sel] * ncl,
                      bwd_off[d] + bpos[d],
                      fcoef_off[d] + gpos[d]))           # ghost copy on pn
    shard, face, kind, row, col, src = (
        np.concatenate([np.broadcast_to(np.asarray(p[i]), p[1].shape)
                        for p in parts]) for i in range(6))
    order = np.lexsort((kind, face, shard))
    shard = shard[order]
    epos, ecount = _group_positions(shard, Pn)
    E = max(1, int(ecount.max()) if ecount.size else 0)
    tabs = [_table(shard, epos, a[order], Pn, E) for a in (row, col, src)]
    valid = _table(shard, epos, 1.0, Pn, E, np.float64)

    return HaloPlan(n_shards=Pn, n_cells=nc, ncl=ncl, nfl=nfl,
                    ext_size=ext_size, dists=tuple(dists),
                    cell_send_fwd=tuple(cell_send_fwd),
                    cell_send_bwd=tuple(cell_send_bwd),
                    face_send=tuple(face_send), face_pack=face_pack,
                    row=tabs[0], col=tabs[1], src=tabs[2], valid=valid,
                    cut_faces=int(len(cut)))


def exchanged_values(plan: HaloPlan, n_comp: int = 1) -> int:
    """Values one product moves between partitions, padded slots
    included: each distance's cell sends in both directions (``n_comp``
    components per cell) and its ghost-face coefficients."""
    n = 0
    for d, f, b, c in zip(plan.dists, plan.cell_send_fwd,
                          plan.cell_send_bwd, plan.face_send):
        links = plan.n_shards - d
        n += links * ((f.shape[1] + b.shape[1]) * n_comp + c.shape[1])
    return n


def _long(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int64,
                           device=device)


class HaloMatvec:
    """Partitioned LDU matvec y = diag*x + offdiag@x with an explicit halo
    exchange: the multi-device product of the primal smoothers and the
    adjoint Krylov solves (reference dRdWTMatVecMultFunction,
    DASolver.C:1364, whose MPI halo the differentiated Pstream handles).

        hm = HaloMatvec(topo, n_parts, device="cuda")   # local transport
        hm = HaloMatvec(topo, n_parts, device=dev, group=pg)  # one rank each
        y = hm(diag, lower, upper, x)                   # global tensors

    diag is (nc,) or (nc, C), x (nc,) or (nc, C). Differentiable in all
    four in both AD modes. ``calls`` counts the products.
    """

    def __init__(self, topo, n_parts: int, device="cuda", group=None):
        self.plan = build_halo_plan(topo, n_parts)
        self.n_parts = int(n_parts)
        self.group = group
        self.calls = 0
        self._valid = {}
        p = self.plan
        if group is None:
            self.device = self.device_of(device)
            self.rank = None
            self._local_tables(p)
            return
        kind = torch.device(device).type
        backend = str(dist.get_backend(group)).lower()
        want = "nccl" if kind == "cuda" else "gloo"
        if backend != want:
            raise ValueError(f"{kind} operands need a {want} process group, "
                             f"not {backend}")
        self.device = self.device_of(device)
        if dist.get_world_size(group) != self.n_parts:
            raise ValueError(f"the group has {dist.get_world_size(group)} "
                             f"ranks for {self.n_parts} partitions")
        self.rank = dist.get_rank(group)
        self._peers = [dist.get_global_rank(group, r)
                       for r in range(self.n_parts)]
        self._rank_tables(p)

    @staticmethod
    def device_of(device):
        """``device`` with the current CUDA index filled in."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return device

    # ---- tables ----------------------------------------------------------
    def _local_tables(self, p):
        """The local transport's tables. Every receive buffer slot of the
        ext layouts names its source in the flat (P * ncl) cells or (P *
        nfl) packed faces: the sender's table entry, or one zero slot past
        the end where no partition sends (r + d >= P forward, r - d < 0
        backward), as the reference's ppermute fills it. The exchange of
        all distances is then one gather per layout."""
        dev, P = self.device, p.n_shards
        ncoef = 2 * p.nfl + sum(a.shape[1] for a in p.face_send)
        r = np.arange(P)[:, None]

        def sources(tables, n, above):
            cols = []
            for d, a in zip(p.dists, tables):
                q = r + d if above else r - d            # the sender
                ok = (q >= 0) & (q < P)
                qc = np.clip(q, 0, P - 1)
                cols.append(np.where(ok, qc * n + a[qc[:, 0]], P * n))
            return np.concatenate(cols, axis=1) if cols else \
                np.zeros((P, 0), dtype=np.int64)

        cells = np.concatenate([sources(p.cell_send_fwd, p.ncl, True),
                                sources(p.cell_send_bwd, p.ncl, False)],
                               axis=1)
        faces = sources(p.face_send, p.nfl, False)
        self._halo_cells = _long(cells.ravel(), dev)
        self._halo_faces = _long(faces.ravel(), dev)
        self._widths = (cells.shape[1], faces.shape[1])
        self._pack = _long(p.face_pack.ravel(), dev)
        self._row = _long((p.row + r * p.ncl).ravel(), dev)
        self._col = _long((p.col + r * p.ext_size).ravel(), dev)
        self._src = _long((p.src + r * ncoef).ravel(), dev)
        self._valid_np = p.valid.ravel()

    def _rank_tables(self, p):
        dev, r = self.device, self.rank
        self._own = torch.arange(r * p.ncl, (r + 1) * p.ncl, device=dev)
        self._pack = _long(p.face_pack[r], dev)
        self._fwd = [(d, _long(a[r], dev)) for d, a in
                     zip(p.dists, p.cell_send_fwd)]
        self._bwd = [(d, _long(a[r], dev)) for d, a in
                     zip(p.dists, p.cell_send_bwd)]
        self._fsd = [(d, _long(a[r], dev)) for d, a in
                     zip(p.dists, p.face_send)]
        self._row = _long(p.row[r], dev)
        self._col = _long(p.col[r], dev)
        self._src = _long(p.src[r], dev)
        self._valid_np = p.valid[r]

    def _valid_as(self, dtype):
        v = self._valid.get(dtype)
        if v is None:
            v = torch.as_tensor(self._valid_np, dtype=dtype,
                                device=self.device)
            self._valid[dtype] = v
        return v

    # ---- the product -----------------------------------------------------
    def __call__(self, diag, lower, upper, x):
        for t in (diag, lower, upper, x):
            if t.device != self.device:
                raise ValueError(f"operand on {t.device}; this halo matvec "
                                 f"holds its tables on {self.device}")
        self.calls += 1
        if self.rank is None:
            return self._local(diag, lower, upper, x)
        return self._distributed(diag, lower, upper, x)

    def _entries(self, d_l, x_l, ext, coeff, n_rows):
        """d*x + sum over the entry table, rows numbered 0..n_rows-1."""
        w = coeff.index_select(0, self._src) * self._valid_as(coeff.dtype)
        xv = ext.index_select(0, self._col)
        if xv.ndim > 1:                       # (nc, C) vector fields
            w = w.reshape(w.shape + (1,) * (xv.ndim - 1))
        acc = xv.new_zeros((n_rows,) + xv.shape[1:]).index_add(
            0, self._row, w * xv)
        if d_l.ndim < x_l.ndim:
            d_l = d_l[..., None]
        return d_l * x_l + acc

    def _local(self, diag, lower, upper, x):
        p = self.plan
        P, extra = p.n_shards, x.shape[1:]
        hx, hf = self._widths
        xz = torch.cat([x, x.new_zeros((1,) + extra)])
        halo = xz.index_select(0, self._halo_cells).reshape(
            (P, hx) + extra)
        ext = torch.cat([x.reshape((P, p.ncl) + extra), halo], dim=1)
        lo2 = lower.index_select(0, self._pack)
        up2 = upper.index_select(0, self._pack)
        cb = torch.cat([lo2, lo2.new_zeros(1)]).index_select(
            0, self._halo_faces).reshape(P, hf)
        coeff = torch.cat([up2.reshape(P, p.nfl), lo2.reshape(P, p.nfl), cb],
                          dim=1)
        return self._entries(diag, x, ext.reshape((-1,) + extra),
                             coeff.reshape(-1), x.shape[0])

    def _distributed(self, diag, lower, upper, x):
        g = self.group
        x_l = _TakeOwn.apply(x, self._own, g)
        d_l = _TakeOwn.apply(diag, self._own, g)
        lo_l = _TakeOwn.apply(lower, self._pack, g)
        up_l = _TakeOwn.apply(upper, self._pack, g)
        xb, cb = _Exchange.apply(x_l, lo_l, self)
        y_l = self._entries(d_l, x_l, torch.cat([x_l, xb]),
                            torch.cat([up_l, lo_l, cb]), self.plan.ncl)
        return _GatherBlocks.apply(y_l, self)

    # ---- the distributed transport -----------------------------------------
    def _links(self):
        """(kind, tag, send table, peer sent to, peer received from) of
        every exchange, in one order on every rank; peers outside the
        group are None."""
        r, P = self.rank, self.n_parts
        peer = lambda q: q if 0 <= q < P else None  # noqa: E731
        out = []
        for i, (d, s) in enumerate(self._fwd):      # x[nei] -> owner part
            out.append(("x", 3 * i, s, peer(r - d), peer(r + d)))
        for i, (d, s) in enumerate(self._bwd):      # x[own] -> ghost part
            out.append(("x", 3 * i + 1, s, peer(r + d), peer(r - d)))
        for i, (d, s) in enumerate(self._fsd):      # lower -> ghost part
            out.append(("f", 3 * i + 2, s, peer(r + d), peer(r - d)))
        return out

    def _p2p(self, sends, recvs):
        """Post every (tensor, peer, tag) send and receive in one batch
        and wait for all of them."""
        ops = [dist.P2POp(dist.isend, t, self._peers[q], self.group, tag)
               for t, q, tag in sends]
        ops += [dist.P2POp(dist.irecv, t, self._peers[q], self.group, tag)
                for t, q, tag in recvs]
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()

    def exchange(self, x_l, lo_l):
        """Forward exchange: (cell buffers, ghost-face coefficient
        buffers) in the ext layouts, zeros where no partition sends."""
        sends, recvs, xb, cb = [], [], [], []
        for kind, tag, s, to, frm in self._links():
            v = x_l if kind == "x" else lo_l
            buf = v.new_zeros((s.shape[0],) + v.shape[1:])
            if to is not None:
                sends.append((v.index_select(0, s).contiguous(), to, tag))
            if frm is not None:
                recvs.append((buf, frm, tag))
            (xb if kind == "x" else cb).append(buf)
        self._p2p(sends, recvs)
        return (torch.cat(xb) if xb else x_l.new_zeros((0,) + x_l.shape[1:]),
                torch.cat(cb) if cb else lo_l.new_zeros(0))

    def exchange_back(self, gxb, gcb, x_shape, lo_shape):
        """Reverse exchange: each received buffer's cotangent goes back to
        its sender, which adds it into the rows it sent."""
        gx = gxb.new_zeros(x_shape)
        glo = gcb.new_zeros(lo_shape)
        sends, recvs, adds = [], [], []
        ox = oc = 0
        for kind, tag, s, to, frm in self._links():
            n = s.shape[0]
            if kind == "x":
                chunk, ox = gxb[ox:ox + n], ox + n
                acc = gx
            else:
                chunk, oc = gcb[oc:oc + n], oc + n
                acc = glo
            if frm is not None:
                sends.append((chunk.contiguous(), frm, tag))
            if to is not None:
                buf = chunk.new_empty(chunk.shape)
                recvs.append((buf, to, tag))
                adds.append((acc, s, buf))
        self._p2p(sends, recvs)
        for acc, s, buf in adds:
            acc.index_add_(0, s, buf)
        return gx, glo


class _TakeOwn(torch.autograd.Function):
    """A rank's rows of a replicated tensor. Backward: the sum over ranks
    of each rank's cotangent scattered into its rows (disjoint, so the sum
    is exact and the gradient is replicated, not scaled by P)."""

    @staticmethod
    def forward(full, idx, group):
        return full.index_select(0, idx)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.idx, ctx.group, ctx.shape = inputs[1], inputs[2], inputs[0].shape

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape).index_add_(0, ctx.idx, g)
        dist.all_reduce(out, group=ctx.group)
        return out, None, None

    @staticmethod
    def jvp(ctx, t, _idx, _group):
        return t.index_select(0, ctx.idx)


class _Exchange(torch.autograd.Function):
    """The halo exchange of one product (``HaloMatvec.exchange``): cell
    values both ways and the ghost faces' lower coefficients, one P2P
    message per distance and direction. Backward: the reverse exchange;
    jvp: the same exchange of the tangents."""

    @staticmethod
    def forward(x_l, lo_l, hm):
        return hm.exchange(x_l, lo_l)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x_l, lo_l, ctx.hm = inputs
        ctx.shapes = (x_l.shape, lo_l.shape)
        ctx.like = (x_l.new_empty(0), lo_l.new_empty(0))

    @staticmethod
    def backward(ctx, gxb, gcb):
        gx, glo = ctx.hm.exchange_back(gxb, gcb, *ctx.shapes)
        return gx, glo, None

    @staticmethod
    def jvp(ctx, tx, tlo, _hm):
        (xs, ls), (xl, ll) = ctx.shapes, ctx.like
        tx = xl.new_zeros(xs) if tx is None else tx
        tlo = ll.new_zeros(ls) if tlo is None else tlo
        return ctx.hm.exchange(tx, tlo)


class _GatherBlocks(torch.autograd.Function):
    """The replicated y: an all-gather of every rank's block. Backward:
    the rank's own block of the (replicated) cotangent; jvp: the
    all-gather of the tangent blocks."""

    @staticmethod
    def forward(y_l, hm):
        return _all_gather(y_l, hm)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.hm = inputs[1]

    @staticmethod
    def backward(ctx, g):
        hm = ctx.hm
        n = hm.plan.ncl
        return g[hm.rank * n:(hm.rank + 1) * n].clone(), None

    @staticmethod
    def jvp(ctx, t, _hm):
        return _all_gather(t, ctx.hm)


def _all_gather(y_l, hm):
    y_l = y_l.contiguous()
    parts = [torch.empty_like(y_l) for _ in range(hm.n_parts)]
    dist.all_gather(parts, y_l, group=hm.group)
    return torch.cat(parts)


def assert_replicated(tensors, group, what="state"):
    """Raise unless every rank holds bit-identical ``tensors``: the check
    that the ranks' replicated computations have not drifted apart."""
    for i, t in enumerate(tensors):
        mine = t.detach().reshape(-1).contiguous()
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, mine, group=group)
        for r, q in enumerate(parts):
            if not torch.equal(q, mine):
                raise RuntimeError(f"{what} tensor {i} differs between this "
                                   f"rank and rank {r}")


# ---------------------------------------------------------------------------
# Activation registry: solvers opt a topology into the halo route
# (parallel.shard.shard_solver). While it is active, ops.fvmatrix.matvec,
# matvec_fn and matvec_t_fn route EVERY LDU product (primal Krylov and
# smoother iterations, the implicit-rule transposes, the adjoint FGMRES
# and fixed-point products, the PC sweeps) through HaloMatvec.
# ---------------------------------------------------------------------------

_ACTIVE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def activate(topo, n_parts: int, device="cuda", group=None) -> HaloMatvec:
    hm = _ACTIVE.get(topo)
    if hm is None or (hm.n_parts, hm.group) != (int(n_parts), group) \
            or hm.device != HaloMatvec.device_of(device):
        hm = HaloMatvec(topo, n_parts, device=device, group=group)
        _ACTIVE[topo] = hm
    return hm


def active(topo):
    try:
        return _ACTIVE.get(topo)
    except TypeError:  # unhashable/weakref-less stand-ins
        return None


def deactivate(topo):
    _ACTIVE.pop(topo, None)
