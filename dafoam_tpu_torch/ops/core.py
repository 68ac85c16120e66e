"""Gather/scatter primitives for unstructured FV, in torch.

Every ``fvm``/``fvc`` operator reduces to (1) gather cell values to faces,
(2) a per-face flux computation, (3) sum face contributions back into
cells. Two internal-face layouts are supported, as in ``dafoam_tpu``:

- canonical (owner-sorted faces): face->cell sums are per-cell gathers over
  the ELL adjacency (``topo.ell()``), which keeps the summation order of
  the JAX package and is deterministic on the GPU;
- dense DIA (``topo.dia_dense()``): internal face ``i*nc + c`` joins cell
  ``c`` to ``c + offsets[i]``, so every cell<->face movement is a broadcast
  or a static zero-padded shift.

The adjoint differentiates these with autograd; ``abs_ad`` gives |x| the
derivative convention of ``jnp.abs`` where x is exactly 0 (zero faces of
the dense layout, orthogonal faces). Topology index arrays are copied to the device once and cached on the
topology object, keyed on device (and dtype for weights).
"""

from __future__ import annotations

import numpy as np
import torch

from dafoam_tpu_torch.utils import timing


def abs_ad(x: torch.Tensor) -> torch.Tensor:
    """|x| whose derivative at x == 0 is +1, as ``jnp.abs``'s (torch.abs
    has 0 there), so the port's reverse and forward products agree with
    dafoam_tpu's at exact zeros."""
    return torch.where(x >= 0, x, -x)


def maximum(x: torch.Tensor, c) -> torch.Tensor:
    """max(x, c) for a constant c whose derivative at a tie is 1/2, as
    ``jnp.maximum``'s (torch.clamp passes it whole): model states sit
    exactly on their bounds after a clipped update. A number c is copied
    to x's device, which on a CUDA device waits for the stream."""
    return torch.maximum(x, timing.host_copy("core.constant", c, x))


def minimum(x: torch.Tensor, c) -> torch.Tensor:
    """min(x, c), with ``maximum``'s tie rule."""
    return torch.minimum(x, timing.host_copy("core.constant", c, x))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: minimum(maximum(x, lo), hi)."""
    return minimum(maximum(x, lo), hi)


def _cache(topo) -> dict:
    cache = getattr(topo, "_torch_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(topo, "_torch_cache", cache)
    return cache


def index_tensor(topo, key: str, device, make):
    """int64 device copy of the host index array ``make()``, cached on the
    topology under ``key``."""
    cache = _cache(topo)
    k = ("idx", key, str(torch.device(device)))
    t = cache.get(k)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(make()), dtype=torch.int64,
                            device=device)
        cache[k] = t
    return t


def float_tensor(topo, key: str, device, dtype, make):
    """Float device copy of the host array ``make()``, cached on the
    topology under (key, device, dtype)."""
    cache = _cache(topo)
    k = ("f", key, str(torch.device(device)), dtype)
    t = cache.get(k)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(make()), dtype=dtype,
                            device=device)
        cache[k] = t
    return t


def scatter_add(vals: torch.Tensor, cells: torch.Tensor, n_cells: int):
    """sum_{f: cells[f]==c} vals[f]  ->  (n_cells, ...)."""
    out = vals.new_zeros((n_cells,) + tuple(vals.shape[1:]))
    return out.index_add_(0, cells, vals)


def boundary_gather(x: torch.Tensor, topo) -> torch.Tensor:
    """x[owner[ni:]] (cell values at boundary-face owners), patch-aware."""
    parts = []
    ni = topo.n_internal
    for mode, b0, sz, idx in topo.boundary_scatter_plan():
        if mode == "identity":
            parts.append(x)
        else:
            # "perm": the owner slice of the patch; "scatter": idx == owners
            own = index_tensor(
                topo, f"bown{b0}", x.device,
                lambda b0=b0, sz=sz: topo.owner[ni + b0:ni + b0 + sz])
            parts.append(x.index_select(0, own))
    return torch.cat(parts, dim=0)


def boundary_scatter_add(y: torch.Tensor, vals_b: torch.Tensor, topo):
    """y[owner[ni:]] += vals_b, patch-aware (out of place).

    ``index_add`` keeps repeated owner indices summed; ``y[idx] += v``
    would drop all but one of them."""
    for mode, b0, sz, idx in topo.boundary_scatter_plan():
        v = vals_b[b0:b0 + sz]
        if mode == "identity":
            y = y + v
        elif mode == "perm":
            inv = index_tensor(topo, f"binv{b0}", y.device,
                               lambda idx=idx: idx)
            y = y + v.index_select(0, inv)
        else:
            own = index_tensor(topo, f"bscat{b0}", y.device,
                               lambda idx=idx: idx)
            y = y.index_add(0, own, v)
    return y


# ---------------------------------------------------------------------------
# canonical layout: gather-form face->cell reductions over the ELL adjacency
# ---------------------------------------------------------------------------

def _face_gather_sum(vals_i, topo, own_w: float, nei_w: float):
    """sum_k w(k) * vals_i[face_id[c,k]] with w = own_w on owner slots and
    nei_w on neighbour slots."""
    face_id = index_tensor(topo, "ell_face", vals_i.device,
                           lambda: topo.ell()[0])

    def weights():
        _, _, is_owner, valid = topo.ell()
        return np.where(is_owner > 0.5, own_w, nei_w) * valid

    w = float_tensor(topo, f"ell_w{own_w}{nei_w}", vals_i.device,
                     vals_i.dtype, weights)
    v = vals_i[face_id]                                # (nc, K, ...)
    w = w.reshape(w.shape + (1,) * (v.ndim - 2))
    return (v * w).sum(dim=1)


# ---------------------------------------------------------------------------
# dense-DIA layout: broadcasts and static shifts
# ---------------------------------------------------------------------------

def _dd(topo):
    return topo.dia_dense()


def _shape_kn(x, topo, K):
    """(K*nc, ...) face array -> (K, nc, ...)"""
    return x.reshape((K, topo.n_cells) + tuple(x.shape[1:]))


def _shift_fwd(x, o: int):
    """y[c] = x[c + o] (zeros beyond the end); x (nc, ...)"""
    pad = x.new_zeros((o,) + tuple(x.shape[1:]))
    return torch.cat([x[o:], pad], dim=0)


def _shift_bwd(x, o: int):
    """y[c] = x[c - o] (zeros before the start)"""
    pad = x.new_zeros((o,) + tuple(x.shape[1:]))
    return torch.cat([pad, x[:x.shape[0] - o]], dim=0)


def face_sum_signed(vals_i, topo):
    """y[c] = sum_{f: own=c} vals_i[f] - sum_{f: nei=c} vals_i[f]."""
    dd = _dd(topo)
    if dd is not None:
        offs, _ = dd
        xk = _shape_kn(vals_i, topo, len(offs))
        y = xk.sum(dim=0)
        for i, o in enumerate(offs):
            y = y - _shift_bwd(xk[i], o)
        return y
    return _face_gather_sum(vals_i, topo, 1.0, -1.0)


def face_sum_pair(own_vals, nei_vals, topo):
    """y[c] = sum_{f: own=c} own_vals[f] + sum_{f: nei=c} nei_vals[f] —
    the LDU diagonal-assembly reduction."""
    dd = _dd(topo)
    if dd is not None:
        offs, _ = dd
        K = len(offs)
        ok = _shape_kn(own_vals, topo, K)
        nk = _shape_kn(nei_vals, topo, K)
        y = ok.sum(dim=0)
        for i, o in enumerate(offs):
            y = y + _shift_bwd(nk[i], o)
        return y
    return _face_gather_sum(own_vals, topo, 1.0, 0.0) \
        + _face_gather_sum(nei_vals, topo, 0.0, 1.0)


def cell_to_face_own(x, topo):
    """x[owner] on internal faces."""
    dd = _dd(topo)
    if dd is not None:
        return torch.cat([x] * len(dd[0]), dim=0)
    own = index_tensor(topo, "own_i", x.device,
                       lambda: topo.owner[:topo.n_internal])
    return x.index_select(0, own)


def cell_to_face_nei(x, topo):
    """x[neighbour] on internal faces."""
    dd = _dd(topo)
    if dd is not None:
        return torch.cat([_shift_fwd(x, o) for o in dd[0]], dim=0)
    nei = index_tensor(topo, "nei", x.device, lambda: topo.neighbour)
    return x.index_select(0, nei)


def surface_sum(vals_internal, vals_boundary, topo, active_b=None):
    """OpenFOAM surfaceSum: per-cell sum of face values with owner +, nei -.

    ``vals_internal``: (ni, ...) per-internal-face values;
    ``vals_boundary``: (nb, ...) per-boundary-face values (outward sign).
    ``active_b``: optional (nb,) 0/1 mask (0 for empty patches).
    """
    out = face_sum_signed(vals_internal, topo)
    if vals_boundary is not None:
        if active_b is not None:
            shp = (-1,) + (1,) * (vals_boundary.ndim - 1)
            vals_boundary = vals_boundary * active_b.reshape(shp)
        out = boundary_scatter_add(out, vals_boundary, topo)
    return out
