"""Jacobian dumps for offline inspection (DAFoam's writeJacobians).

Port of ``dafoam_tpu.utils.jacdump``. DAFoam's ``writeJacobians`` option
dumps dRdWT and the preconditioner matrix in PETSc binary so that a
developer can inspect conditioning and row sums offline; this dumps npz:

- ``dRdWT``: the transposed Jacobian of the packed residual vector with
  respect to the packed state, on the operator the adjoint FGMRES applies
  by default (``normalized=True``): the normalizeResiduals-scaled residual
  (``solver._norm_residuals``) with the ``normalizeStates`` scaling of
  ``adjoint_solve`` on both sides, so what is inspected is what FGMRES
  sees. ``normalized=False`` dumps the raw per-equation Jacobian instead.
- per-state slot offsets and sizes, so rows and columns map back to fields.

There is no sparse export of the matrix-free operator at scale: it only
exists as a vjp. For large cases dump the segregated PC operators (the
assembled part) instead.
"""

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD


def dense_drdwt(solver, state, inputs, normalized=True):
    """Exact dense dRdW^T on the packed layout (small meshes only).

    normalized=True (default) differentiates the scaled adjoint operator
    D_W dR~/dW^T D_R^-1 (R~ = _norm_residuals, D from normalizeStates),
    the matrix FGMRES sees in adjoint_solve; normalized=False
    differentiates raw ``solver.residuals``. Row i is the forward-mode
    product of the residual with the i-th one-hot tangent, dR/dw_i (the
    reference maps ``jax.jvp`` over the same tangents). Returns numpy in
    the solver's dtype.
    """
    layout = solver.layout
    state = {k: v.detach() for k, v in state.items()}
    with torch.no_grad():
        if normalized:
            scales = solver.state_scales(solver.geometry(inputs))
            s_flat = layout.pack({k: torch.broadcast_to(scales[k],
                                                        state[k].shape)
                                  for k in layout.info.names()})
            res_fn = solver._norm_residuals
        else:
            res_fn = solver.residuals
        w0 = layout.pack(state)

    def res_flat(w):
        st = layout.unpack(w)
        # carry non-layout state entries (e.g. model old-time dicts)
        for k, v in state.items():
            if k not in st:
                st[k] = v
        return layout.pack(res_fn(st, inputs))

    n = int(w0.shape[0])
    J = torch.empty((n, n), dtype=w0.dtype, device=w0.device)
    with torch.no_grad(), fwAD.dual_level():
        for i in range(n):
            e = torch.zeros_like(w0)
            e[i] = 1.0
            J[i] = fwAD.unpack_dual(res_flat(fwAD.make_dual(w0, e))).tangent
    J = J.cpu().numpy()               # row i = dR/dw_i  ==  dRdW^T
    if normalized:
        s = s_flat.cpu().numpy()
        # scaled operator D_W J^T D_R^-1; with J^T stored row-major as
        # J[i, j] = dR_j/dw_i, that is s[i] * J[i, j] / s[j]
        J = (s[:, None] * J) / s[None, :]
    return J


def write_jacobians(path, solver, state, inputs, dense_limit=20000,
                    normalized=True):
    """Dump dRdWT (+ layout metadata) to ``path`` (.npz).

    Refuses the dense path above ``dense_limit`` packed DOFs: at that size
    use the assembled PC matrices or a matvec probe instead.
    """
    layout = solver.layout
    with torch.no_grad():
        zeros = layout.unpack(layout.pack(solver.init_state()))
    n = sum(int(zeros[name].numel()) for name in layout.info.names())
    if n > dense_limit:
        raise ValueError(
            f"packed state has {n} DOFs > dense_limit={dense_limit}; "
            "dense Jacobian dump is a small-case debug tool")
    J = dense_drdwt(solver, state, inputs, normalized=normalized)
    meta = {}
    off = 0
    for name in layout.info.names():
        sz = int(zeros[name].numel())
        meta[f"offset_{name}"] = off
        meta[f"size_{name}"] = sz
        off += sz
    np.savez_compressed(path, dRdWT=J, n_dof=n,
                        normalized=bool(normalized), **meta)
    return J
