"""The comparisons that decide ``correct``, one judge per traffic kind
(``spec.KINDS``).

Each runs after the window, once the program's peak memory has been read
and its solver freed. The plain reference is the configuration's own
(``spec.reference_case``), run in float64 and built from the benchmark's
own mesh arrays and options, never from what the program read or
derived. The program's face flux phi is read in the mesh's face order
through the program's face layout (``drive.face_layout``).

``judge_primal`` (kind "primal") compares:

- ``start_gap``: the reference follows the program's warm-up chunk of
  SIMPLE iterations from its own initial state, which checks the start.
  Per field (U, p, phi, nuTilda), the 2-norm of the difference of the two
  end states over the 2-norm of the change the reference's chunk made;
  the worst field. A step that returns its state unchanged reads 1. The
  2-norm, and not the largest entry: in float32 the program's first
  iterations from the uniform start leave single cells near the airfoil
  apart from the float64 reference by as much as their change (up to 1.1
  of it at 917,504 cells), where the whole field's change is followed to
  a few per cent.
- ``state_gap``: the reference follows the window's last chunk from the
  state the program started it from. Per field, the 2-norm of the
  difference of the two end states over the 2-norm of the reference's
  end state; the worst field. Late in the window a chunk changes the
  state by little more than float32 resolves, so this gap is taken
  against the field and not against the chunk's change.
- ``cd_gap``: CD of the program's final state as the program evaluated
  it, against the reference's evaluation of the same state, relative.

The reference follows the last chunk from the program's own state: the
primal is a long iteration, and float32 rounding leaves two runs apart by
more than one chunk's change.
"""

from __future__ import annotations

import math

import numpy as np
import torch

TINY = 1e-300


def face_index(faces, mesh):
    """Index ``idx`` with phi_mesh = phi_program[idx], from the program's
    face layout (owner, neighbour, number of internal faces, real internal
    faces), or None when the program keeps the mesh's order."""
    if faces is None:
        return None
    own_p, nei_p, ni_p, valid = faces
    nc = int(mesh["n_cells"])
    own_m = np.asarray(mesh["owner"], dtype=np.int64)
    nei_m = np.asarray(mesh["neighbour"], dtype=np.int64)
    ni = nei_m.shape[0]
    real = np.flatnonzero(valid)
    key_p = own_p[real].astype(np.int64) * nc + nei_p[real]
    key_m = own_m[:ni] * nc + nei_m
    op, om = np.argsort(key_p), np.argsort(key_m)
    if not np.array_equal(key_p[op], key_m[om]):
        raise ValueError("the program's internal faces are not the mesh's")
    idx = np.empty(ni, dtype=np.int64)
    idx[om] = real[op]
    nb = own_m.shape[0] - ni
    if own_p.shape[0] - ni_p != nb or not np.array_equal(
            np.asarray(own_p[ni_p:], dtype=np.int64), own_m[ni:]):
        raise ValueError("the program's boundary faces are not the mesh's")
    return np.concatenate([idx, ni_p + np.arange(nb)])


def _to_ref(state, ref, idx):
    out = {k: v.detach().to(device=ref.device, dtype=ref.dtype)
           for k, v in state.items()}
    if idx is not None:
        out["phi"] = out["phi"][torch.as_tensor(idx, device=ref.device)]
    return out


def follow(ref, idx, start, end, iters):
    """{field: (|difference|, |reference's change|, |reference's end|)},
    2-norms, of one chunk (module docstring)."""
    st0 = ref.init_state() if start is None else _to_ref(start, ref, idx)
    st = st0
    for _ in range(int(iters)):
        st = ref.step(st)
    end = _to_ref(end, ref, idx)
    norm = torch.linalg.vector_norm
    return {k: (float(norm(end[k] - v)), float(norm(v - st0[k])),
                float(norm(v))) for k, v in st.items()}


def _worst(gaps):
    return max(gaps.values()) if all(map(math.isfinite, gaps.values())) \
        else math.inf


def judge_primal(Case, case, opts, out, limits, device):
    """The compared numbers of one primal run as {name: (value, limit)}
    plus notes, from the program's outputs ``out``
    (``drive.Cell.outputs``); ``Case`` is the configuration's reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = Case(case["mesh"], opts, device=device, dtype=torch.float64)
    idx = face_index(out["faces"], case["mesh"])
    (start, end, iters), (start2, end2, iters2) = out["stages"]
    n = follow(ref, idx, start, end, iters)
    first = {k: d / max(c, TINY) for k, (d, c, _) in n.items()}
    n = follow(ref, idx, start2, end2, iters2)
    last = {k: d / max(e, TINY) for k, (d, _, e) in n.items()}
    cfg = opts["function"]["CD"]
    cd_ref = ref.force(_to_ref(out["state"], ref, idx), cfg["patches"],
                       cfg["direction"], cfg.get("scale", 1.0))
    nums = {"start_gap": _worst(first), "state_gap": _worst(last),
            "cd_gap": abs(out["cd"] - cd_ref) / max(abs(cd_ref), TINY)}
    notes = {"start_gap_by_field": first, "state_gap_by_field": last,
             "cd": out["cd"], "cd_reference": cd_ref}
    return {k: (v, limits.get(k)) for k, v in nums.items()}, notes
