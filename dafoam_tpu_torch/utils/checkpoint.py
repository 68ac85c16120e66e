"""Checkpoint / resume for states, histories and optimization snapshots.

Port of ``dafoam_tpu.utils.checkpoint``, with the same archive layout:
one ``.npz`` holding ``state/<k>``, ``inputs/<a>/<b>/...`` (nested dicts
flattened with ``/``) and a ``__meta__`` JSON blob, so an archive written
by either package loads in the other. Tensors are copied to the host
(``.detach().cpu().numpy()``) before the write. ``load_checkpoint``
returns numpy, as the reference does; ``convert.state_from_numpy`` and
``convert.inputs_from_numpy`` put the values on a device.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np


def _host(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(
                    f"checkpoint keys must not contain '/': {k!r}")
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = _host(tree)
    return out


def _unflatten(flat):
    tree = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path, state, inputs=None, meta=None):
    """Write state (+inputs, +meta) to one .npz archive."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = {"state/" + k: v for k, v in _flatten(state).items()}
    if inputs is not None:
        data.update({"inputs/" + k: v for k, v in _flatten(inputs).items()})
    if meta:
        data["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **data)


def load_checkpoint(path):
    """-> (state, inputs or None, meta or None), all numpy."""
    state_flat, inputs_flat, meta = {}, {}, None
    with np.load(path) as z:
        for k in z.files:
            if k == "__meta__":
                meta = json.loads(bytes(z[k].tobytes()).decode())
            elif k.startswith("state/"):
                state_flat[k[6:]] = z[k]
            elif k.startswith("inputs/"):
                inputs_flat[k[7:]] = z[k]
    return (_unflatten(state_flat),
            _unflatten(inputs_flat) if inputs_flat else None, meta)


def rename_solution(case_dir, iteration):
    """Snapshot the latest checkpoint per major optimization iteration
    (DAFoam's PYDAFOAM.renameSolution)."""
    src = os.path.join(case_dir, "latest.npz")
    dst = os.path.join(case_dir, f"solution_{iteration:04d}.npz")
    if os.path.exists(src):
        shutil.copyfile(src, dst)
    return dst
