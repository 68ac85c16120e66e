"""Carry inputs and states between dafoam_tpu (numpy side) and the port.

``inputs_from_numpy`` takes a ``make_inputs()``-shaped dict of the JAX
package (points, bc values and parametric-BC dicts, params with their
MRF/regressionPar/fvSourcePar sub-dicts, aoa, T_old, data) as numpy
arrays or Python numbers and returns the port's tensors on a device and
dtype, nested dicts and all; ``inputs_to_numpy`` is its inverse (also for
totals, which are input-shaped). ``state_from_numpy`` does the same for a
state dict (U, p, T, G, D, the volumetric or mass flux phi, the model
states), and ``state_to_numpy`` is its inverse. The same two carry the
fixed-point adjoint's psibar (a state-shaped dict) either way.

``history_from_numpy``/``history_to_numpy`` carry an unsteady solver's
history: a dict of (T+1, ...) arrays stacked over the time steps, the
initial condition at index 0 (``solve_primal_history`` of either
package), so each package's reverse sweep can run on the other's primal.

``recycle_from_numpy``/``recycle_to_numpy`` carry the deflated GMRES
recycle space (aug0/return_aug), a (k, n_flat) array over the state
flattened in sorted-key order: ``dafoam_tpu`` flattens with
``ravel_pytree`` and the port with ``utils.tree.ravel``, which visit a
dict's keys in the same sorted order, so the columns line up.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_tensor(v, device, dtype):
    if isinstance(v, dict):
        return {k: _to_tensor(x, device, dtype) for k, x in v.items()}
    return torch.as_tensor(np.array(v), dtype=dtype, device=device)


def inputs_from_numpy(inputs: dict, device, dtype) -> dict:
    """{points, bc: {field: {patch: value}}, params: {name: value}} of
    numpy values -> the same dict of tensors."""
    return _to_tensor(inputs, torch.device(device), dtype)


def inputs_to_numpy(inputs: dict) -> dict:
    """The inverse of ``inputs_from_numpy`` (nested dicts of numpy)."""
    if isinstance(inputs, dict):
        return {k: inputs_to_numpy(v) for k, v in inputs.items()}
    return inputs.detach().cpu().numpy()


def state_from_numpy(state: dict, device, dtype) -> dict:
    return {k: _to_tensor(v, torch.device(device), dtype)
            for k, v in state.items()}


def state_to_numpy(state: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def history_from_numpy(hist: dict, device, dtype) -> dict:
    """{state: (T+1, ...) numpy} -> the same dict of tensors."""
    return state_from_numpy(hist, device, dtype)


def history_to_numpy(hist: dict) -> dict:
    return state_to_numpy(hist)


def recycle_from_numpy(aug, device, dtype) -> torch.Tensor:
    """(k, n_flat) recycle space of dafoam_tpu's gmres -> a tensor."""
    return torch.as_tensor(np.array(aug), dtype=dtype,
                           device=torch.device(device))


def recycle_to_numpy(aug) -> np.ndarray:
    return aug.detach().cpu().numpy()
