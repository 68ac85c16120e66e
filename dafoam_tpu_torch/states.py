"""State registry and flat-vector layout (port of ``dafoam_tpu.states``).

Which fields are states, and how they map to one flat vector, following
the reference's documented ordering (DAField.C ofField2State):
volVectorStates (cell-major, 3 comps), then volScalarStates, then
modelStates, then surfaceScalarStates.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class StateInfo:
    vol_vector: tuple[str, ...] = ()
    vol_scalar: tuple[str, ...] = ()
    model: tuple[str, ...] = ()
    surface_scalar: tuple[str, ...] = ()

    @property
    def ordered(self):
        return (tuple((n, "vector") for n in self.vol_vector)
                + tuple((n, "scalar") for n in self.vol_scalar)
                + tuple((n, "model") for n in self.model)
                + tuple((n, "face") for n in self.surface_scalar))

    def names(self):
        return [n for n, _ in self.ordered]


class StateLayout:
    """Pack/unpack between the state dict and one flat vector, in the
    state-major ordering (``adjStateOrdering: state``)."""

    def __init__(self, info: StateInfo, n_cells: int, n_faces: int,
                 ordering: str = "state"):
        if ordering != "state":
            raise NotImplementedError(
                f"adjStateOrdering {ordering!r} is not ported yet: it "
                "arrives with the adjoint slice (ROADMAP.md queue 1, P5)")
        self.info = info
        self.n_cells = n_cells
        self.n_faces = n_faces
        self.sizes = {}
        self.offsets = {}
        off = 0
        for name, kind in info.ordered:
            sz = 3 * n_cells if kind == "vector" else (
                n_faces if kind == "face" else n_cells)
            self.sizes[name] = sz
            self.offsets[name] = off
            off += sz
        self.n_states = off

    def pack(self, state: dict) -> torch.Tensor:
        return torch.cat([state[name].reshape(-1)
                          for name, _ in self.info.ordered])

    def unpack(self, vec: torch.Tensor) -> dict:
        out = {}
        for name, kind in self.info.ordered:
            off, sz = self.offsets[name], self.sizes[name]
            chunk = vec[off:off + sz]
            if kind == "vector":
                chunk = chunk.reshape(self.n_cells, 3)
            out[name] = chunk
        return out

    def zeros(self, dtype, *, device) -> dict:
        out = {}
        for name, kind in self.info.ordered:
            if kind == "vector":
                shape = (self.n_cells, 3)
            elif kind == "face":
                shape = (self.n_faces,)
            else:
                shape = (self.n_cells,)
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        return out
