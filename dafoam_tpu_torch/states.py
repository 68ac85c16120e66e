"""State registry and flat-vector layout (port of ``dafoam_tpu.states``).

Which fields are states, and how they map to one flat vector. The default
ordering follows the reference's documented state-major layout (DAField.C
ofField2State): volVectorStates (cell-major, 3 comps), then
volScalarStates, then modelStates, then surfaceScalarStates. The
``adjStateOrdering: cell`` variant interleaves the cell-based components
per cell instead.
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
    """Pack/unpack between the state dict and one flat vector.

    ordering="state" (default): the state-major layout of the module
    docstring. ordering="cell": the reference's ``adjStateOrdering: cell``
    (pyDAFoam.py:608): every cell-based component of cell 0 (vector
    components, volScalars, modelStates), then cell 1, ..., with the
    surfaceScalarStates appended after the cell block (a face row has no
    owning cell slot in a flat vector). ``offsets`` is None under the cell
    ordering: state-major offsets mean nothing there, so a caller that
    slices by them fails loudly instead of reading the wrong positions.
    """

    def __init__(self, info: StateInfo, n_cells: int, n_faces: int,
                 ordering: str = "state"):
        if ordering not in ("state", "cell"):
            raise ValueError(f"adjStateOrdering must be 'state' or 'cell', "
                             f"got {ordering!r}")
        self.info = info
        self.n_cells = n_cells
        self.n_faces = n_faces
        self.ordering = ordering
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
        if ordering == "cell":
            self.offsets = None
        # components per cell of the cell block (cell ordering)
        self.cell_comps = sum(3 if kind == "vector" else 1
                              for _, kind in info.ordered if kind != "face")

    def _cell_names(self):
        return [(n, k) for n, k in self.info.ordered if k != "face"]

    def _face_names(self):
        return [n for n, k in self.info.ordered if k == "face"]

    def pack(self, state: dict) -> torch.Tensor:
        if self.ordering == "cell":
            cols = [state[n] if k == "vector" else state[n][:, None]
                    for n, k in self._cell_names()]
            parts = [torch.cat(cols, dim=1).reshape(-1)] if cols else []
            parts += [state[n].reshape(-1) for n in self._face_names()]
            return torch.cat(parts)
        return torch.cat([state[name].reshape(-1)
                          for name, _ in self.info.ordered])

    def unpack(self, vec: torch.Tensor) -> dict:
        out = {}
        if self.ordering == "cell":
            nc = self.n_cells
            block = vec[:nc * self.cell_comps].reshape(nc, self.cell_comps)
            col = 0
            for name, kind in self._cell_names():
                if kind == "vector":
                    out[name] = block[:, col:col + 3]
                    col += 3
                else:
                    out[name] = block[:, col]
                    col += 1
            off = nc * self.cell_comps
            for name in self._face_names():
                out[name] = vec[off:off + self.n_faces]
                off += self.n_faces
            return out
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
