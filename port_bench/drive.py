"""The loop that drives a solver: set-up, warm-up and the measured window,
and what they keep for the check of ``correct``.

The window is a closed loop: the next chunk of SIMPLE iterations starts
when the last has ended. It closes at the end of the first chunk that
ends after ``seconds``, so its rate is taken over whole chunks and over
all of their time.

The solver comes from a ``system`` (``system.py``): the program itself in
every run of the benchmark, the plain reference in the control's place.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class Spans:
    """Named host-clock spans around calls into the solver, each ending in
    a device synchronisation."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = {}

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            self.seconds[name] = self.seconds.get(name, 0.0) \
                + time.perf_counter() - t0


def _detached(state):
    return {k: v.detach() for k, v in state.items()}


def _finite(state):
    import torch
    return all(bool(torch.isfinite(v).all()) for v in state.values())


def primal_chunk(solver, state, inputs, iters):
    """``iters`` SIMPLE iterations through ``run_primal``."""
    for k, v in (("primalMinIters", int(iters)),
                 ("primalMaxIters", int(iters)), ("primalMinResTol", 0.0)):
        solver.option.set(k, v)
    return solver.run_primal(state, inputs)


def face_layout(topo):
    """The faces of the solver's own layout as (owner, neighbour, number
    of internal faces, mask of the real internal faces), or None where the
    solver keeps the mesh's order."""
    if topo is None:
        return None
    ni = int(topo.n_internal)
    valid = np.ones(ni, dtype=bool)
    dd = topo.dia_dense()
    if dd is not None:
        valid = np.asarray(dd[1]).reshape(-1)[:ni] > 0.5
    return (np.asarray(topo.owner), np.asarray(topo.neighbour), ni, valid)


class Cell:
    """One run's solver, inputs and the records of its set-up and window.

    ``stages`` lists (start state or None for the solver's own initial
    state, end state, SIMPLE iterations) of the chunks that the check
    follows: the warm-up, from the initial state, and the window's last
    chunk."""

    def __init__(self, system, traffic, opts, spans):
        self.system = system
        self.traffic = traffic
        self.opts = opts
        self.spans = spans
        self.stages = []
        self.last = {}
        self.window = {}

    def setup(self, case):
        sp = self.spans
        with sp.span("setup.read_mesh"):
            points, topo = self.system.read_mesh(case)
        with sp.span("setup.make_solver"):
            self.solver = self.system.make_solver(self.opts, topo, points)
            self.inputs = self.solver.make_inputs()
            st0 = self.solver.init_state()
        n = int(self.traffic["warmup_iters"])
        with sp.span("setup.warmup"):
            st, _ = primal_chunk(self.solver, st0, self.inputs, n)
        self.stages.append((None, _detached(st), n))
        self.state = st
        return self

    def run_window(self, seconds, tail=None):
        """Run chunks until ``seconds`` have passed; then, with ``tail``
        (``trace.Traced``), one more chunk under it. Fills ``self.window``
        and ``self.last``."""
        sync = self.system.sync
        chunk = int(self.traffic["chunk_iters"])
        iters = chunks = failed = 0
        self.solver.solve_stats.clear()
        sync()
        t0 = time.perf_counter()
        while True:
            iters += self._step(chunk)
            chunks += 1
            failed += int(self.last["failed"])
            if time.perf_counter() - t0 >= seconds:
                break
        sync()
        self.window = {"iters": iters, "attempted": chunks, "failed": failed,
                       "seconds": time.perf_counter() - t0,
                       "solve_stats": {k: list(v) for k, v in
                                       self.solver.solve_stats.items()}}
        if tail is not None:
            with tail(sync):
                tail.iters = self._step(chunk)
        self.last["cd"] = float(self.solver.run_function(
            "CD", self.state, self.inputs))
        self.last["finite"] = _finite(self.state)
        return self.window

    def _step(self, iters):
        prev = self.state
        st, info = primal_chunk(self.solver, prev, self.inputs, iters)
        self.state = st
        self.last = {"start": _detached(prev), "end": _detached(st),
                     "iters": int(info.iters), "failed": bool(info.failed)}
        return int(info.iters)

    def outputs(self):
        """The program's outputs as plain tensors for the judge, with no
        reference to the solver, so that its memory can be freed first."""
        return {"stages": self.stages + [(self.last["start"],
                                          self.last["end"],
                                          self.last["iters"])],
                "cd": self.last["cd"], "state": _detached(self.state),
                "finite": self.last["finite"],
                "faces": face_layout(self.solver.topo)}
