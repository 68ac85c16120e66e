"""Phase timing and profiling.

Port of ``dafoam_tpu.utils.timing``. DAFoam prints per-phase wall and CPU
time (DASolver::printElapsedTime); here a Timer accumulates wall seconds
per named phase. CUDA runs asynchronously, so a phase whose result is
still being computed on the card would time only the launches:
``block_on`` names the block's result (a tensor or a nested
dict/list/tuple of them) and the timer synchronizes each CUDA device it
lies on before it stops the clock (what ``jax.block_until_ready`` does in
the reference). ``trace`` records a ``torch.profiler`` session and writes
a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _devices(tree, out):
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def block_until_ready(tree):
    """Wait for the CUDA work behind every tensor in ``tree``."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class Timer:
    """Phase timer: ``with timer.phase("adjoint"): ...``; ``report()``
    gives {phase: seconds}, longest first."""

    def __init__(self):
        self._acc = {}

    @contextlib.contextmanager
    def phase(self, name, block_on=None):
        """Time the block. ``block_on`` is the block's result, or a
        callable returning it once the block has run (the result is often
        made inside the block); a block that raises is timed without the
        wait."""
        t0 = time.perf_counter()
        try:
            yield
            if block_on is not None:
                block_until_ready(block_on() if callable(block_on)
                                  else block_on)
        finally:
            self._acc[name] = self._acc.get(name, 0.0) \
                + time.perf_counter() - t0

    def report(self):
        return dict(sorted(self._acc.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def trace(logdir="dafoam_tpu_torch_trace"):
    """torch.profiler session over the block (CPU, and CUDA where
    available); writes ``<logdir>/trace.json`` (Chrome trace format, open
    in Perfetto or chrome://tracing) and yields the logdir."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
