"""Phase timing, spans of the solver's phases and host reads, and profiling.

Port of ``dafoam_tpu.utils.timing``, and the port's one tracing mechanism.

``Timer``: DAFoam prints per-phase wall and CPU time
(DASolver::printElapsedTime); here a Timer accumulates wall seconds per
named phase. CUDA runs asynchronously, so a phase whose result is still
being computed on the card would time only the launches: ``block_on``
names the block's result (a tensor or a nested dict/list/tuple of them)
and the timer synchronizes each CUDA device it lies on before it stops
the clock (what ``jax.block_until_ready`` does in the reference). Each
phase is also a ``span`` of its name.

Spans. The solver marks its phases with ``span(name)``: the SIMPLE
iteration and its momentum, pressure and turbulence phases, every Krylov
solve, and the set-up steps (banded layout, wall distance, geometry).
A whole function is marked with the decorator ``spanned(name)``. They
cost nothing unless a recorder is installed: ``span`` then makes one
module-level check and returns a shared no-op context, with no
allocation, no clock read and no ``record_function``. Inside
``with recording() as rec:`` each span is kept in memory (name, parent,
start and end from ``time.perf_counter_ns``), and ``rec.aggregate()``
gives per name the count, the seconds and the seconds outside child
spans. While a ``torch.profiler`` session is active too, each span also
enters ``torch.profiler.record_function(name)``, so it stands in the
profiler's host timeline on the device trace's clock and lands in the
Chrome export of ``trace()``, which installs a recorder for its block
when none is: the phases beside the kernels they launch.

Host reads. ``host_read(site, t)`` is ``t.item()`` (``t.tolist()`` for a
few numbers read at once), the one place where the solver's loops wait
for the device to read a number: the SIMPLE residual and state validity,
the Krylov norms. With a recorder installed the read is recorded as a
span ``sync.<site>`` whose length is the host's
wait for the device; these spans never enter the profiler, so they add
no event to a profiled run. ``host_copy(site, value, like)`` is the other
way: a number from the host made a tensor on the device, a copy that
waits for the CUDA stream, recorded the same way (site ``core.constant``:
the constants of ``ops.core.maximum`` and ``minimum``).

Spans never synchronize the device. In a loop paced by the host, as the
SIMPLE iteration is (it reads numbers back every inner iteration), a
phase's span is the host's time in that phase, which is the phase's
time; where the device runs behind, the wait shows in the ``sync.*``
span that ends it.

``trace`` records a ``torch.profiler`` session and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import torch

_clock = time.perf_counter_ns

# the installed Recorder, or None (the one check a span makes when off)
_REC = None
# the shared context of a span while nothing records
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "name", "i", "rf")

    def __init__(self, rec, name):
        self.rec, self.name, self.rf = rec, name, None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.i = self.rec._open(self.name)
        return self.rec

    def __exit__(self, *exc):
        self.rec._close(self.i)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Recorder:
    """Spans kept in memory while installed by ``recording()``.

    ``spans``: [name, parent index or -1, start ns, end ns (None while
    open)], in the order they opened."""

    def __init__(self):
        self.spans = []
        self._stack = []

    def _open(self, name):
        i = len(self.spans)
        self.spans.append([name, self._stack[-1] if self._stack else -1,
                           _clock(), None])
        self._stack.append(i)
        return i

    def _close(self, i):
        self.spans[i][3] = _clock()
        # a span left open by an exception closes with its parent
        while self._stack and self._stack.pop() != i:
            pass

    def aggregate(self, t0=None, t1=None):
        """{name: {"count", "seconds", "self_seconds"}} over the closed
        spans that start in [t0, t1) (ns of ``time.perf_counter_ns``;
        None: unbounded); ``self_seconds`` leaves out the time in child
        spans."""
        lo = -1 if t0 is None else t0
        hi = float("inf") if t1 is None else t1
        child = [0] * len(self.spans)
        for name, parent, s, e in self.spans:
            if parent >= 0 and e is not None:
                child[parent] += e - s
        out = {}
        for i, (name, _, s, e) in enumerate(self.spans):
            if e is None or not lo <= s < hi:
                continue
            a = out.setdefault(name, {"count": 0, "seconds": 0.0,
                                      "self_seconds": 0.0})
            a["count"] += 1
            a["seconds"] += (e - s) * 1e-9
            a["self_seconds"] += (e - s - child[i]) * 1e-9
        return out


@contextlib.contextmanager
def recording():
    """Install a ``Recorder`` for the block and yield it; the one
    installed before, if any, is restored after."""
    global _REC
    prev, rec = _REC, Recorder()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = prev


def span(name):
    """Context marking a phase ``name`` of the solver (see the module
    docstring); a shared no-op unless a recorder is installed."""
    if _REC is None:
        return _NULL
    return _Span(_REC, name)


def spanned(name):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _REC is None:
                return fn(*args, **kwargs)
            with _Span(_REC, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def _numbers(t):
    return t.item() if t.numel() == 1 else t.tolist()


def host_read(site, t):
    """``t.item()``, or ``t.tolist()`` for more than one element: one read;
    with a recorder installed, recorded as the span ``sync.<site>``."""
    rec = _REC
    if rec is None:
        return _numbers(t)
    i = rec._open("sync." + site)
    try:
        return _numbers(t)
    finally:
        rec._close(i)


def host_copy(site, value, like):
    """``torch.as_tensor(value, dtype=like.dtype, device=like.device)``. A
    host value (not a tensor) is copied to ``like``'s device, and on a
    CUDA device that copy from pageable memory waits for the stream: with
    a recorder installed, it is recorded as the span ``sync.<site>``."""
    rec = _REC
    if rec is None or isinstance(value, torch.Tensor):
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    i = rec._open("sync." + site)
    try:
        return torch.as_tensor(value, dtype=like.dtype, device=like.device)
    finally:
        rec._close(i)


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
        """Time the block, as the span ``name`` too. ``block_on`` is the
        block's result, or a callable returning it once the block has run
        (the result is often made inside the block); a block that raises
        is timed without the wait."""
        t0 = time.perf_counter()
        try:
            with span(name):
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
    in Perfetto or chrome://tracing) and yields the logdir. The solver's
    spans appear there as host events: a recorder is installed for the
    block unless one already is."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    rec = contextlib.nullcontext() if _REC is not None else recording()
    with rec, profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
