"""The traced sub-window: torch.profiler over one more chunk, the
shapes of every banded product launched in it, and the reductions of the
trace that the per-layer metrics read.

The reductions take plain lists, so that a synthetic trace can test
them: device events (name, start us, duration us) and host ops (name,
start us, end us).
"""

from __future__ import annotations

import bisect
import contextlib
import time

from port_bench import roofline

# kernel name fragments of the program's DIA kernels, most specific first
DIA_KERNELS = (("dia_cotangent_multi_kernel", "dia_cotangent_multi"),
               ("dia_cotangent_kernel", "dia_cotangent"),
               ("dia_matvec_multi_t_kernel", "dia_matvec_multi_t"),
               ("dia_matvec_t_kernel", "dia_matvec_t"),
               ("dia_matvec_multi_kernel", "dia_matvec_multi"),
               ("dia_matvec_kernel", "dia_matvec"))
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def dia_kind(kernel_name):
    for frag, kind in DIA_KERNELS:
        if frag in kernel_name:
            return kind
    return None


class DiaCalls:
    """Records (bytes, flops, itemsize) of every call of the program's
    banded-product wrappers (``ops/dia_kernels``) made while ``on``, by
    wrapping the module's public functions while active."""

    def __init__(self):
        self.calls = {kind: [] for _, kind in DIA_KERNELS}
        self.on = False

    @contextlib.contextmanager
    def active(self, module):
        saved = {kind: getattr(module, kind) for kind in self.calls}

        def wrap(kind, fn):
            def call(*args, **kw):
                if self.on:
                    self.calls[kind].append(_call_work(kind, args, kw))
                return fn(*args, **kw)
            return call

        for kind, fn in saved.items():
            setattr(module, kind, wrap(kind, fn))
        try:
            yield self
        finally:
            for kind, fn in saved.items():
                setattr(module, kind, fn)


def _call_work(kind, args, kw):
    if kind in ("dia_cotangent", "dia_cotangent_multi"):
        ct, x, offsets = args[:3]
        per = bool(args[3] if len(args) > 3
                   else kw.get("per_component", False))
        c = ct.shape[0] if ct.ndim == 2 else 1
        b, f = roofline.work(kind, ct.shape[-1], len(offsets), c,
                             itemsize=ct.element_size(), per_component=per)
        return b, f, ct.element_size()
    diag, coef, offsets, x = args[:4]
    c = x.shape[0] if x.ndim == 2 else 1
    rows = diag.shape[0] if diag.ndim == 2 else 1
    b, f = roofline.work(kind, x.shape[-1], len(offsets), c, rows,
                         itemsize=x.element_size())
    return b, f, x.element_size()


class Traced:
    """The profiler over one more chunk of SIMPLE iterations after the
    window; ``summary`` once it has closed."""

    def __init__(self, dia_module=None):
        self.dia_module = dia_module
        self.dia = DiaCalls()
        self.summary = None
        self.iters = 0

    @contextlib.contextmanager
    def __call__(self, sync):
        from torch.profiler import ProfilerActivity, profile
        with contextlib.ExitStack() as stack:
            if self.dia_module is not None:
                stack.enter_context(self.dia.active(self.dia_module))
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
            self.dia.on = True
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                sync()
                wall = time.perf_counter() - t0
                self.dia.on = False
                prof.stop()
                self.summary = summarize(*events_of(prof), wall)


def events_of(prof):
    """(device events, host ops) of a finished profiler session, read from
    the raw kineto events, without building the profiler's FunctionEvent
    tree."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns() * 1e-3, e.duration_ns() * 1e-3
        else:
            s, d = float(e.start_us()), float(e.duration_us())
        if "CUDA" in str(e.device_type()):
            dev.append((e.name(), s, d))
        else:
            host.append((e.name(), s, s + d))
    return dev, host


def _merged(dev):
    spans = sorted((s, s + d) for _, s, d in dev)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_at(starts, host, t, depth=64):
    """The innermost host op running at time t (the latest-starting one
    that covers t among the ``depth`` that start last before it)."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - depth), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "host outside any op"


def summarize(dev, host, wall_s, top=10):
    """The reductions of one traced stage: kernel and sync counts, busy
    and window seconds, the device time by kernel name, the idle gaps by
    what the host was doing, and the device time of each DIA launch."""
    kernels = [e for e in dev if not e[0].startswith(("Memcpy", "Memset"))]
    busy = _merged(dev)
    busy_us = sum(e - s for s, e in busy)
    by_name = {}
    dia = {}
    for name, _, d in sorted(kernels, key=lambda e: e[1]):
        by_name[name] = by_name.get(name, 0.0) + d
        kind = dia_kind(name)
        if kind is not None:
            dia.setdefault(kind, []).append(d * 1e-6)
    host = sorted((h for h in host if not h[0].startswith("ProfilerStep")),
                  key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = {}
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        name = _host_at(starts, host, 0.5 * (e0 + s1))
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0)
    syncs = sum(1 for h in host if h[0] in SYNC_CALLS)
    if syncs == 0:
        syncs = sum(1 for h in host if h[0] == "aten::_local_scalar_dense")

    def ranked(d):
        return [[k, v * 1e-6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"kernels": len(kernels), "syncs": syncs,
            "busy_s": busy_us * 1e-6, "window_s": float(wall_s),
            "device_ops": ranked(by_name), "idle_gaps": ranked(gaps),
            "dia_seconds": dia}
