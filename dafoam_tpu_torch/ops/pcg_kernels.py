"""Vector kernels of the device-resident Jacobi-preconditioned CG
(``linalg.krylov.dia_pcg``), with plain torch versions.

On one solve's vectors x, r, z, p and the inverse diagonal dinv, bound to
a ``PcgState`` with the solve's scalars (the float64 array ``PcgState.s``
on the vectors' device), and the iteration's Ap (all (n,), one dtype,
contiguous):

pcg_init:       z = dinv r, p = z; rz = <r, z>, r0 = ||r||,
                tol = max(rel_tol r0, abs_tol), it = 0,
                live = it < max_iters and r0 > tol
pcg_dot:        alpha = rz / guard(<p, Ap>)
pcg_update:     x += alpha p, r -= alpha Ap, z = dinv r;
                beta = <r, z> / guard(rz), rz = <r, z>, rn = ||r||,
                it += 1, live = it < max_iters and rn > tol
pcg_direction:  p = beta p + z

with ``guard`` the sign-preserving breakdown guard of ``krylov._guard``.
pcg_dot, pcg_update and pcg_direction change nothing when live is 0, so
the iterations a block enqueues after the exit are exact no-ops. The
slots of the state are IT, RN, LIVE, R0, TOL, RZ, ALPHA, BETA and MAXIT;
the first four are what the host reads.

The CUDA source is ``dafoam_tpu_torch/csrc/pcg.cu`` (its note says what
the kernels replace, what bounds them and how they reduce), built with
``dia_kernels.build`` at first use and loaded with ``ctypes``; importing
this module builds and loads nothing. Dispatch as in ``dia_kernels``: the
plain version for CPU tensors, the kernel for CUDA tensors or an error.

The plain versions keep the state in the same float64 array on the CPU
and read and write it through a numpy view, as the kernels read device
memory: no host read of the device and no ``aten`` call. Their scalar
arithmetic is in Python floats rounded to the dtype; in float32 a
division or square root taken in float64 and rounded once is the float32
one, so the plain versions compute krylov.cg's numbers bit for bit.

``COUNTS``: launches and plain calls per name (``krylov.COUNTS`` counts
the solves).
"""

from __future__ import annotations

import array
import ctypes
import math
import threading

import torch

from dafoam_tpu_torch.ops import dia_kernels
from dafoam_tpu_torch.utils.precision import guard_tiny

SOURCE = dia_kernels.SOURCE.with_name("pcg.cu")
KERNEL_NAMES = ("pcg_init", "pcg_dot", "pcg_update", "pcg_direction")
COUNTS = {k + sfx: 0 for k in KERNEL_NAMES for sfx in ("", "_plain")}

# slots of PcgState.s (csrc/pcg.cu: S_*)
IT, RN, LIVE, R0, TOL, RZ, ALPHA, BETA, MAXIT = range(9)
SLOTS = MAXIT + 1

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_lib = None
_max_blocks = None
_lib_lock = threading.Lock()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def _library():
    global _lib, _max_blocks
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(dia_kernels.build(SOURCE)))
            p, ll, d = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
            for sfx in _SUFFIX.values():
                for name, args in (
                        ("pcg_init_", [p, p, p, p, ll, d, d, d, p, p, p, p]),
                        ("pcg_dot_", [p, p, ll, d, p, p, p, p]),
                        ("pcg_update_", [p, p, p, p, p, p, ll, d, p, p, p,
                                         p]),
                        ("pcg_direction_", [p, p, ll, p, p])):
                    fn = getattr(lib, name + sfx)
                    fn.argtypes = args
                    fn.restype = ctypes.c_int
            lib.pcg_max_blocks.argtypes = []
            lib.pcg_max_blocks.restype = ctypes.c_int
            _max_blocks = lib.pcg_max_blocks()
            _lib = lib
    return _lib


def _round_f32(v: float) -> float:
    """v rounded to the nearest float32 (overflow to inf)."""
    return array.array("f", (v,))[0]


class PcgState:
    """One solve's vectors x, r, z, p and dinv (checked here, once) and its
    scalars; on a CUDA device also the kernels' workspace (one partial per
    block of each sum and the ticket that elects the block which forms the
    scalars) and the launch arguments that stay fixed through the solve.
    The kernels update x, r, z and p in place."""

    def __init__(self, x, r, z, p, dinv):
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"PcgState: tensors must be on a CUDA device or "
                             f"on the CPU, got {x.device}")
        if x.dtype not in _SUFFIX:
            raise TypeError(f"PcgState: float32 or float64 only, got "
                            f"{x.dtype}")
        if x.ndim != 1:
            raise ValueError(f"PcgState: vectors must be (n,), got "
                             f"{tuple(x.shape)}")
        self.device, self.dtype, self.shape = x.device, x.dtype, x.shape
        _check(self, "PcgState", x=x, r=r, z=z, p=p, dinv=dinv)
        self.x, self.r, self.z, self.p, self.dinv = x, r, z, p, dinv
        self.n = x.shape[0]
        self.tiny = guard_tiny(x.dtype)
        self.s = torch.empty(SLOTS, dtype=torch.float64, device=x.device)
        if x.device.type == "cpu":
            self.sv = self.s.numpy()
            self.round = float if x.dtype == torch.float64 else _round_f32
            return
        self.sv = None
        lib = _library()
        self.part = torch.empty(2 * _max_blocks, dtype=x.dtype,
                                device=x.device)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        sfx = _SUFFIX[x.dtype]
        self.fn = {k: getattr(lib, f"{k}_{sfx}") for k in KERNEL_NAMES}
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        x, r, z, p, dinv = (t.data_ptr() for t in (x, r, z, p, dinv))
        s, part, ticket = (t.data_ptr() for t in
                           (self.s, self.part, self.ticket))
        work = (s, part, ticket, stream)
        # each launch's fixed arguments: (before, after) the varying ones
        self.args = {
            "pcg_init": ((r, dinv, z, p, self.n), work),
            "pcg_dot": ((p,), (self.n, self.tiny, *work)),
            "pcg_update": ((x, r, z, p), (dinv, self.n, self.tiny, *work)),
            "pcg_direction": ((p, z, self.n, s, stream), ()),
        }


def _check(st, name, **tensors):
    for label, t in tensors.items():
        if t.device != st.device or t.dtype != st.dtype \
                or t.shape != st.shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: {label} must be a contiguous {st.dtype} tensor of "
                f"shape {tuple(st.shape)} on {st.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(st, name, *args):
    head, tail = st.args[name]
    rc = st.fn[name](*head, *args, *tail)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    COUNTS[name] += 1


# ---------------------------------------------------------------------------
# plain torch versions (CPU)
# ---------------------------------------------------------------------------

def _value(t) -> float:
    """The number in a 0-d CPU tensor, read through numpy."""
    return float(t.numpy())


def _guard(v: float, tiny: float) -> float:
    return v if abs(v) > tiny else tiny


def pcg_init_plain(st, max_iters, rel_tol, abs_tol):
    COUNTS["pcg_init_plain"] += 1
    r, z = st.r, st.z
    torch.mul(st.dinv, r, out=z)
    st.p.copy_(z)
    r0 = st.round(math.sqrt(_value(torch.sum(r * r))))
    tol = max(rel_tol * r0, abs_tol)
    sv = st.sv
    sv[IT], sv[RN], sv[LIVE], sv[R0], sv[TOL] = \
        0.0, r0, 0 < max_iters and r0 > tol, r0, tol
    sv[RZ], sv[ALPHA], sv[BETA], sv[MAXIT] = \
        _value(torch.sum(r * z)), 0.0, 0.0, max_iters


def pcg_dot_plain(st, ap):
    COUNTS["pcg_dot_plain"] += 1
    sv = st.sv
    if not sv[LIVE]:
        return
    pap = _value(torch.sum(st.p * ap))
    sv[ALPHA] = st.round(float(sv[RZ]) / _guard(pap, st.tiny))


def pcg_update_plain(st, ap):
    COUNTS["pcg_update_plain"] += 1
    sv = st.sv
    if not sv[LIVE]:
        return
    r, z = st.r, st.z
    alpha = float(sv[ALPHA])
    st.x.add_(alpha * st.p)
    r.sub_(alpha * ap)
    torch.mul(st.dinv, r, out=z)
    rz = _value(torch.sum(r * z))
    rn = st.round(math.sqrt(_value(torch.sum(r * r))))
    sv[BETA] = st.round(rz / _guard(float(sv[RZ]), st.tiny))
    it = float(sv[IT]) + 1.0
    sv[RZ], sv[IT], sv[RN] = rz, it, rn
    sv[LIVE] = it < sv[MAXIT] and rn > sv[TOL]


def pcg_direction_plain(st):
    COUNTS["pcg_direction_plain"] += 1
    sv = st.sv
    if not sv[LIVE]:
        return
    st.p.mul_(float(sv[BETA])).add_(st.z)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def pcg_init(st: PcgState, max_iters, rel_tol, abs_tol):
    """z = dinv r, p = z and the solve's first scalars (see the module
    docstring)."""
    if st.sv is not None:
        return pcg_init_plain(st, max_iters, rel_tol, abs_tol)
    _launch(st, "pcg_init", float(max_iters), float(rel_tol),
            float(abs_tol))


def pcg_dot(st: PcgState, ap):
    """alpha = rz / guard(<p, Ap>) while live."""
    _check(st, "pcg_dot", ap=ap)
    if st.sv is not None:
        return pcg_dot_plain(st, ap)
    _launch(st, "pcg_dot", ap.data_ptr())


def pcg_update(st: PcgState, ap):
    """x += alpha p, r -= alpha Ap, z = dinv r, then beta, rz, rn, it and
    live, while live."""
    _check(st, "pcg_update", ap=ap)
    if st.sv is not None:
        return pcg_update_plain(st, ap)
    _launch(st, "pcg_update", ap.data_ptr())


def pcg_direction(st: PcgState):
    """p = beta p + z while live."""
    if st.sv is not None:
        return pcg_direction_plain(st)
    _launch(st, "pcg_direction")
