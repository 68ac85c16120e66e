"""Banded (DIA) matvec kernels K1/K2, their reverse rule K3, and the
autograd Functions that tie them together, with plain torch versions.

K1 ``dia_matvec``:        y[i]   = d[i] x[i] + sum_k c[k,i] x[i + o_k]
K2 ``dia_matvec_multi``:  y[q,i] = d[q,i] x[q,i] + sum_k c[k,i] x[q, i + o_k]

with x zero outside [0, n) and static offsets o_k (at most 64). K2 takes
component-major operands x (C, n) whose components share the band
coefficients; its diagonal is shared (n,) or per component (C, n).

K3 is the reverse rule for a cotangent ct of y:

K3a ``dia_matvec_t`` / ``dia_matvec_multi_t``: x̄ = Aᵀ ct,
    x̄[q,j] = d[q,j] ct[q,j] + sum_k c[k, j - o_k] ct[q, j - o_k];
K3b ``dia_cotangent`` / ``dia_cotangent_multi``: d̄ = ct ⊙ x and
    c̄[k,i] = sum_q ct[q,i] x[q, i + o_k] (d̄ summed over q for a shared
    diagonal, kept per component for a (C, n) one).

``DiaMatvec`` and ``DiaMatvecMulti`` are the ``torch.autograd.Function``s
that every banded matvec of the port goes through: forward K1/K2,
backward K3a (x̄) and K3b (d̄, c̄) for the inputs that need them, jvp
ẏ = A ẋ + Ȧ x as two K1/K2 calls.

These replace the Pallas kernels of ``dafoam_tpu/ops/pallas_kernels.py``
(``dia_matvec``/``dia_matvec_tiled`` for K1, ``dia_matvec_multi``/
``dia_matvec_multi_tiled`` for K2, and the custom-vjp backward rules of
``dia_matvec_ad``/``dia_matvec_multi_ad`` for K3). The CUDA source is
``dafoam_tpu_torch/csrc/dia_matvec.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use and
loaded with ``ctypes``. The build goes to ``dafoam_tpu_torch/_build/``,
keyed on a hash of the source and flags. Importing this module builds and
loads nothing.

Dispatch rule: a wrapper runs its plain version only when the tensors lie
on the CPU. For CUDA tensors it launches the kernel or raises. Both paths
check dtype, shape and contiguity first, so a layout the kernel would
refuse fails on the CPU too. Every launch adds one to
``COUNTS[<wrapper name>]`` and every plain call to ``COUNTS[<plain
name>]``, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
import torch.nn.functional as F

MAX_OFFSETS = 64
MAX_COMPONENTS = 4

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dia_matvec.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNEL_NAMES = ("dia_matvec", "dia_matvec_multi", "dia_matvec_t",
                "dia_matvec_multi_t", "dia_cotangent", "dia_cotangent_multi")
COUNTS = {k + sfx: 0 for k in KERNEL_NAMES for sfx in ("", "_plain")}

_lib = None
_lib_lock = threading.Lock()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


# ---------------------------------------------------------------------------
# plain torch versions (the semantics of pallas_kernels.dia_matvec_reference)
# ---------------------------------------------------------------------------

def _banded(diag, coef, offsets, x):
    """diag*x + sum_k coef[k] * shift(x, o_k) along the last axis, with
    zero padding and static slices."""
    n = x.shape[-1]
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    xp = F.pad(x, (lo, hi))
    y = diag * x
    for k, o in enumerate(offsets):
        y = y + coef[k] * xp[..., lo + o:lo + o + n]
    return y


def dia_matvec_plain(diag, coef, offsets, x):
    """Plain torch K1: x, diag (n,), coef (K, n)."""
    COUNTS["dia_matvec_plain"] += 1
    return _banded(diag, coef, tuple(offsets), x)


def dia_matvec_multi_plain(diag, coef, offsets, x):
    """Plain torch K2: x (C, n), diag (n,) or (C, n), coef (K, n)."""
    COUNTS["dia_matvec_multi_plain"] += 1
    return _banded(diag, coef, tuple(offsets), x)


def _csum(p):
    """Sum over the leading (component) axis in the order 0..C-1."""
    acc = p[0]
    for q in range(1, p.shape[0]):
        acc = acc + p[q]
    return acc


def _shifted(x, offsets):
    """x[..., i + o_k] for each offset, zero outside [0, n)."""
    n = x.shape[-1]
    lo = max(0, -min(offsets)) if offsets else 0
    hi = max(0, max(offsets)) if offsets else 0
    xp = F.pad(x, (lo, hi))
    return [xp[..., lo + o:lo + o + n] for o in offsets]


def _banded_t(diag, coef, offsets, ct):
    """Aᵀ ct = diag*ct + sum_k shift(coef[k] ⊙ ct, -o_k): row j adds
    c[k, j - o_k] ct[j - o_k] in the order k = 0..K-1, zero outside
    [0, n): the products and sums of ``_banded`` on the bands of Aᵀ
    (C'_k[j] = C_k[j - o_k] at offsets -o_k), without building them."""
    n = ct.shape[-1]
    y = diag * ct
    if not offsets:
        return y
    lo = max(0, max(offsets))
    hi = max(0, -min(offsets))
    pp = F.pad(coef * ct[..., None, :], (lo, hi))
    for k, o in enumerate(offsets):
        y = y + pp[..., k, lo - o:lo - o + n]
    return y


def dia_matvec_t_plain(diag, coef, offsets, ct):
    """Plain torch K3a, scalar: Aᵀ ct from A's own bands."""
    COUNTS["dia_matvec_t_plain"] += 1
    return _banded_t(diag, coef, tuple(offsets), ct)


def dia_matvec_multi_t_plain(diag, coef, offsets, ct):
    """Plain torch K3a, component-major: ct (C, n), diag (n,) or (C, n)."""
    COUNTS["dia_matvec_multi_t_plain"] += 1
    return _banded_t(diag, coef, tuple(offsets), ct)


def dia_cotangent_plain(ct, x, offsets):
    """Plain torch K3b, scalar: (d̄ (n,), c̄ (K, n))."""
    COUNTS["dia_cotangent_plain"] += 1
    offsets = tuple(offsets)
    rows = [ct * xs for xs in _shifted(x, offsets)]
    cbar = torch.stack(rows) if rows else x.new_zeros((0, x.shape[-1]))
    return ct * x, cbar


def dia_cotangent_multi_plain(ct, x, offsets, per_component):
    """Plain torch K3b, component-major: d̄ (C, n) when ``per_component``
    else (n,) summed over C, and c̄ (K, n) summed over C."""
    COUNTS["dia_cotangent_multi_plain"] += 1
    offsets = tuple(offsets)
    p = ct * x
    dbar = p if per_component else _csum(p)
    rows = [_csum(ct * xs) for xs in _shifted(x, offsets)]
    cbar = torch.stack(rows) if rows else x.new_zeros((0, x.shape[-1]))
    return dbar, cbar


# ---------------------------------------------------------------------------
# build + bind
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the DIA kernels are "
                       "built from dafoam_tpu_torch/csrc at first use")


def library_path(source: Path = SOURCE) -> Path:
    """Where the built library for ``source`` and the flags lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile a CUDA source of ``csrc/`` unless the library for its hash
    exists. The compiler's report (ptxas registers/spills) is kept beside
    it as ``.log``. Returns the library path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log(source: Path = SOURCE) -> str:
    """The compiler report of the current build ('' before a build)."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            ip = ctypes.POINTER(ctypes.c_int)
            for sfx in ("f32", "f64"):
                for name, args in (
                        ("dia_matvec_", [p, p, ip, i, p, p, ll, p]),
                        ("dia_matvec_multi_", [p, ll, p, ip, i, p, p, i, ll, p]),
                        ("dia_matvec_t_", [p, p, ip, i, p, p, ll, p]),
                        ("dia_matvec_multi_t_",
                         [p, ll, p, ip, i, p, p, i, ll, p]),
                        ("dia_cotangent_", [p, p, ip, i, p, p, ll, p]),
                        ("dia_cotangent_multi_",
                         [p, p, ip, i, p, i, p, i, ll, p])):
                    fn = getattr(lib, name + sfx)
                    fn.argtypes = args
                    fn.restype = i
            _lib = lib
    return _lib


def is_loaded() -> bool:
    return _lib is not None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, x, offsets, operands):
    """Device, dtype, contiguity and shape checks shared by the wrappers.
    ``operands`` maps a label to (tensor, allowed shapes)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on a CUDA device or all "
                         f"on the CPU, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: float32 or float64 only, got {x.dtype}")
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f"{name}: at most {MAX_OFFSETS} offsets, got "
                         f"{len(offsets)}")
    dev, dtype = x.device, x.dtype
    for label, (t, shapes) in operands.items():
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name}: {label} is {t.dtype} on {t.device}, "
                             f"expected {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.shape not in shapes:
            raise ValueError(f"{name}: {label} must be one of {shapes}, got "
                             f"{tuple(t.shape)}")


def _scalar_field(name, x):
    if x.ndim != 1:
        raise ValueError(f"{name}: operand must be (n,), got {tuple(x.shape)}")
    return x.shape[0]


def _component_field(name, x):
    if x.ndim != 2 or not 1 <= x.shape[0] <= MAX_COMPONENTS:
        raise ValueError(f"{name}: operand must be (C, n) with C <= "
                         f"{MAX_COMPONENTS}, got {tuple(x.shape)}")
    return x.shape


# On the card a launch's host time is most of a Krylov iteration's: the
# offsets' C arrays and the entry points are made once, not per call.
_OFFSET_ARGS: dict = {}
_ENTRY: dict = {}


def _offsets_arg(offsets):
    """The C array of ``offsets`` (a tuple of ints), kept per tuple; the
    kernels only read it."""
    arr = _OFFSET_ARGS.get(offsets)
    if arr is None:
        arr = (ctypes.c_int * max(1, len(offsets)))(*offsets)
        _OFFSET_ARGS[offsets] = arr
    return arr


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _launch(name, x, *args):
    """Call the library entry point ``name`` for x's dtype and count it."""
    fn = _ENTRY.get((name, x.dtype))
    if fn is None:
        fn = getattr(_library(), f"{name}_{_SUFFIX[x.dtype]}")
        _ENTRY[(name, x.dtype)] = fn
    rc = fn(*args, _stream(x))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    COUNTS[name] += 1


def _ints(offsets):
    return tuple(map(int, offsets))


def dia_matvec(diag, coef, offsets, x):
    """K1: banded matvec of a scalar field x (n,). Plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    offsets = _ints(offsets)
    n = _scalar_field("dia_matvec", x)
    _check("dia_matvec", x, offsets, {"diag": (diag, ((n,),)),
                                      "coef": (coef, ((len(offsets), n),)),
                                      "x": (x, ((n,),))})
    if x.device.type == "cpu":
        return dia_matvec_plain(diag, coef, offsets, x)
    y = torch.empty_like(x)
    _launch("dia_matvec", x, diag.data_ptr(), coef.data_ptr(),
            _offsets_arg(offsets), len(offsets), x.data_ptr(), y.data_ptr(),
            n)
    return y


def dia_matvec_multi(diag, coef, offsets, x):
    """K2: banded matvec of a component-major field x (C, n) with shared
    bands; diag (n,) shared or (C, n) per component."""
    offsets = _ints(offsets)
    c, n = _component_field("dia_matvec_multi", x)
    _check("dia_matvec_multi", x, offsets,
           {"diag": (diag, ((n,), (c, n))),
            "coef": (coef, ((len(offsets), n),)), "x": (x, ((c, n),))})
    if x.device.type == "cpu":
        return dia_matvec_multi_plain(diag, coef, offsets, x)
    y = torch.empty_like(x)
    _launch("dia_matvec_multi", x, diag.data_ptr(),
            n if diag.ndim == 2 else 0, coef.data_ptr(),
            _offsets_arg(offsets), len(offsets), x.data_ptr(), y.data_ptr(),
            c, n)
    return y


def dia_matvec_t(diag, coef, offsets, ct):
    """K3a: x̄ = Aᵀ ct for a scalar cotangent ct (n,); ``coef`` is A's own
    band array (K, n) at ``offsets``."""
    offsets = _ints(offsets)
    ct = ct.contiguous()
    n = _scalar_field("dia_matvec_t", ct)
    _check("dia_matvec_t", ct, offsets, {"diag": (diag, ((n,),)),
                                         "coef": (coef, ((len(offsets), n),)),
                                         "ct": (ct, ((n,),))})
    if ct.device.type == "cpu":
        return dia_matvec_t_plain(diag, coef, offsets, ct)
    xbar = torch.empty_like(ct)
    _launch("dia_matvec_t", ct, diag.data_ptr(), coef.data_ptr(),
            _offsets_arg(offsets), len(offsets), ct.data_ptr(),
            xbar.data_ptr(), n)
    return xbar


def dia_matvec_multi_t(diag, coef, offsets, ct):
    """K3a, component-major: x̄ = Aᵀ ct for ct (C, n); diag (n,) or
    (C, n)."""
    offsets = _ints(offsets)
    ct = ct.contiguous()
    c, n = _component_field("dia_matvec_multi_t", ct)
    _check("dia_matvec_multi_t", ct, offsets,
           {"diag": (diag, ((n,), (c, n))),
            "coef": (coef, ((len(offsets), n),)), "ct": (ct, ((c, n),))})
    if ct.device.type == "cpu":
        return dia_matvec_multi_t_plain(diag, coef, offsets, ct)
    xbar = torch.empty_like(ct)
    _launch("dia_matvec_multi_t", ct, diag.data_ptr(),
            n if diag.ndim == 2 else 0, coef.data_ptr(),
            _offsets_arg(offsets), len(offsets), ct.data_ptr(),
            xbar.data_ptr(), c, n)
    return xbar


def dia_cotangent(ct, x, offsets):
    """K3b: (d̄, c̄) = (ct ⊙ x, [ct ⊙ shift(x, o_k)]_k) for scalar ct, x."""
    offsets = _ints(offsets)
    ct = ct.contiguous()
    n = _scalar_field("dia_cotangent", ct)
    _check("dia_cotangent", ct, offsets, {"ct": (ct, ((n,),)),
                                          "x": (x, ((n,),))})
    if ct.device.type == "cpu":
        return dia_cotangent_plain(ct, x, offsets)
    dbar = torch.empty_like(ct)
    cbar = ct.new_empty((len(offsets), n))
    _launch("dia_cotangent", ct, ct.data_ptr(), x.data_ptr(),
            _offsets_arg(offsets), len(offsets), dbar.data_ptr(),
            cbar.data_ptr(), n)
    return dbar, cbar


def dia_cotangent_multi(ct, x, offsets, per_component):
    """K3b, component-major: c̄ (K, n) summed over the C components; d̄
    (C, n) when ``per_component``, else (n,) summed over C."""
    offsets = _ints(offsets)
    ct = ct.contiguous()
    c, n = _component_field("dia_cotangent_multi", ct)
    _check("dia_cotangent_multi", ct, offsets, {"ct": (ct, ((c, n),)),
                                                "x": (x, ((c, n),))})
    if ct.device.type == "cpu":
        return dia_cotangent_multi_plain(ct, x, offsets, per_component)
    dbar = ct.new_empty((c, n) if per_component else (n,))
    cbar = ct.new_empty((len(offsets), n))
    _launch("dia_cotangent_multi", ct, ct.data_ptr(), x.data_ptr(),
            _offsets_arg(offsets), len(offsets), dbar.data_ptr(),
            int(bool(per_component)), cbar.data_ptr(), c, n)
    return dbar, cbar


# ---------------------------------------------------------------------------
# autograd Functions: every banded matvec of the port goes through these
# ---------------------------------------------------------------------------

def _tangent_sum(mv, diag, coef, x, ddiag, dcoef, dx):
    """ẏ = A ẋ + Ȧ x as (at most) two forward matvecs."""
    y = None if dx is None else mv(diag, coef, dx.contiguous())
    if ddiag is not None or dcoef is not None:
        dd = torch.zeros_like(diag) if ddiag is None else ddiag.contiguous()
        dc = torch.zeros_like(coef) if dcoef is None else dcoef.contiguous()
        t = mv(dd, dc, x)
        y = t if y is None else y + t
    return torch.zeros_like(x) if y is None else y


class DiaMatvec(torch.autograd.Function):
    """y = K1(diag, coef, x); backward K3a (x̄) and K3b (d̄, c̄) for the
    inputs that need a gradient; jvp A ẋ + Ȧ x through K1."""

    @staticmethod
    def forward(diag, coef, x, offsets):
        return dia_matvec(diag, coef, offsets, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        diag, coef, x, offsets = inputs
        ctx.offsets = _ints(offsets)
        ctx.save_for_backward(diag, coef, x)
        ctx.save_for_forward(diag, coef, x)

    @staticmethod
    def backward(ctx, ct):
        diag, coef, x = ctx.saved_tensors
        need_d, need_c, need_x, _ = ctx.needs_input_grad
        xbar = dia_matvec_t(diag, coef, ctx.offsets, ct) if need_x else None
        dbar = cbar = None
        if need_d or need_c:
            dbar, cbar = dia_cotangent(ct, x, ctx.offsets)
        return (dbar if need_d else None, cbar if need_c else None, xbar,
                None)

    @staticmethod
    def jvp(ctx, ddiag, dcoef, dx, _):
        diag, coef, x = ctx.saved_tensors
        return _tangent_sum(
            lambda d, c, v: dia_matvec(d, c, ctx.offsets, v),
            diag, coef, x, ddiag, dcoef, dx)


class DiaMatvecMulti(torch.autograd.Function):
    """y = K2(diag, coef, x) for component-major x (C, n); backward K3a
    and K3b (d̄ per component for a (C, n) diagonal, summed over C for a
    shared one); jvp through K2."""

    @staticmethod
    def forward(diag, coef, x, offsets):
        return dia_matvec_multi(diag, coef, offsets, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        diag, coef, x, offsets = inputs
        ctx.offsets = _ints(offsets)
        ctx.save_for_backward(diag, coef, x)
        ctx.save_for_forward(diag, coef, x)

    @staticmethod
    def backward(ctx, ct):
        diag, coef, x = ctx.saved_tensors
        need_d, need_c, need_x, _ = ctx.needs_input_grad
        xbar = dia_matvec_multi_t(diag, coef, ctx.offsets, ct) \
            if need_x else None
        dbar = cbar = None
        if need_d or need_c:
            dbar, cbar = dia_cotangent_multi(ct, x, ctx.offsets,
                                             per_component=diag.ndim == 2)
        return (dbar if need_d else None, cbar if need_c else None, xbar,
                None)

    @staticmethod
    def jvp(ctx, ddiag, dcoef, dx, _):
        diag, coef, x = ctx.saved_tensors
        return _tangent_sum(
            lambda d, c, v: dia_matvec_multi(d, c, ctx.offsets, v),
            diag, coef, x, ddiag, dcoef, dx)

