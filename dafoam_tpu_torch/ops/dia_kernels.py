"""Banded (DIA) matvec kernels K1 and K2, with their plain torch versions.

K1 ``dia_matvec``:        y[i]   = d[i] x[i] + sum_k c[k,i] x[i + o_k]
K2 ``dia_matvec_multi``:  y[q,i] = d[q,i] x[q,i] + sum_k c[k,i] x[q, i + o_k]

with x zero outside [0, n) and static offsets o_k (at most 32). K2 takes
component-major operands x (C, n) whose components share the band
coefficients; its diagonal is shared (n,) or per component (C, n).

These replace the Pallas kernels of ``dafoam_tpu/ops/pallas_kernels.py``
(``dia_matvec``/``dia_matvec_tiled`` for K1, ``dia_matvec_multi``/
``dia_matvec_multi_tiled`` for K2). The CUDA source is
``dafoam_tpu_torch/csrc/dia_matvec.cu``; it is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use and
loaded with ``ctypes``. The build goes to ``dafoam_tpu_torch/_build/``,
keyed on a hash of the source and flags. Importing this module builds and
loads nothing.

Dispatch rule: a wrapper runs its plain version only when the tensors lie
on the CPU. For CUDA tensors it launches the kernel or raises. Both paths
check dtype, shape and contiguity first, so a layout the kernel would
refuse fails on the CPU too. Every launch
adds one to ``COUNTS[<wrapper name>]`` and every plain call to
``COUNTS[<plain name>]``, so a run can show which path it took.
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

MAX_OFFSETS = 32
MAX_COMPONENTS = 4

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "dia_matvec.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

COUNTS = {"dia_matvec": 0, "dia_matvec_multi": 0,
          "dia_matvec_plain": 0, "dia_matvec_multi_plain": 0}

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


def library_path() -> Path:
    """Where the built library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"dia_matvec_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the CUDA source unless the library for this source hash
    exists. The compiler's report (ptxas registers/spills) is kept beside
    it as ``.log``. Returns the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler report of the current build ('' before a build)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            ip = ctypes.POINTER(ctypes.c_int)
            for name in ("dia_matvec_f32", "dia_matvec_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, ip, i, p, p, ll, p]
                fn.restype = i
            for name in ("dia_matvec_multi_f32", "dia_matvec_multi_f64"):
                fn = getattr(lib, name)
                fn.argtypes = [p, ll, p, ip, i, p, p, i, ll, p]
                fn.restype = i
            _lib = lib
    return _lib


def is_loaded() -> bool:
    return _lib is not None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check(name, diag, coef, offsets, x, diag_shapes):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors must be on a CUDA device or all "
                         f"on the CPU, got {x.device}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"{name}: float32 or float64 only, got {x.dtype}")
    n = x.shape[-1]
    k = len(offsets)
    if k > MAX_OFFSETS:
        raise ValueError(f"{name}: at most {MAX_OFFSETS} offsets, got {k}")
    for label, t in (("diag", diag), ("coef", coef), ("x", x)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {label} is {t.dtype} on {t.device}, "
                             f"x is {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if tuple(coef.shape) != (k, n):
        raise ValueError(f"{name}: coef must be {(k, n)}, got "
                         f"{tuple(coef.shape)}")
    if tuple(diag.shape) not in diag_shapes:
        raise ValueError(f"{name}: diag must be one of {diag_shapes}, got "
                         f"{tuple(diag.shape)}")


def _offsets_arg(offsets):
    return (ctypes.c_int * max(1, len(offsets)))(*offsets)


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def dia_matvec(diag, coef, offsets, x):
    """K1: banded matvec of a scalar field x (n,). Plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    offsets = tuple(int(o) for o in offsets)
    if x.ndim != 1:
        raise ValueError(f"dia_matvec: x must be (n,), got {tuple(x.shape)}")
    n = x.shape[0]
    _check("dia_matvec", diag, coef, offsets, x, ((n,),))
    if x.device.type == "cpu":
        return dia_matvec_plain(diag, coef, offsets, x)
    fn = getattr(_library(), "dia_matvec_" + _SUFFIX[x.dtype])
    y = torch.empty_like(x)
    rc = fn(diag.data_ptr(), coef.data_ptr(), _offsets_arg(offsets),
            len(offsets), x.data_ptr(), y.data_ptr(), n, _stream(x))
    if rc != 0:
        raise RuntimeError(f"dia_matvec launch failed: cudaError {rc}")
    COUNTS["dia_matvec"] += 1
    return y


def dia_matvec_multi(diag, coef, offsets, x):
    """K2: banded matvec of a component-major field x (C, n) with shared
    bands; diag (n,) shared or (C, n) per component."""
    offsets = tuple(int(o) for o in offsets)
    if x.ndim != 2 or not 1 <= x.shape[0] <= MAX_COMPONENTS:
        raise ValueError(f"dia_matvec_multi: x must be (C, n) with C <= "
                         f"{MAX_COMPONENTS}, got {tuple(x.shape)}")
    c, n = x.shape
    _check("dia_matvec_multi", diag, coef, offsets, x, ((n,), (c, n)))
    if x.device.type == "cpu":
        return dia_matvec_multi_plain(diag, coef, offsets, x)
    d_cstride = n if diag.ndim == 2 else 0
    fn = getattr(_library(), "dia_matvec_multi_" + _SUFFIX[x.dtype])
    y = torch.empty_like(x)
    rc = fn(diag.data_ptr(), d_cstride, coef.data_ptr(),
            _offsets_arg(offsets), len(offsets), x.data_ptr(), y.data_ptr(),
            c, n, _stream(x))
    if rc != 0:
        raise RuntimeError(f"dia_matvec_multi launch failed: cudaError {rc}")
    COUNTS["dia_matvec_multi"] += 1
    return y
