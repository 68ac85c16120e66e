"""Native (C++) host-side parser of OpenFOAM polyMesh payloads, via ctypes.

Port of ``dafoam_tpu.native`` with its own copy of the C++ source
(``ofparse.cpp``). The shared library is built with ``g++`` at first use
into ``dafoam_tpu_torch/_build/`` (keyed on a hash of the source and
flags) and loaded with ctypes; importing this module builds nothing.
``DAFOAM_TPU_NO_NATIVE=1`` turns the native path off (read at every
call); every caller keeps a numpy path, which ``mesh/polymesh.py`` also
takes for binary files.

``COUNTS`` says which path parsed each payload: ``<kind>`` for the native
parser and ``<kind>_numpy`` for the numpy one, kind in labels / points /
faces (``mesh/polymesh.py`` adds the numpy counts). ``reset_counts``
zeroes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "ofparse.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

KINDS = ("labels", "points", "faces")
COUNTS = {k + sfx: 0 for k in KINDS for sfx in ("", "_numpy")}

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"ofparse_{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile the parser unless the library for this source hash exists;
    None when g++ fails. The build goes to a temporary file that is
    renamed into place, because concurrent test workers race the first
    build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _load():
    global _lib, _lib_failed
    if os.environ.get("DAFOAM_TPU_NO_NATIVE") == "1":
        return None
    with _lib_lock:
        if _lib is None and not _lib_failed:
            so = build()
            try:
                lib = ctypes.CDLL(str(so)) if so is not None else None
            except OSError:
                lib = None
            if lib is None:
                _lib_failed = True
                return None
            i64 = ctypes.c_int64
            pi64 = ctypes.POINTER(i64)
            pf64 = ctypes.POINTER(ctypes.c_double)
            lib.of_free.argtypes = [ctypes.c_void_p]
            lib.of_free.restype = None
            lib.of_parse_labels_ascii.argtypes = [
                ctypes.c_char_p, i64, ctypes.POINTER(pi64), pi64]
            lib.of_parse_points_ascii.argtypes = [
                ctypes.c_char_p, i64, ctypes.POINTER(pf64), pi64]
            lib.of_parse_faces_ascii.argtypes = [
                ctypes.c_char_p, i64, ctypes.POINTER(pi64), pi64,
                ctypes.POINTER(pi64), pi64]
            for fn in (lib.of_parse_labels_ascii, lib.of_parse_points_ascii,
                       lib.of_parse_faces_ascii):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _take(lib, ptr, n, dtype) -> np.ndarray:
    """Copy n values out of a buffer the library allocated, then free it."""
    try:
        return np.ctypeslib.as_array(ptr, shape=(int(n),)).astype(
            dtype, copy=True)
    finally:
        lib.of_free(ptr)


def parse_labels_ascii(payload: bytes):
    """int64 label list from an ASCII "N ( ... )" payload, or None."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_int64)()
    n = ctypes.c_int64()
    if lib.of_parse_labels_ascii(payload, len(payload), ctypes.byref(out),
                                 ctypes.byref(n)) != 0:
        return None
    COUNTS["labels"] += 1
    return _take(lib, out, n.value, np.int64)


def parse_points_ascii(payload: bytes):
    """(n, 3) float64 point list from an ASCII payload, or None."""
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_int64()
    if lib.of_parse_points_ascii(payload, len(payload), ctypes.byref(out),
                                 ctypes.byref(n)) != 0:
        return None
    COUNTS["points"] += 1
    return _take(lib, out, 3 * n.value, np.float64).reshape(n.value, 3)


def parse_faces_ascii(payload: bytes):
    """(csr_index (n+1,), flat_verts) from ASCII faces, or None."""
    lib = _load()
    if lib is None:
        return None
    idx = ctypes.POINTER(ctypes.c_int64)()
    flat = ctypes.POINTER(ctypes.c_int64)()
    nidx = ctypes.c_int64()
    nflat = ctypes.c_int64()
    if lib.of_parse_faces_ascii(payload, len(payload), ctypes.byref(idx),
                                ctypes.byref(nidx), ctypes.byref(flat),
                                ctypes.byref(nflat)) != 0:
        return None
    COUNTS["faces"] += 1
    return (_take(lib, idx, nidx.value, np.int64),
            _take(lib, flat, nflat.value, np.int64))
