"""Native host-side components (C++), bound with ctypes.

Counterpart of ``bulklmm_tpu/_native``: the multithreaded numeric CSV
parser (``fastcsv.cpp``, the same source) that :mod:`bulklmm_tpu_torch.io`
uses for genotype and phenotype matrices (the reference gets this from
Julia's compiled DelimitedFiles/CSV stack, reference src/readData.jl). It is
host code, not a device kernel.

The shared library is compiled with ``g++`` at first use into
``build/bulklmm_tpu_torch_native/`` beside the package, named by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is. Each process (and thread) builds to a temporary
name of its own and renames the result into place (atomic within one
directory), so concurrent builders never load a half-written library.
Import never fails: callers check :func:`fastcsv_available` and fall back
to the pure-Python parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bulklmm_tpu_torch_native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libfastcsv_{h.hexdigest()[:16]}.so"


def _compile(lib: Path) -> bool:
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run(
            ["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True, timeout=120
        )
        if res.returncode == 0 and tmp.is_file():
            os.replace(tmp, lib)
            return True
        return False
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib_path = library_path()
        except OSError:  # the source is not shipped
            return None
        if not lib_path.is_file() and not _compile(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.fastcsv_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        lib.fastcsv_dims.restype = ctypes.c_int
        lib.fastcsv_read.argtypes = [
            ctypes.c_char_p, ctypes.c_char, ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.c_long,
        ]
        lib.fastcsv_read.restype = ctypes.c_int
        _lib = lib
        return _lib


def fastcsv_available() -> bool:
    """Whether the native parser built and loaded (never raises)."""
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastcsv library unavailable")
    return lib


def dims(path, *, delim: str = ",", skip_rows: int = 0) -> Tuple[int, int]:
    """(rows, cols) of the numeric block after header skipping."""
    lib = _require()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    if lib.fastcsv_dims(str(path).encode(), delim.encode(), skip_rows,
                        ctypes.byref(rows), ctypes.byref(cols)):
        raise OSError(f"cannot read {path}")
    return rows.value, cols.value


def read_numeric_csv(
    path,
    *,
    delim: str = ",",
    skip_rows: int = 0,
    skip_cols_left: int = 0,
    skip_cols_right: int = 0,
) -> np.ndarray:
    """Parse a numeric CSV into a float64 matrix with the native parser.

    Skips ``skip_rows`` header lines and the given number of leading and
    trailing columns (id and sex columns). Non-numeric cells become NaN.
    Raises ``RuntimeError`` if the native library is unavailable: callers
    gate on :func:`fastcsv_available`.
    """
    lib = _require()
    rows, cols = dims(path, delim=delim, skip_rows=skip_rows)
    out_cols = cols - skip_cols_left - skip_cols_right
    if rows <= 0 or out_cols <= 0:
        return np.empty((max(rows, 0), max(out_cols, 0)), dtype=np.float64)
    out = np.empty((rows, out_cols), dtype=np.float64)
    rc = lib.fastcsv_read(
        str(path).encode(), delim.encode(), skip_rows, skip_cols_left, skip_cols_right,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), rows, out_cols,
    )
    if rc:
        raise OSError(f"fastcsv_read failed on {path} (rc={rc})")
    return out
