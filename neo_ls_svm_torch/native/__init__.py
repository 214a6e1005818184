"""Native (C++) host loops, loaded with ctypes.

Two host-side hot loops of the port are inherently sequential scans: the quantizer's ECDF
knot search (``ops/quantizer.py::_scan_knot``; the reference compiles the same loops with
numba, ``_quantizer.py:18-73``) and the isotonic calibrator's pool-adjacent-violators stack
(``models/isotonic.py``; the reference uses scikit-learn's C implementation). Their C++
versions (``knot_scan.cpp``, ``pav.cpp``) are built with the system C++ compiler at first
use, never at import, into ``build/neo_ls_svm_torch/native-<hash>/`` at the root of the
checkout (the hash is taken over the sources and flags), never next to the sources.

The Python loops stay as the plain versions, and both give identical bits: the C++ runs the
same operations in the same order, with floating-point contraction off. So a machine
without a compiler may take the Python loops, but never unseen: :func:`backend` says which
loops run, ``calls`` counts the native calls, and the fall to Python warns once.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRCS = (_HERE / "knot_scan.cpp", _HERE / "pav.cpp")
_BUILD_ROOT = _HERE.parents[1] / "build" / "neo_ls_svm_torch"
_COMPILERS = ("g++", "c++", "clang++")
# -ffp-contract=off: no fused multiply-add, so the merges round as the Python loop's do.
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LIB_NAME = "libneo_ls_svm_native.so"

_F64 = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.POINTER(ctypes.c_int64)

_library: ctypes.CDLL | None = None
_tried = False
# Tests set this to hold the Python loops against the native ones on identical inputs.
_FORCE_PYTHON = False
build_seconds: float | None = None  # Seconds the compiler took, when this process built.
calls = {"pav_fit": 0, "knot_scan": 0}  # Native calls made by this process.


def _build(out_dir: Path) -> Path | None:
    """Compile the sources into ``out_dir`` with the first compiler that works."""
    global build_seconds
    out_dir.mkdir(parents=True, exist_ok=True)
    for compiler in _COMPILERS:
        # Build into a temporary file and rename it, so that processes that build at
        # the same time each see a whole library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            done = subprocess.run(
                [compiler, *_FLAGS, *(str(s) for s in _SRCS), "-o", tmp],
                capture_output=True,
                timeout=120,
                check=False,
            )
            if done.returncode == 0:
                build_seconds = time.perf_counter() - t0
                lib_path = out_dir / _LIB_NAME
                os.replace(tmp, lib_path)
                return lib_path
        except (OSError, subprocess.SubprocessError):
            pass
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return None


def load() -> ctypes.CDLL | None:
    """Build the library if its sources changed, load it once, return it; None when no
    compiler is available or the library does not load (the callers then run the Python
    loops, and a ``RuntimeWarning`` says so once)."""
    global _library, _tried
    if _tried:
        return _library
    _tried = True
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = _BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"
    lib_path: Path | None = out_dir / _LIB_NAME
    try:
        if not lib_path.is_file():
            lib_path = _build(out_dir)
        if lib_path is not None:
            lib = ctypes.CDLL(str(lib_path))
            lib.knot_scan.restype = ctypes.c_int64
            lib.knot_scan.argtypes = [_F64, _I64, *([ctypes.c_int64] * 4), ctypes.c_int32, _I64]
            lib.pav_fit.restype = None
            lib.pav_fit.argtypes = [_F64, _F64, ctypes.c_int64, _F64, _F64, _F64, _I64]
            _library = lib
    except OSError:
        _library = None
    if _library is None:
        warnings.warn(
            f"neo_ls_svm_torch.native: no C++ compiler among {_COMPILERS} built the host "
            "loops; the Python loops run instead (identical results, slower).",
            RuntimeWarning,
            stacklevel=2,
        )
    return _library


def available() -> bool:
    """True when the native loops are the ones the port runs."""
    return not _FORCE_PYTHON and load() is not None


def backend() -> str:
    """``"native"`` or ``"python"``: which loops ``pool_adjacent_violators`` and the
    quantizer's knot scan run in this process."""
    return "native" if available() else "python"


def _require() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        msg = "the native host loops are not available (no C++ compiler built them)"
        raise RuntimeError(msg)
    return lib


def pav_fit(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Native counterpart of the Python loop of ``models.isotonic.pool_adjacent_violators``."""
    lib = _require()
    y = np.ascontiguousarray(y, dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    if y.shape != w.shape or y.ndim != 1:
        msg = f"y and w must be vectors of one length; got {y.shape} and {w.shape}"
        raise ValueError(msg)  # the C loop would read w out of bounds
    n = len(y)
    out, means, weights = (np.empty(n, dtype=np.float64) for _ in range(3))
    counts = np.empty(n, dtype=np.int64)
    lib.pav_fit(
        *(a.ctypes.data_as(_F64) for a in (y, w)),
        n,
        *(a.ctypes.data_as(_F64) for a in (out, means, weights)),
        counts.ctypes.data_as(_I64),
    )
    calls["pav_fit"] += 1
    return out


def knot_scan(
    xs: np.ndarray,
    ys: np.ndarray,
    knot: int,
    max_bin_error: int,
    max_bin_size: int,
    direction: int,
) -> tuple[int, int]:
    """Native counterpart of ``ops.quantizer._scan_knot`` (identical semantics).

    Callers pass contiguous float64/int64 arrays (the quantizer casts once per histogram),
    so no copy is made here.
    """
    lib = _require()
    if xs.dtype != np.float64 or ys.dtype != np.int64 or len(xs) != len(ys):
        # An explicit raise: the C loop would reinterpret the buffers or read past an end.
        msg = f"knot_scan needs float64/int64 arrays of one length; got {xs.dtype}/{ys.dtype}"
        raise TypeError(msg)
    if not (xs.flags.c_contiguous and ys.flags.c_contiguous):
        msg = "knot_scan needs contiguous arrays"
        raise ValueError(msg)
    count = ctypes.c_int64(0)
    new_knot = lib.knot_scan(
        xs.ctypes.data_as(_F64),
        ys.ctypes.data_as(_I64),
        len(xs),
        knot,
        max_bin_error,
        max_bin_size,
        direction,
        ctypes.byref(count),
    )
    calls["knot_scan"] += 1
    return int(new_knot), int(count.value)
