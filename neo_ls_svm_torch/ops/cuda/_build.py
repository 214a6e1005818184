"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all sources at
once in parallel, and the objects are linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library lives under ``build/neo_ls_svm_torch/``
at the root of the checkout, keyed by a hash of the sources and flags, so an edit to a
source rebuilds it and an unchanged tree reuses it. The kernels' TMA maps need
``cuTensorMapEncodeTiled`` from the CUDA driver API, which ``csrc/gemm_sm90.cuh`` fetches
through the runtime's ``cudaGetDriverEntryPoint``, so nothing links ``-lcuda``. Nothing
here runs at import time: the CPU tests import every module without ``nvcc`` or a card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "neo_ls_svm_torch"
_NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)
_LIB_NAME = "libneo_ls_svm_kernels.so"

# The kernel paths of the wrappers: float32 runs the 3×TF32 tensor-core kernels
# (csrc/gram.cu, csrc/sweep.cu, csrc/pass3.cu), and K2 under precision="fast" the one-pass kernels
# (csrc/sweep_1xtf32.cu); float64 runs the FP64 tensor-core (DMMA) ones (csrc/*_fp64.cu).
PATH_TF32 = "3xtf32-wgmma"
PATH_TF32_1 = "1xtf32-wgmma"
PATH_FP64 = "fp64-dmma"

_library: ctypes.CDLL | None = None
build_log = ""  # The compiler's output of the last build (ptxas register/smem report).

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_SIGNATURES = {
    # (X, M, b, s2, y, G, workspace, n, d, D, chunk, splits, kb_per_split, inv_sqrt_d, stream)
    "neo_gram_f32": [_P] * 7 + [_I64, _I32, _I32, _I32, _I32, _I32, ctypes.c_float, _P],
    # (X, M, b, s2, y, G, workspace, n, d, D, chunk, splits, kb_per_split, inv_sqrt_d, stream)
    "neo_gram_f64": [_P] * 7 + [_I64, _I32, _I32, _I32, _I32, _I32, ctypes.c_double, _P],
    # (X, M, b, y, s, s2, Qs, r_all, k, err, obj, workspace, n, d, D, G, chunk,
    #  is_classifier, passes, inv_sqrt_d, inv_c0, stream)
    "neo_sweep_f32": [_P] * 12 + [_I64] + [_I32] * 6 + [ctypes.c_float, ctypes.c_float, _P],
    # (X, M, b, y, s, s2, Qs, r_all, k, err, obj, workspace, n, d, D, G, chunk,
    #  is_classifier, inv_sqrt_d, inv_c0, stream)
    "neo_sweep_f64": [_P] * 12 + [_I64] + [_I32] * 5 + [ctypes.c_double, ctypes.c_double, _P],
    # (X, M, b, y, QB, kr, r, num, sig2, res, workspace, n, d, D, chunk, inv_sqrt_d, inv_c0, stream)
    "neo_pass3_f32": [_P] * 11 + [_I64, _I32, _I32, _I32, ctypes.c_float, ctypes.c_float, _P],
    "neo_error_string": [_I32],
}
_RESTYPES = {"neo_error_string": ctypes.c_char_p}


def _find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for candidate in candidates:
        if candidate.is_file():
            return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        msg = "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)"
        raise RuntimeError(msg)
    return found


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu"))


def _source_key(sources: list[Path]) -> str:
    digest = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in [*sources, *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], out_dir: Path) -> Path:
    """Compile every source in parallel, link them into one library, return its path.

    The objects and the linked library go to a directory of this build's own, so that
    processes that build at the same moment (the ranks of a multi-GPU fit, started
    together) never link each other's half-written objects; the finished library then
    replaces ``out_dir/<lib>`` atomically.
    """
    global build_log
    work = Path(tempfile.mkdtemp(prefix="build-", dir=out_dir))
    try:
        procs = []
        for src in sources:
            obj = work / f"{src.stem}.o"
            cmd = [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out.decode(errors='replace')}")
            if proc.returncode != 0:
                failed.append(src.name)
        build_log = "\n".join(logs)
        if failed:
            msg = f"nvcc failed on {failed}:\n{build_log}"
            raise RuntimeError(msg)
        tmp = work / _LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *[str(obj) for _, obj, _ in procs], "-o", str(tmp)],
            capture_output=True,
            check=False,
        )
        if link.returncode != 0:
            msg = f"nvcc link failed:\n{link.stderr.decode(errors='replace')}"
            raise RuntimeError(msg)
        lib_path = out_dir / _LIB_NAME
        os.replace(tmp, lib_path)  # atomic: a concurrent loader sees the old or the new file
        return lib_path
    finally:
        shutil.rmtree(work, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """Build the kernels' library if its sources changed, load it once, return it."""
    global _library
    if _library is not None:
        return _library
    sources = _sources()
    out_dir = _BUILD_ROOT / _source_key(sources)
    lib_path = out_dir / _LIB_NAME
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        lib_path = _compile(_find_nvcc(), sources, out_dir)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, _I32)
    _library = lib
    return lib


def check_status(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise when a C entry point reports a non-zero ``cudaError_t``."""
    if status != 0:
        reason = lib.neo_error_string(status).decode(errors="replace")
        msg = f"{what} failed with CUDA error {status}: {reason}"
        raise RuntimeError(msg)


def check_operands(X: torch.Tensor, **vectors: torch.Tensor) -> None:
    """Raise unless X and the named tensors are contiguous, on one CUDA device, of one
    float32/float64 dtype (the kernels take nothing else)."""
    if X.device.type != "cuda":
        msg = f"expected CPU or CUDA tensors, got X on {X.device}"
        raise ValueError(msg)
    if X.dtype not in (torch.float32, torch.float64) or X.ndim != 2:
        msg = f"X must be a 2-D float32/float64 tensor, got {X.dtype} with shape {tuple(X.shape)}"
        raise ValueError(msg)
    for name, t in vectors.items():
        if t.device != X.device or t.dtype != X.dtype:
            msg = f"{name} must be {X.dtype} on {X.device}, got {t.dtype} on {t.device}"
            raise ValueError(msg)
        if not t.is_contiguous():
            msg = f"{name} must be contiguous"
            raise ValueError(msg)
    if not X.is_contiguous():
        msg = "X must be contiguous"
        raise ValueError(msg)
