"""Drive the PyTorch/CUDA port (``neo_ls_svm_torch``) on one NVIDIA H100 and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits non-zero:

1. ``build``: build (or load) the kernels' library from ``neo_ls_svm_torch/ops/cuda/csrc``.
2. ``gram``: kernel K1 at n = 131,072, d = 32, D = 512 against its plain PyTorch version
   (f32 kernel vs f64 plain: max_ij |ΔG_ij|/√(G_ii·G_jj) ≤ 2e-6; f64 vs f64: ≤ 1e-11),
   with times. The f32 call must go through the 3×TF32 tensor-core path and the f64 call
   through the FP64 tensor-core (DMMA) path (the wrappers count launches by path).
3. ``sweep``: kernel K2 on the same rows, with Qs, λ and k from a real eigendecomposition
   of that Gram and r_all over the 1024-point γ grid, for a regressor and a classifier
   (f32 vs f64 plain: max relative error ≤ 1e-4 and the kernel's argmin within 1e-5 of
   the plain minimum; f64 vs f64: ≤ 1e-10), with times (the f64 kernel's as ``ms_f64``).
   K2's one-pass path
   (``precision="fast"``) on the same tensors, timed beside the 3×TF32 path: LOO error
   within 2e-4 relative of f64, a regressor's objective within 1e-4 (or, where a torch
   emulation of the kernel's rounding on the same inputs is itself further from f64,
   within 2× the emulation's distance: ``check_sweep_fast``), the f64 objective at its
   argmin within 1e-3 of the minimum, and at least 10× the 3×TF32 path's error.
   ``ragged``: both kernels at shapes that are multiples of nothing, at D = 1800, and in
   f64 at D = 4096 (2M = 8194, which the CUDA-core f64 sweep before the DMMA kernels
   refused): neither sweep has a shared-memory limit on D. Under the same tolerances; the
   one-pass path at the f32 shapes, within 2e-4 or within 2× a torch emulation of its own
   rounding.
4. ``parity_small``: a small float64 streaming fit on the card (both kernels) against the
   same fit with ``device="cpu"`` (plain versions): γ equal, LOO arrays at rtol 1e-6.
5. ``fit_1m``: the main path — the default ``NeoLSSVM().fit`` on 1,048,576 × 32 float32
   rows (the device pre-transform, then the streaming route with both kernels), then
   ``predict`` on 65,536 new rows. The fit must report ``pre_transform_ == "device"``. Its
   LOO R² depends on the draw of the Fourier frequencies, so ``fit_1m_draws`` fits 7 more
   ``random_state`` values and holds the mean within 0.01 of 0.7533, the JAX package's
   value on this route at this size, and the default fit within 0.03. The
   kernels' launch counts are set to 0 just before the fit and read just after it, with the
   peak device memory of the fit (bounded by the kernels' row chunks, not by n).
   ``main_path_kernels``: each kernel's output from that fit, against its plain version in
   float64 on the very tensors the fit gave it (the Gram within 1e-5, the sweep as above,
   K3's num, σ² and residual within 1e-5, and K3 launched again for the same bits); then
   each kernel timed on those tensors, K3 beside ``torch.matmul(W, Qs)`` in IEEE float32. The
   ``kernels`` line reports these numbers.
   ``fit_1m_breakdown``: the fit's steps timed one by one (upload, device pre-transform,
   solve, the pull of the result), and one whole fit under torch.profiler for the device's
   idle share. ``fit_1m_host``: the same data with ``pre_transform="host"``, LOO R² within
   0.01 of 0.7437, with the host pre-transform's seconds.
   ``fast``: the default 1M fit under ``precision="fast"`` (same ``random_state``): the
   device pre-transform, K1 once on the 3×TF32 path and K2 once on the one-pass path; γ
   near-optimal under the "high" fit's LOO error (rel 1e-3) and LOO R² within 0.01 of it;
   that K2 call held to f64 on the fit's own tensors under the one-pass limits (those of
   ``sweep``) and timed, beside the time of its three products in cuBLAS TF32 on the same
   tensors (``products_library_ms``, a yardstick the port never calls) and split by
   product from torch.profiler (``split_ms``: Gu, sweep, feature build); a repeat fast fit
   under torch.profiler (device time by kernel, idle share).
   ``fast_262k``: the in-memory route under "fast" (LOO R² within 0.005), and the TF32
   scope: every fit and serving call leaves the caller's ``fp32_precision`` as it found
   it, and a "high" model's ``predict_std`` and ``decision_function`` are bit-equal with
   the caller's TF32 on and off, also after a pickle and a state-dict round trip.
   ``fit_1m_f64``: the 1M rows handed over as float64 (``make_dataset(1 << 20, 32,
   dtype=np.float64)``) through the default ``NeoLSSVM()``: float64 input fits in float64
   and streams from 261,633 rows, so the device pre-transform and K1 and K2 once each on
   the f64 (DMMA) path, counted from 0; LOO R² within 0.03 of 0.7533; first-call and
   repeat seconds; each kernel held to its plain version on the fit's own tensors (1e-11,
   1e-10) and timed there against its bound, K1 also against ``torch.matmul`` in float64;
   the 262,144-row f64 fit (streaming) timed beside the 261,632-row one (in memory).
6. ``pretransform``: ``device_pre_transform`` alone on those rows, timed; its shift and scale
   against the host ``AffineNormalizer`` on the same equal-mass bins (1e-4 of the scale),
   and the rows in each of the 8 bins.
7. ``fit_262k``: the in-memory route at 262,144 rows (no kernel), default estimator: the
   payload is exactly 32 MiB, so the device pre-transform; LOO R² held to 0.7619 likewise;
   and its host-route twin. ``transfer``: the same fit with ``transfer="bfloat16"`` and
   ``"int8"``, LOO R² within 0.03 of the float32 fit.
8. ``fit_dual``: n = 1024, d = 32, float64, a regressor and a classifier on the card
   against ``device="cpu"``: γ equal, α̂ and ``predict`` at rtol 1e-8. ``nan_on_card``: a
   NumPy X with NaN, +inf or −inf at its first or last value, float32 and float64, streaming
   and in memory, raises sklearn's ``ValueError`` from the card's check after the upload,
   and from the host's scan under ``transfer="bfloat16"`` and ``"int8"``, and leaves the
   estimator unfitted.

9. ``native``: the host loops' C++ library (``neo_ls_svm_torch/native``) built with the system
   compiler; ``pav_fit`` on 1,048,576 points and the quantizer's knot scan on the 1M fit's
   target against the Python loops, bit-equal, with both times. Fails if the library did
   not load: on this machine the native loops must be the ones that run.
10. ``calibration``: a default ``NeoLSSVM()`` classifier on the 1M rows with the target cut
    at its median (kernel launches counted from 0). Seconds of the fit, of the first
    ``predict_proba`` on 65,536 held-out rows (which fits the isotonic calibrator: sort,
    PAV) and of a repeat. Probabilities in [0, 1], rows summing to 1, non-decreasing in
    ``decision_function``; held-out Brier score below the base rate's; the tensor lane
    within 1e-6 of the NumPy lane; the same state restored with ``device="cpu"`` within 1e-4
    in ŷ, and in the probabilities within 1e-5 in the mean and 0.01 at the worst row (the
    calibrator's steps magnify the last bits of a float32 ŷ).
11. ``conformal``: the default 1M regressor. ``predict_interval(coverage=0.9)`` on the
    held-out rows, first call (the LPs) and repeat; empirical coverage within [0.87, 0.95];
    ``predict_quantiles`` at seven quantiles non-decreasing on every row inside the convex
    hull of the calibration rows (beyond it the reference's planes may cross; counted);
    ``conformal_method="smooth"`` on the same split: the exact pinball loss of its planes
    within 0.5% of the exact LP's, and the Newton solve's seconds; the tensor lane within
    rtol 1e-5 of the NumPy lane, and its rows per second.
12. ``state_dict``: ``from_state_dict(to_state_dict(m))`` on the card, and a pickle round
    trip, predict bit for bit what ``m`` does (decision, std, probabilities or quantiles).
13. ``tensor_io``: ``fit`` on a CUDA tensor against ``fit`` on the same NumPy rows, three
    fits each in turns: γ equal, LOO R² within 1e-6, the seconds and peak device memory of each.
14. ``mesh``: the multi-GPU route (``neo_ls_svm_torch/parallel``). Four ranks spawned on the
    one card form a gloo group on CUDA tensors (NCCL refuses two ranks on one card; gloo
    passes the sums through the host), sharing ``.npy`` files under ``build/mesh_smoke``.
    (a) ``sharded_primal_fit_streaming`` on a (4, 1) mesh with the 1M fit's own X, M, b and
    y, ``row_chunk`` 16,384: one K1 and one K2 launch on each rank's 262,144 rows, on the
    3×TF32 path, and under ``sweep_precision="fast"`` one K2 a rank on the one-pass path (γ
    near-optimal, LOO R² within 0.01); against ``primal_fit_streaming`` on one GPU, the objective over the γ grid
    within K2's f32 limit (relative 1e-4), the same γ index (or both indices' objectives
    within that limit) and LOO R² within 1e-5; in f64 at 131,072 rows γ equal and β at rtol
    1e-9. ``sharded_device_pre_transform`` on the same rows, each rank its 262,144, with the
    draws of one GPU's seed (made on rank 0 and sent): the per-bin medians bit-equal to one
    GPU's, M and b distances reported, every rank's operands equal to rank 0's, and in f64
    at 131,072 rows every operand within rtol 1e-9. (b) The same fit on (2, 2), the feature
    axis in plain torch: no launch, LOO R² within 1e-5 of (a). (c) ``NeoLSSVM(mesh="auto")``
    on 4,194,304 rows, twice on every rank: the device pre-transform on each rank's
    1,048,576 rows, then K1 and K2 once on them; against the single-GPU default fit, γ as in
    (a), LOO R² within 1e-5, ``predict`` on the 65,536 held-out rows at rtol 1e-4, every
    rank's ``loo_residuals_`` equal to rank 0's; each rank's peak device memory over the
    second fit (rank 0's at most 1.25× the largest other's) and its pre-transform's seconds;
    then three more ``random_state`` values on both sides, their LOO R² distance reported,
    beside one GPU's own distance between the rows as given and reordered at each draw.
    (d) NCCL in a world of one rank: the default 1M fit through the mesh route, γ equal and
    LOO R² within 1e-6 of the single-GPU fit; with two or more cards, NCCL over up to four
    of them with the checks of (c). Four ranks on one card say nothing of scaling.
    ``python3 chip_smoke.py mesh`` runs the build and this phase only.

Then a ``kernels`` line (K1, K2, K3, K2's one-pass path, K1 f64 and K2 f64), the card's name and power limit
as ``nvidia-smi`` reports them, and the result line ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero and prints no result.

The caller's TF32 is on for the whole run (``fp32_precision = "tf32"``, in every mesh rank
too): the port's fits and serving entries must scope their own products, and a cuBLAS
yardstick enters the IEEE scope itself.
"""

import contextlib
import json
import math
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from neo_ls_svm_torch import NeoLSSVM, native
from neo_ls_svm_torch.models import estimator as est
from neo_ls_svm_torch.models.isotonic import _pav_python, pool_adjacent_violators
from neo_ls_svm_torch.models import primal as primal_mod
from neo_ls_svm_torch.models.primal import (
    eigenbasis,
    embed_from_gram_blocks,
    gamma_grid,
    primal_fit_streaming,
)
from neo_ls_svm_torch.ops.cuda import _build
from neo_ls_svm_torch.ops.cuda import gram as gram_mod
from neo_ls_svm_torch.ops import affine as affine_mod
from neo_ls_svm_torch.ops.cuda import pass3 as pass3_mod
from neo_ls_svm_torch.ops.cuda import sweep as sweep_mod
from neo_ls_svm_torch.ops.loo import features_real_pair
from neo_ls_svm_torch.ops.orff import OrthogonalRandomFourierFeatures
from neo_ls_svm_torch.ops.pretransform_device import (
    DEVICE_PRETRANSFORM_BINS,
    _target_codes,
    device_pre_transform,
)
from neo_ls_svm_torch.ops.quantizer import hist_quantized_ecdf, sample_bins_quantized_ecdf
from neo_ls_svm_torch.utils.metrics import r2_score
from neo_ls_svm_torch.utils import profiling
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_torch.utils.transfer import upload_rows

# The JAX package's LOO R² on the same data (accuracy anchors): the 1M fit with the device
# and with the host pre-transform, and the 262k fit on its default (device) route.
LOO_R2_1M_DEVICE, LOO_R2_1M_HOST, LOO_R2_262K = 0.7533, 0.7437, 0.7619
# On the device route the LOO R² moves with the random draw of the 512 Fourier frequencies:
# over random_state 0–6 and 42 its standard deviation is 0.011 at both sizes (NVIDIA H100
# 80GB HBM3), and the JAX package's anchors are one draw each of another generator. So the
# mean over these draws is held to the anchor within 0.01, and one fit within 0.03.
SEEDS, ONE_DRAW_TOL = (0, 1, 2, 3, 4, 5, 6), 0.03
# The smooth conformal solver minimises the LP's objective under more constraints (its planes
# are ordered on an inflated box around the calibration rows, not on those rows only), so its
# exact pinball loss is never below the LP's, and above it by what the box costs on the data.
SMOOTH_GAP_LIMIT = 0.05
# The separator's settings, as the default estimator passes them to device_pre_transform.
PT_KW = {"num_bins": DEVICE_PRETRANSFORM_BINS, "num_features": 512, "edge_sample_size": 384,
         "edge_search_multiplier": 4, "rank_threshold": 2e-2, "is_classifier": False}
N_KERNEL, D_IN, D_FEAT = 131_072, 32, 512
# max_ij |ΔG_ij|/√(G_ii·G_jj), f32 kernel against f64 plain. The f32 error grows with the
# rows each block sums: 7.2e-7 at 131k rows and 5.5e-6 at the 1M fit's 8× longer sums, on
# an H100 SXM, where the row split is fixed by the card's 132 SMs.
GRAM_TOL_F32, GRAM_TOL_F32_1M = 2e-6, 1e-5
# The float64 kernels against their float64 plain versions: the Gram per entry, as above,
# and the sweep's LOO error and objective (relative, elementwise).
GRAM_TOL_F64, SWEEP_TOL_F64 = 1e-11, 1e-10
# K3 (pass 3 of the streaming fit) in float32 against its plain version in float64 on the same
# tensors: num and the residual over the target's sd, σ² over its largest value. A tenth of
# higgs.fit's LOO limit (1e-4); the kernel read 1.0e-6 at 34,002 rows (tests/test_torch_pass3.py).
PASS3_TOL_F32 = 1e-5

# Data-sheet peaks of the H100 SXM, dense: TF32 on the tensor cores, FP32 on the CUDA
# cores, and HBM3 bandwidth. bound_ms on another card needs that card's peaks, so the
# script refuses it.
CARD, TF32_TFLOPS, FP32_TFLOPS, HBM_TBS = "NVIDIA H100 80GB HBM3", 495.0, 67.0, 3.35
# The same data sheet's float64 peaks: the FP64 tensor cores (DMMA) and FP64 FMAs on the
# CUDA cores.
FP64_TC_TFLOPS, FP64_TFLOPS = 67.0, 34.0


def make_dataset(n: int, d: int, seed: int = 0, dtype=np.float32):
    """Synthetic RBF-style regression rows (the same generator as ``bench.py``)."""
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d).astype(dtype)
    y = (
        np.sin(X[:, 0])
        + 0.5 * X[:, 1] * X[:, 2]
        + 0.25 * np.abs(X[:, 3])
        + 0.1 * gen.randn(n)
    ).astype(dtype)
    return X, y


def _kernel_name(mangled: str) -> str:
    """The first length-prefixed name ending in ``_kernel`` in an Itanium-mangled symbol."""
    pos = 0
    while pos < len(mangled):
        digits = re.match(r"\d+", mangled[pos:])
        if digits is None:
            pos += 1
            continue
        start = pos + digits.end()
        name = mangled[start : start + int(digits.group())]
        if name.endswith("_kernel"):
            return name
        pos = start + len(name)
    return mangled[:60]


def ptxas_report(log: str) -> list[dict]:
    """Registers and spilled bytes of each compiled kernel, from nvcc's -Xptxas -v output,
    and ptxas's "Potential Performance Loss" remarks (a wgmma loop it had to serialize)."""
    kernels, current = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        loss = re.search(r"Potential Performance Loss: (.*?) for the function '(\w+)'", line)
        if loss:
            kernels.append({"kernel": _kernel_name(loss.group(2)), "performance_loss": loss.group(1)})
        elif entry:
            current = {"kernel": _kernel_name(entry.group(1))}
            kernels.append(current)
        elif current is not None and "spill stores" in line:
            current["spill_bytes"] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif current is not None and "Used" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return kernels


RECORDS = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.jsonl"


def emit(record: dict) -> None:
    """Print a record as one JSON line, and keep it in ``chiprun_out/chip_smoke.jsonl``."""
    line = json.dumps(record)
    print(line, flush=True)
    RECORDS.parent.mkdir(exist_ok=True)
    with RECORDS.open("a") as out:
        out.write(line + "\n")


def bound(ops: float, nbytes: float, workspace_bytes: float, passes: int = 3) -> dict:
    """The least time for ``ops`` f32 operations of product and ``nbytes`` of HBM traffic.

    ``bound_ms`` is the f32 path's: its products run in ``passes`` TF32 tensor-core passes
    each (3×TF32, or K2's one pass under precision="fast"), so ops at 495/passes TFLOP/s,
    and its bytes include the row chunks' workspace, written once and read once.
    ``fp32_bound_ms`` is the CUDA cores' (ops at 67 TFLOP/s, inputs and outputs only), the
    basis of the earlier kernels' rows.
    """
    ops_ms = ops / (TF32_TFLOPS / passes * 1e9)
    bytes_ms = (nbytes + workspace_bytes) / (HBM_TBS * 1e9)
    fp32_ms = max(ops / (FP32_TFLOPS * 1e9), nbytes / (HBM_TBS * 1e9))
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "fp32_bound_ms": fp32_ms,
        "path": _build.PATH_TF32 if passes == 3 else _build.PATH_TF32_1,
    }


def bound_f64(ops: float, nbytes: float, workspace_bytes: float) -> dict:
    """The least time for ``ops`` f64 operations and ``nbytes`` of inputs and outputs.

    ``bound_ms`` is the larger of the operations on the FP64 tensor cores (67 TFLOP/s) and
    the bytes at 3.35 TB/s; ``fp64_cuda_core_bound_ms`` the same with the operations on the
    CUDA cores' FP64 FMAs (34 TFLOP/s), the basis of the kernels they replaced. The row
    chunks' workspace, written once and read once, is reported beside them as
    ``workspace_ms`` at the HBM rate.
    """
    ops_ms = ops / (FP64_TC_TFLOPS * 1e9)
    bytes_ms = nbytes / (HBM_TBS * 1e9)
    return {
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "fp64_cuda_core_bound_ms": max(ops / (FP64_TFLOPS * 1e9), bytes_ms),
        "workspace_ms": workspace_bytes / (HBM_TBS * 1e9),
        "path": _build.PATH_FP64,
    }


def time_ms(fn, reps: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check(condition: bool, what: str) -> None:
    if not condition:
        raise AssertionError(what)


def rel_err(ours: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |Δ|, max |Δ|/|ref| elementwise) in float64."""
    diff = (ours.double() - ref.double()).abs()
    return float(diff.max()), float((diff / ref.double().abs()).max())


def gram_err(G: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max |ΔG|, max_ij |ΔG_ij|/√(ref_ii·ref_jj)) in float64. Each entry is held against
    the scale Cauchy–Schwarz gives it, so the trig block, about D times smaller than the
    1/y corner, is held as tightly as that corner."""
    diff = (G.double() - ref.double()).abs()
    scale = ref.double().diagonal().sqrt()
    return float(diff.max()), float((diff / (scale[:, None] * scale[None, :])).max())


def gram_timings(args: list[torch.Tensor]) -> dict:
    """K1's, its plain version's and the yardstick's times on these f32 or f64 inputs, and
    its bound."""
    X, M_map, b_map, s2, y = args
    n, d = X.shape
    D = M_map.shape[1]
    K = 2 * D + 2
    f64 = X.dtype == torch.float64
    # The yardstick: one cuBLAS product on a precomputed feature block, in IEEE FP32 (the
    # caller's TF32 is on in this script, so the yardstick enters the IEEE scope itself)
    # or in float64.
    with matmul_precision("ieee"):
        U = X @ M_map + b_map.reshape(1, -1)
    Y = torch.cat(
        [torch.cos(U) / math.sqrt(D), torch.sin(U) / math.sqrt(D), torch.ones_like(y)[:, None], y[:, None]],
        dim=1,
    )
    del U
    s2_col = s2[:, None]

    def library():
        with matmul_precision("ieee"):
            return torch.matmul(Y.T, s2_col * Y)

    record = {
        "ms": time_ms(lambda: gram_mod.fused_augmented_gram(*args)),
        "plain_ms": time_ms(lambda: gram_mod.gram_plain(*args)),
        "library_ms": time_ms(library),
        "library": "torch.matmul(Y.T, s2·Y) on the built features, "
        + ("float64" if f64 else "IEEE FP32 (TF32 off)"),
    }
    ops = n * K * (K + 1) + 2 * n * d * D  # upper triangle + phases
    nbytes = X.element_size() * (n * d + 2 * n + d * D + D + K * K)
    F = -(-K // 128) * 128
    shape = {"n": n, "d": d, "D": D, "dtype": str(X.dtype)[6:]}
    if f64:  # sYᵀ in one f64 plane, written and read
        return {**record, **bound_f64(ops, nbytes, 8 * 2 * F * (-(-n // 32) * 32)), "shape": shape}
    workspace = 4 * 2 * (2 * F * (-(-n // 32) * 32))  # sYᵀ hi and lo, written and read
    return {**record, **bound(ops, nbytes, workspace), "shape": shape}


def one_pass_products_library_ms(args: list[torch.Tensor], rows: int = 131_072) -> float:
    """A yardstick of K2's one pass that the port never calls: its three products, W·Qs,
    (Gu∘k)·r_all and (Gu∘Gu)·r_all, in cuBLAS TF32 on the same tensors, timed alone (CUDA
    events around the products only, ``rows`` rows at a time, summed over the rows), with
    W, Gu∘k and Gu∘Gu built beforehand and no epilogue. The median of three after one
    warm-up."""
    X, M_map, b_map, _, _, _, Qs, r_all, k = args
    D = M_map.shape[1]
    totals = []
    for _ in range(4):
        total = 0.0
        for start in range(0, X.shape[0], rows):
            with matmul_precision("ieee"):
                U = X[start : start + rows] @ M_map + b_map.reshape(1, -1)
            ones = torch.ones((U.shape[0], 1), dtype=U.dtype, device=U.device)
            W = torch.cat([torch.cos(U) / math.sqrt(D), ones, torch.sin(U) / math.sqrt(D), 0 * ones], dim=1)
            with matmul_precision("tf32"):
                Gu = W @ Qs
                Gk, Gg = Gu * k[None, :], Gu * Gu
                start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start_ev.record()
                W @ Qs, Gk @ r_all, Gg @ r_all
                end_ev.record()
            end_ev.synchronize()
            total += start_ev.elapsed_time(end_ev)
        totals.append(total)
    return statistics.median(totals[1:])


def one_pass_split_ms(args: list[torch.Tensor], kw: dict) -> dict:
    """K2's one pass on these inputs split by kernel, device time from torch.profiler on one
    call: its Gu product, its sweep product, its feature build and the rest (transposes,
    the sum over row tiles, copies). The kernels are told apart by name (``gu``, ``loo``,
    ``features``), which also reads a checkout whose kernels are named otherwise."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        sweep_mod.fused_loo_sweep(*args, **kw, precision="fast")
        torch.cuda.synchronize()
    split = {"gu_product_ms": 0.0, "sweep_product_ms": 0.0, "feature_build_ms": 0.0, "other_ms": 0.0}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if us <= 0 or evt.device_type == torch.autograd.DeviceType.CPU:
            continue
        if re.search(r"\bgu_|_gu_", evt.key):
            part = "gu_product_ms"
        elif re.search(r"\bloo_|_loo_", evt.key):
            part = "sweep_product_ms"
        elif "features_kernel" in evt.key:
            part = "feature_build_ms"
        else:
            part = "other_ms"
        split[part] += us / 1e3
    check(split["gu_product_ms"] > 0 and split["sweep_product_ms"] > 0, f"one pass split: {split}")
    return split


def sweep_timings(args: list[torch.Tensor], kw: dict, precision: str = "high") -> dict:
    """K2's and its plain version's times on these f32 or f64 inputs at ``precision``, and
    its bound. Under "fast" the f32 plain version runs its Gu, num and lev products in cuBLAS
    TF32, the one pass the kernel takes; the record adds the yardstick of its three products
    in cuBLAS TF32 (:func:`one_pass_products_library_ms`) and the kernel's split by
    product (:func:`one_pass_split_ms`)."""
    X, M_map = args[0], args[1]
    n, d = X.shape
    D = M_map.shape[1]
    M2, G = args[7].shape
    kw = {k: v for k, v in kw.items() if k != "precision"}  # a recorded call's own precision
    record = {
        "ms": time_ms(lambda: sweep_mod.fused_loo_sweep(*args, **kw, precision=precision)),
        "plain_ms": time_ms(lambda: sweep_mod.sweep_plain(*args, **kw, precision=precision)),
        "library_ms": None,  # no single PyTorch call computes the LOO sweep
    }
    if precision == "fast":
        record["products_library_ms"] = one_pass_products_library_ms(args)
        record["products_library"] = "W·Qs, (Gu∘k)·r_all, (Gu∘Gu)·r_all in cuBLAS TF32, operands built beforehand"
        record["split_ms"] = one_pass_split_ms(args, kw)
    ops = 2 * n * M2 * M2 + 4 * n * M2 * G + 2 * n * d * D
    nbytes = X.element_size() * (n * d + 3 * n + d * D + D + M2 * M2 + M2 * G + M2 + 2 * G)
    Kp, Np, Gp = -(-M2 // 32) * 32, -(-M2 // 128) * 128, -(-G // 128) * 128
    # W, Gu∘k and Gu∘Gu of every row, Qsᵀ and r_allᵀ, in their TF32 planes (hi and lo for
    # 3×TF32, hi for one pass), each written once and read once
    planes = 2 if precision == "high" else 1
    workspace = 4 * 2 * planes * Kp * (3 * n + Np + Gp)
    shape = {"n": n, "d": d, "D": D, "G": G, "dtype": str(X.dtype)[6:]}
    if X.dtype == torch.float64:  # one f64 plane, k to 16, γ to 64
        Kp, Gp = -(-M2 // 16) * 16, -(-G // 64) * 64
        return {**record, **bound_f64(ops, nbytes, 8 * 2 * Kp * (3 * n + Np + Gp)), "shape": shape}
    return {**record, **bound(ops, nbytes, workspace, 3 if precision == "high" else 1), "shape": shape}


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_product(A: torch.Tensor, B: torch.Tensor, passes: int) -> torch.Tensor:
    """A·B as the kernels' product loops compute it, on hi = tf32(v), lo = tf32(v − hi).
    Three passes (``csrc/gemm_sm90.cuh``): the contraction in k-blocks of 32, each one run
    of lo·hi + hi·lo + hi·hi, the runs added in order into a float32 sum. One pass
    (``csrc/gemm_sm90_1xtf32.cuh``): hi·hi, the whole contraction one run."""
    A_hi, B_hi = _tf32(A), _tf32(B)
    with matmul_precision("ieee"):
        if passes == 1:
            return A_hi @ B_hi
        pad = (-A.shape[1]) % 32
        A = torch.nn.functional.pad(A, (0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        A_hi, B_hi = _tf32(A), _tf32(B)
        A_lo, B_lo = _tf32(A - A_hi), _tf32(B - B_hi)
        total = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.float32, device=A.device)
        for k0 in range(0, A.shape[1], 32):
            ks = slice(k0, k0 + 32)
            total += A_lo[:, ks] @ B_hi[ks] + A_hi[:, ks] @ B_lo[ks] + A_hi[:, ks] @ B_hi[ks]
    return total


@matmul_precision("ieee")
def emulated_sweep(X, M_map, b_map, y, s, s2, Qs, r_all, k, *, is_classifier: bool, inv_c0: float,
                   passes: int, chunk_rows: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's float32 arithmetic in torch: the features in IEEE f32, then Gu = W·Qs, num and
    lev in ``passes`` TF32 passes each (:func:`tf32_product`), then the kernel's epilogue.
    The rounding of the kernel's products, without its order of summation: the yardstick a
    one-pass result is held to where float64 says more about the data than about the
    kernel."""
    D = M_map.shape[1]
    err = torch.zeros(r_all.shape[1], dtype=torch.float32, device=X.device)
    obj = torch.zeros_like(err)
    for start in range(0, X.shape[0], chunk_rows):
        rows = slice(start, start + chunk_rows)
        U = X[rows] @ M_map + b_map.reshape(1, -1)
        ones = torch.ones((U.shape[0], 1), dtype=U.dtype, device=U.device)
        W = torch.cat([torch.cos(U) / math.sqrt(D), ones, torch.sin(U) / math.sqrt(D), 0 * ones], dim=1)
        Gu = tf32_product(W, Qs, passes)
        num = inv_c0 * tf32_product(Gu * k[None, :], r_all, passes)
        lev = inv_c0 * s2[rows, None] * tf32_product(Gu * Gu, r_all, passes)
        y_b = y[rows, None]
        e = (num - y_b) / (1.0 - lev)
        if is_classifier:
            e = torch.where(((y_b > 0) & (e > 0)) | ((y_b < 0) & (e < 0)), torch.zeros_like(e), e)
        abs_e = torch.abs(e)
        err_b = s[rows] @ abs_e
        err += err_b
        obj += err_b + (s[rows] @ (abs_e >= 1).float() + s[rows] @ torch.clamp(abs_e - 1, min=0.0)
                        if is_classifier else 0.0)
    return err, obj


def phase_gram(dev: torch.device) -> dict:
    X, y = make_dataset(N_KERNEL, D_IN, seed=0)
    fmap = OrthogonalRandomFourierFeatures(num_features=D_FEAT).fit(X, y)
    M_map, b_map = (a.astype(np.float32) for a in fmap.linear_map())
    s = np.full(N_KERNEL, 1.0 / N_KERNEL, np.float32)
    f32 = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in
           {"X": X, "M_map": M_map, "b_map": b_map, "s": s, "s2": s * s, "y": y}.items()}
    f64 = {k: v.double() for k, v in f32.items()}
    args32 = [f32[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    args64 = [f64[k] for k in ("X", "M_map", "b_map", "s2", "y")]
    before = dict(gram_mod.path_launches)
    G32 = gram_mod.fused_augmented_gram(*args32)
    G64 = gram_mod.fused_augmented_gram(*args64)
    took = {p: gram_mod.path_launches[p] - before[p] for p in before}
    check(took == {_build.PATH_TF32: 1, _build.PATH_FP64: 1}, f"gram: the f32 and f64 calls took {took}")
    plain64 = gram_mod.gram_plain(*args64)
    torch.cuda.synchronize()
    abs32, rel32 = gram_err(G32, plain64)
    _, rel64 = gram_err(G64, plain64)
    check(math.isfinite(rel32) and rel32 <= GRAM_TOL_F32, f"gram f32: max|ΔG_ij|/√(G_ii·G_jj) = {rel32}")
    check(rel64 <= GRAM_TOL_F64, f"gram f64: max|ΔG_ij|/√(G_ii·G_jj) = {rel64}")
    emit({
        "phase": "gram",
        "max_abs_err": abs32,
        "max_rel_err": rel32,
        "max_rel_err_f64": rel64,
        "ms_f64": time_ms(lambda: gram_mod.fused_augmented_gram(*args64)),
        **gram_timings(args32),
    })
    return {"f32": f32, "G32": G32}


@matmul_precision("ieee")
def _sweep_inputs(G: torch.Tensor, n: int, D: int, num_gammas: int) -> dict:
    """Qs, λ, k and r_all from a real eigendecomposition of an augmented Gram."""
    dev, dtype = G.device, G.dtype
    G_W, b_vec = gram_mod.w_basis_from_augmented(G, D)
    M = D + 1
    basis = eigenbasis(embed_from_gram_blocks(G_W, M), b_vec, None, n)
    gammas = torch.from_numpy(gamma_grid(np.float64, num=num_gammas)).to(dev, dtype)
    return {
        "Qs": basis.Qs.contiguous(),
        "r_all": (1.0 / (gammas[None, :] + basis.lam[:, None])).contiguous(),
        "k": basis.k.contiguous(),
        "inv_c0": float(n * M),
    }


def phase_ragged(dev: torch.device) -> None:
    """Both kernels at shapes that are multiples of nothing (the masked edges), and at wide
    D (1800 in both dtypes; 4096 in f64, which the CUDA-core f64 sweep that the DMMA kernel
    replaced refused for shared memory), against their plain versions.
    Each case also reports how far the f32 plain version's sweep is from float64, the
    yardstick for the f32 kernel's error. K2's one-pass path runs at the f32 shapes too,
    under :func:`check_sweep_fast` with the torch emulation of its rounding on the same
    inputs: at few rows per feature the leverages come near 1, and 1/(1 − lev) magnifies
    one pass's rounding in every implementation of it; the emulation says how much."""
    results = []
    # At D = 1800 the f32 case takes 20,011 rows: at 4,099 rows the leverages of 2M = 3602
    # features come so close to 1 that even the f32 plain version is far off float64
    # (its sweep_plain_f32_rel_err), a property of the data, not of the kernel. The f64
    # case at D = 4096 (2M = 8194) keeps the 4,099-row case's ratio of rows to 2M, 1.14.
    for n, d, D, G, dtypes in ((3001, 7, 100, 1001, (torch.float32, torch.float64)),
                               (4099, 5, 1800, 130, (torch.float64,)),
                               (20011, 5, 1800, 130, (torch.float32,)),
                               (9337, 5, 4096, 77, (torch.float64,))):
        gen = np.random.RandomState(n)
        X = gen.randn(n, d)
        M_map = gen.randn(d, D)
        b_map = gen.uniform(0, 2 * np.pi, (1, D))
        y = np.sin(X[:, 0]) + 0.1 * gen.randn(n)
        w = gen.rand(n) + 0.25
        s = w / w.sum()
        host = {"X": X, "M_map": M_map, "b_map": b_map, "y": y, "s": s, "s2": s * s}
        t64 = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in host.items()}
        G64 = gram_mod.gram_plain(*(t64[k] for k in ("X", "M_map", "b_map", "s2", "y")))
        sw64 = _sweep_inputs(G64, n, D, G)
        plain_args = [t64[k] for k in ("X", "M_map", "b_map", "y", "s", "s2")]
        plain_args += [sw64[k] for k in ("Qs", "r_all", "k")]
        plain_kw = {"is_classifier": False, "inv_c0": sw64["inv_c0"]}
        plain64 = sweep_mod.sweep_plain(*plain_args, **plain_kw)
        plain32 = sweep_mod.sweep_plain(*(a.float() for a in plain_args), **plain_kw)
        plain32_rel = max(rel_err(a, b)[1] for a, b in zip(plain32, plain64))
        for dtype in dtypes:
            t = {k: v.to(dtype) for k, v in t64.items()}
            sw = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v) for k, v in sw64.items()}
            gram_args = [t[k] for k in ("X", "M_map", "b_map", "s2", "y")]
            G_k = gram_mod.fused_augmented_gram(*gram_args)
            G_p = gram_mod.gram_plain(*(a.double() for a in gram_args))
            _, gram_rel = gram_err(G_k, G_p)
            sweep_args = [t[k] for k in ("X", "M_map", "b_map", "y", "s", "s2")]
            sweep_args += [sw[k] for k in ("Qs", "r_all", "k")]
            kw = {"is_classifier": False, "inv_c0": sw["inv_c0"]}
            err_k, obj_k = sweep_mod.fused_loo_sweep(*sweep_args, **kw)
            err_p, obj_p = sweep_mod.sweep_plain(*(a.double() for a in sweep_args), **kw)
            torch.cuda.synchronize()
            sweep_rel = max(rel_err(err_k, err_p)[1], rel_err(obj_k, obj_p)[1])
            tol_gram, tol_sweep = (GRAM_TOL_F32, 1e-4) if dtype == torch.float32 else (GRAM_TOL_F64, SWEEP_TOL_F64)
            tag = f"ragged n={n} d={d} D={D} G={G} {dtype}"
            check(gram_rel <= tol_gram, f"{tag}: gram relative error {gram_rel}")
            check(sweep_rel <= tol_sweep, f"{tag}: sweep relative error {sweep_rel}")
            case = {"n": n, "d": d, "D": D, "G": G, "dtype": str(dtype).split(".")[-1],
                    "gram_rel_err": gram_rel, "sweep_rel_err": sweep_rel, "sweep_plain_f32_rel_err": plain32_rel}
            if dtype == torch.float32:
                before = sweep_mod.path_launches[_build.PATH_TF32_1]
                err_1, obj_1 = sweep_mod.fused_loo_sweep(*sweep_args, **kw, precision="fast")
                check(sweep_mod.path_launches[_build.PATH_TF32_1] == before + 1, f"{tag}: no one-pass launch")
                emulated = emulated_sweep(*sweep_args, **kw, passes=1)
                torch.cuda.synchronize()
                case["one_pass"] = {
                    **check_sweep_fast(err_1, obj_1, err_p, obj_p, rel_err(err_k, err_p)[1], False, tag, emulated),
                    "ms": time_ms(lambda: sweep_mod.fused_loo_sweep(*sweep_args, **kw, precision="fast")),  # noqa: B023
                    "ms_3xtf32": time_ms(lambda: sweep_mod.fused_loo_sweep(*sweep_args, **kw)),  # noqa: B023
                }
            results.append(case)
    emit({"phase": "ragged", "cases": results})


def check_sweep_f32(err32, obj32, perr, pobj, tag: str) -> tuple[float, float, float]:
    """Hold an f32 sweep against its f64 plain version: (max |Δ|, max relative error,
    the plain objective's gap at the kernel's argmin, relative to the plain minimum)."""
    worst_abs, worst_rel = 0.0, 0.0
    for ours, ref in ((err32, perr), (obj32, pobj)):
        a, r = rel_err(ours, ref)
        check(math.isfinite(r) and r <= 1e-4, f"sweep {tag} f32: max relative error {r}")
        worst_abs, worst_rel = max(worst_abs, a), max(worst_rel, r)
    p_min = float(pobj.min())
    gap = abs(float(pobj[int(torch.argmin(obj32))]) - p_min) / abs(p_min)
    check(gap <= 1e-5, f"sweep {tag}: kernel argmin objective {gap} from the plain minimum")
    return worst_abs, worst_rel, gap


# K2's one-pass path (precision="fast") against float64: the LOO error (relative), a
# regressor's objective (relative), and the float64 objective at the kernel's argmin
# against its minimum. The fixed LOO error limit is 2.5× the worst of the torch emulation
# of the kernel's rounding at n = 2048 (tests/test_torch_kernels.py, 7.9e-5). On this
# script's larger operands that emulation (:func:`emulated_sweep`) can itself lie past the
# fixed limits: one pass rounds the shared Qs and r_all once for all rows, so its error
# does not average out over them and depends on the data. Each relative limit is
# therefore the larger of the fixed one and 2× the emulation's own distance on the same
# inputs, computed here on the card and reported beside each reading.
# A classifier's objective adds s·[|e| ≥ 1], a step that one pass flips on rows near
# |e| = 1, so it is held by its argmin. One pass must also be at least 10× further from
# float64 than the 3×TF32 path on the same tensors, or the path did not take one pass.
FAST_ERR_TOL, FAST_OBJ_TOL, FAST_ARGMIN_TOL, FAST_MIN_RATIO = 2e-4, 1e-4, 1e-3, 10.0


def check_sweep_fast(err1, obj1, perr, pobj, err3_rel: float, is_classifier: bool, tag: str,
                     emulated: tuple) -> dict:
    """Hold a one-pass f32 sweep against its f64 plain version, the (err, obj) of
    :func:`emulated_sweep` on the same inputs, and the 3×TF32 path's error on the same
    tensors; the readings."""
    err_abs, err_rel = rel_err(err1, perr)
    obj_abs, obj_rel = rel_err(obj1, pobj)
    emu_err, emu_obj = rel_err(emulated[0], perr)[1], rel_err(emulated[1], pobj)[1]
    err_tol, obj_tol = max(FAST_ERR_TOL, 2.0 * emu_err), max(FAST_OBJ_TOL, 2.0 * emu_obj)
    readings = {"emulated_loo_err_rel_err": emu_err, "emulated_objective_rel_err": emu_obj,
                "loo_err_limit": err_tol, "objective_limit": None if is_classifier else obj_tol}
    check(math.isfinite(err_rel) and err_rel <= err_tol, f"sweep {tag} one pass: LOO error relative error {err_rel} > {err_tol}")
    if not is_classifier:
        check(obj_rel <= obj_tol, f"sweep {tag} one pass: objective relative error {obj_rel} > {obj_tol}")
    p_min = float(pobj.min())
    gap = abs(float(pobj[int(torch.argmin(obj1))]) - p_min) / abs(p_min)
    check(gap <= FAST_ARGMIN_TOL, f"sweep {tag} one pass: argmin objective {gap} from the plain minimum")
    check(err_rel >= FAST_MIN_RATIO * err3_rel, f"sweep {tag}: one pass {err_rel} is not 10× 3×TF32's {err3_rel}")
    return {"max_abs_err": max(err_abs, obj_abs), "loo_err_rel_err": err_rel, "objective_rel_err": obj_rel,
            "argmin_objective_gap": gap, "ratio_to_3xtf32": err_rel / err3_rel, **readings}


def phase_sweep(data: dict) -> None:
    f32 = data["f32"]
    worst_abs, worst_rel, worst_rel64, argmin_gap = 0.0, 0.0, 0.0, 0.0
    timings, fast = {}, {}
    for task in ("regressor", "classifier"):
        is_classifier = task == "classifier"
        y32 = f32["y"]
        if is_classifier:
            y32 = torch.where(y32 > y32.median(), 1.0, -1.0).to(torch.float32).contiguous()
        G = data["G32"] if not is_classifier else gram_mod.fused_augmented_gram(
            f32["X"], f32["M_map"], f32["b_map"], f32["s2"], y32
        )
        sw32 = _sweep_inputs(G, N_KERNEL, D_FEAT, 1024)
        args32 = [f32["X"], f32["M_map"], f32["b_map"], y32, f32["s"], f32["s2"]]
        args32 += [sw32[k] for k in ("Qs", "r_all", "k")]
        args64 = [a.double() for a in args32]
        kw = {"is_classifier": is_classifier, "inv_c0": sw32["inv_c0"]}
        before = dict(sweep_mod.path_launches)
        err32, obj32 = sweep_mod.fused_loo_sweep(*args32, **kw)
        err1, obj1 = sweep_mod.fused_loo_sweep(*args32, **kw, precision="fast")
        err64, obj64 = sweep_mod.fused_loo_sweep(*args64, **kw)
        took = {p: sweep_mod.path_launches[p] - before[p] for p in before}
        check(took == {_build.PATH_TF32: 1, _build.PATH_TF32_1: 1, _build.PATH_FP64: 1},
              f"sweep {task}: the f32, one-pass and f64 calls took {took}")
        perr, pobj = sweep_mod.sweep_plain(*args64, **kw)
        torch.cuda.synchronize()
        a, r, gap = check_sweep_f32(err32, obj32, perr, pobj, task)
        worst_abs, worst_rel, argmin_gap = max(worst_abs, a), max(worst_rel, r), max(argmin_gap, gap)
        emulated = emulated_sweep(*args32, **kw, passes=1)
        fast[task] = check_sweep_fast(err1, obj1, perr, pobj, rel_err(err32, perr)[1], is_classifier, task, emulated)
        for ours, ref in ((err64, perr), (obj64, pobj)):
            _, r = rel_err(ours, ref)
            check(r <= SWEEP_TOL_F64, f"sweep {task} f64: max relative error {r}")
            worst_rel64 = max(worst_rel64, r)
        timings[task] = sweep_timings(args32, kw)
        timings[task]["ms_f64"] = time_ms(lambda: sweep_mod.fused_loo_sweep(*args64, **kw))  # noqa: B023
        fast[task].update({k: v for k, v in sweep_timings(args32, kw, "fast").items() if k != "shape"})
    emit({
        "phase": "sweep",
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "max_rel_err_f64": worst_rel64,
        "argmin_objective_gap": argmin_gap,
        **timings["regressor"],
        "ms_classifier": timings["classifier"]["ms"],
        "ms_f64_classifier": timings["classifier"]["ms_f64"],
        "one_pass": fast,
    })


def phase_parity_small(dev: torch.device) -> None:
    """A float64 streaming fit on the card (kernels) against the CPU fit (plain)."""
    X, y = make_dataset(8192, D_IN, seed=2, dtype=np.float64)
    saved = est.STREAMING_BYTES_THRESHOLD, est.STREAMING_ROW_CHUNK
    est.STREAMING_BYTES_THRESHOLD, est.STREAMING_ROW_CHUNK = 0, 2048
    try:
        before = gram_mod.launches, sweep_mod.launches
        card = NeoLSSVM(device=dev).fit(X, y)
        check(gram_mod.launches > before[0] and sweep_mod.launches > before[1], "parity fit skipped a kernel")
        host = NeoLSSVM(device="cpu").fit(X, y)
    finally:
        est.STREAMING_BYTES_THRESHOLD, est.STREAMING_ROW_CHUNK = saved
    check(card.γ_ == host.γ_, f"parity: γ {card.γ_} on the card vs {host.γ_} on the CPU")
    worst = 0.0
    for attr in ("loo_residuals_", "loo_std_", "residuals_", "loo_errors_γs_"):
        a, b = getattr(card, attr), getattr(host, attr)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-10, err_msg=attr)
        worst = max(worst, float(np.max(np.abs(a - b))))
    emit({"phase": "parity_small", "n": 8192, "dtype": "float64", "gamma": card.γ_,
          "loo_score": card.loo_score_, "max_abs_diff": worst})


def pt_generator(dev: torch.device) -> torch.Generator:
    generator = torch.Generator(device=dev)
    generator.manual_seed(42)
    return generator


def hold_to_anchor(X, y, dev: torch.device, default_loo: float, anchor: float, tag: str) -> dict:
    """Fit the device route under the other random_state values and hold the mean LOO R² of
    all draws, the default fit's included, to the anchor."""
    by_state = {42: default_loo}
    for seed in SEEDS:
        by_state[seed] = NeoLSSVM(device=dev, random_state=seed).fit(X, y).loo_score_
    mean = statistics.fmean(by_state.values())
    check(abs(default_loo - anchor) <= ONE_DRAW_TOL, f"{tag}: LOO R² {default_loo} vs {anchor}")
    check(abs(mean - anchor) <= 0.01, f"{tag}: mean LOO R² {mean} over {len(by_state)} draws vs {anchor}")
    return {"loo_score_by_random_state": by_state, "loo_score_mean": mean,
            "loo_score_sd": statistics.stdev(by_state.values()), "loo_anchor": anchor}


def timed(fn):
    """(seconds on the host clock until the device has finished, the result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def breakdown_1m(X: np.ndarray, y: np.ndarray, dev: torch.device) -> dict:
    """Where the default 1M fit's time goes: its steps one by one by wall clock, each ended
    by a synchronise, then one whole fit under torch.profiler (device time by kernel, and
    the device's idle share over the whole fit)."""
    ones = np.ones_like(y)
    upload_s, (X_d, y_d, s_d, g_d) = timed(
        lambda: (upload_rows(X, "float32", dev), *(est._to_device(a, dev) for a in (y, ones, gamma_grid(np.float32))))
    )
    pt_s, pt = timed(lambda: device_pre_transform(X_d, y_d, s_d, pt_generator(dev), **PT_KW))
    kw = {"is_classifier": False, "row_chunk": est.STREAMING_ROW_CHUNK, "num_samples": len(y)}
    solve_s, result = timed(lambda: primal_fit_streaming(X_d, pt["M"], pt["b"], y_d, s_d, g_d, None, **kw))
    pull_s, _ = timed(lambda: {k: v.cpu().numpy() for k, v in {**result, **pt}.items()})
    del X_d, result, pt
    return {
        "upload_s": upload_s,
        "device_pretransform_s": pt_s,
        "solve_s": solve_s,
        "pull_s": pull_s,
        **profiled_fit(X, y, dev),
    }


def profiled_fit(X, y, dev: torch.device, **params) -> dict:
    """One whole ``NeoLSSVM(**params).fit`` under torch.profiler: its seconds, the device
    time by kernel and the device's idle share over the fit."""
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        profiled_s, _ = timed(lambda: NeoLSSVM(device=dev, **params).fit(X, y))
    kernels = []  # device kernels only: an operator's device time is its kernels' again
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", 0) or getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.device_type != torch.autograd.DeviceType.CPU:
            kernels.append({"name": evt.key[:90], "ms": us / 1e3, "calls": evt.count})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(k["ms"] for k in kernels)
    return {
        "profiled_fit_s": profiled_s,
        "device_busy_ms": device_ms,
        "device_idle_share": 1.0 - device_ms / (profiled_s * 1e3),
        "top_kernels": kernels[:12],
    }


def phase_pretransform(X: np.ndarray, y: np.ndarray, dev: torch.device) -> None:
    """device_pre_transform alone at 1M × 32 float32: its time, its bins, and its shift and
    scale against the host normalizer on the same bins."""
    X_d, y_d = upload_rows(X, "float32", dev), est._to_device(y, dev)
    w_d = torch.ones_like(y_d)
    run = lambda: device_pre_transform(X_d, y_d, w_d, pt_generator(dev), **PT_KW)  # noqa: E731
    run()
    seconds = statistics.median(timed(run)[0] for _ in range(5))
    pt = run()
    codes, totals = _target_codes(y_d, w_d, num_bins=PT_KW["num_bins"], is_classifier=False)
    codes = codes.cpu().numpy()
    masks = [codes == b for b in range(PT_KW["num_bins"])]
    weights = np.ones_like(y)

    def equal_mass_bins(_y, _weights):  # what affine._bin_by_target returns, for these codes
        return masks, [float(m.sum()) for m in masks], [weights[np.newaxis, m] / m.sum() for m in masks]

    original = affine_mod._bin_by_target
    affine_mod._bin_by_target = equal_mass_bins
    try:
        t0 = time.perf_counter()
        host = affine_mod.AffineNormalizer().fit(X, y)
        host_s = time.perf_counter() - t0
    finally:
        affine_mod._bin_by_target = original
    shift, scale = pt["pt_shift"].cpu().numpy(), pt["pt_scale"].cpu().numpy()
    shift_err = float(np.max(np.abs(shift - host.shift_) / np.abs(host.scale_)))
    scale_err = float(np.max(np.abs(scale - host.scale_) / np.abs(host.scale_)))
    check(shift_err <= 1e-4 and scale_err <= 1e-4, f"pretransform: shift {shift_err}, scale {scale_err} off the host's")
    finite = all(bool(torch.isfinite(v).all()) for v in pt.values())
    check(finite and pt["M"].shape == (D_IN, D_FEAT), "pretransform: bad operands")
    emit({"phase": "pretransform", "n": len(y), "d": D_IN, "dtype": "float32", "device_pretransform_s": seconds,
          "host_normalizer_same_bins_s": host_s, "shift_err_over_scale": shift_err, "scale_rel_err": scale_err,
          "rows_per_bin": [int(m.sum()) for m in masks], "bin_mass": totals.cpu().tolist(),
          "kept_columns": int((pt["pt_A"] != 0).any(dim=0).sum())})


@contextlib.contextmanager
def recording_kernel_calls():
    """Record the arguments and result of each kernel call the streaming solver makes, so
    the main path's own tensors can be held against the plain versions after the fit."""
    calls = {}
    names = ("fused_augmented_gram", "fused_loo_sweep", "fused_pass3")
    originals = {name: getattr(primal_mod, name) for name in names}

    def recorder(name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name] = (args, kwargs, out)
            return out

        return call

    for name, fn in originals.items():
        setattr(primal_mod, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(primal_mod, name, fn)


def pass3_errors(out: tuple, ref: tuple, y: torch.Tensor) -> list[float]:
    """K3's (num, σ², residual) against float64: num and the residual over the target's sd,
    σ² over its largest value."""
    sd = float(y.double().std())
    scales = (sd, float(ref[1].abs().max()), sd)
    return [float((a.double() - b).abs().max()) / scale for a, b, scale in zip(out, ref, scales)]


def pass3_timings(args: list[torch.Tensor], kw: dict) -> dict:
    """K3's time, its plain version's (the solver's pass 3 before K3: cuBLAS IEEE float32) and
    the yardstick's on these float32 inputs, and its bound: Gu = W·Qs, 2nM₂² operations, at
    the 3×TF32 rate. The yardstick is W·Qs alone in ``torch.matmul``, IEEE float32, on the
    features built beforehand."""
    X, M_map, b_map, y, Qs = args[:5]
    n, d = X.shape
    D = M_map.shape[1]
    M2 = 2 * D + 2
    with matmul_precision("ieee"):
        W = features_real_pair(X, M_map, b_map)

    def library():
        with matmul_precision("ieee"):
            return torch.matmul(W, Qs)

    record = {
        "ms": time_ms(lambda: pass3_mod.fused_pass3(*args, **kw)),
        "plain_ms": time_ms(lambda: pass3_mod.pass3_plain(*args, **kw)),
        "library_ms": time_ms(library),
        "library": "torch.matmul(W, Qs) on the built features, IEEE FP32 (TF32 off)",
    }
    del W
    ops = 2 * n * M2 * M2 + 2 * n * d * D + 6 * n * M2
    nbytes = X.element_size() * (n * d + 4 * n + d * D + D + M2 * (M2 + 1) + 2 * M2)
    workspace = 4 * 2 * 2 * (-(-M2 // 32) * 32) * (-(-n // 128) * 128)  # W hi and lo, written and read
    shape = {"n": n, "d": d, "D": D, "dtype": str(X.dtype)[6:]}
    return {**record, **bound(ops, nbytes, workspace), "shape": shape}


def phase_main_path_kernels(calls: dict) -> tuple[dict, dict, dict]:
    """Each kernel's output from the 1M fit against its plain version in float64 on the
    same tensors, then each kernel timed on them."""
    g_args, _, G_k = calls["fused_augmented_gram"]
    g_abs, g_rel = gram_err(G_k, gram_mod.gram_plain(*(a.double() for a in g_args)))
    check(math.isfinite(g_rel) and g_rel <= GRAM_TOL_F32_1M, f"1M gram f32: max|ΔG_ij|/√(G_ii·G_jj) = {g_rel}")
    s_args, s_kw, (err_k, obj_k) = calls["fused_loo_sweep"]
    check(s_kw.get("precision") == "high", f"the default 1M fit called K2 with {s_kw}")
    perr, pobj = sweep_mod.sweep_plain(*(a.double() for a in s_args), **s_kw)
    s_abs, s_rel, gap = check_sweep_f32(err_k, obj_k, perr, pobj, "1M fit")
    gram_record = {
        "name": "fused_augmented_gram",
        "route": "cuda",
        "source": "neo_ls_svm_torch/ops/cuda/csrc/gram.cu",
        "replaces": "neo_ls_svm_tpu/ops/pallas/gram.py:61",
        "max_abs_err": g_abs,
        "max_rel_err": g_rel,
        **gram_timings(list(g_args)),
    }
    sweep_record = {
        "name": "fused_loo_sweep",
        "route": "cuda",
        "source": "neo_ls_svm_torch/ops/cuda/csrc/sweep.cu",
        "replaces": "neo_ls_svm_tpu/ops/pallas/sweep.py:111",
        "max_abs_err": s_abs,
        "max_rel_err": s_rel,
        "argmin_objective_gap": gap,
        **sweep_timings(list(s_args), s_kw),
    }
    p_args, p_kw, p_out = calls["fused_pass3"]
    p_ref = pass3_mod.pass3_plain(*(a.double() for a in p_args), **p_kw)
    p_err = pass3_errors(p_out, p_ref, p_args[3])
    check(max(p_err) <= PASS3_TOL_F32, f"1M fit pass 3: (num, σ², residual) off float64 by {p_err}")
    again = pass3_mod.fused_pass3(*p_args, **p_kw)
    check(all(torch.equal(a, b) for a, b in zip(again, p_out)), "1M fit pass 3: a second launch gave other bits")
    pass3_record = {
        "name": "fused_pass3",
        "route": "cuda",
        "source": "neo_ls_svm_torch/ops/cuda/csrc/pass3.cu",
        "replaces": "none (pass 3 of neo_ls_svm_tpu/models/primal.py::primal_fit_streaming, XLA operations)",
        "max_err_num_sigma2_residual": p_err,
        "plain_f32_err_num_sigma2_residual": pass3_errors(pass3_mod.pass3_plain(*p_args, **p_kw), p_ref, p_args[3]),
        **pass3_timings(list(p_args), p_kw),
    }
    emit({"phase": "main_path_kernels", "kernels": [gram_record, sweep_record, pass3_record]})
    return gram_record, sweep_record, pass3_record


def phase_fit_1m(dev: torch.device) -> tuple[dict, dict, dict, dict]:
    X, y = make_dataset(1 << 20, D_IN, seed=0)
    X_test, y_test = make_dataset(65_536, D_IN, seed=1)
    torch.cuda.reset_peak_memory_stats(dev)
    with recording_kernel_calls() as calls:
        reset_launches()
        t0 = time.perf_counter()
        model = NeoLSSVM(device=dev).fit(X, y)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {"fused_augmented_gram": gram_mod.launches, "fused_loo_sweep": sweep_mod.launches,
                    "fused_pass3": pass3_mod.launches}
        paths = _launches_by_path()
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    check(all(v >= 1 for v in launches.values()), f"the 1M fit did not launch every kernel: {launches}")
    check(
        all(p[_build.PATH_TF32] == launches[k] for k, p in paths.items()),
        f"the 1M fit's f32 kernels did not all take the 3×TF32 path: {paths}",
    )
    check(model.pre_transform_ == "device", f"the default 1M fit took the {model.pre_transform_} pre-transform")
    t0 = time.perf_counter()
    yhat = model.predict(X_test)
    predict_s = time.perf_counter() - t0
    check(yhat.shape == (65_536,) and bool(np.all(np.isfinite(yhat))), "predict: bad output")
    emit({
        "phase": "fit_1m",
        "n": 1 << 20,
        "fit_s": fit_s,
        "pre_transform_": model.pre_transform_,
        "transfer_": model.transfer_,
        "loo_score": model.loo_score_,
        "gamma": model.γ_,
        "launches": launches,
        "launches_by_path": paths,
        "peak_device_bytes": peak_bytes,
        "predict_rows": 65_536,
        "predict_s": predict_s,
        "predict_rows_per_s": 65_536 / predict_s,
        "test_r2": r2_score(y_test, yhat),
    })
    emit({"phase": "fit_1m_draws", **hold_to_anchor(X, y, dev, model.loo_score_, LOO_R2_1M_DEVICE, "fit_1m")})
    gram_record, sweep_record, pass3_record = phase_main_path_kernels(calls)
    for record in (gram_record, sweep_record, pass3_record):
        record["launches"] = launches[record["name"]]
    high = {"gammas": model.γs_, "loo_errors": model.loo_errors_γs_, "loo_score": model.loo_score_, "gamma": model.γ_}
    del calls, model
    torch.cuda.empty_cache()
    emit({"phase": "fit_1m_breakdown", **breakdown_1m(X, y, dev)})
    phase_fit_1m_host(X, y, X_test, y_test, dev)
    phase_pretransform(X, y, dev)
    return gram_record, sweep_record, pass3_record, high


def phase_fit_1m_f64(dev: torch.device) -> tuple[dict, dict]:
    """bench's 1M rows handed over as float64 through the default ``NeoLSSVM()``: float64
    input fits in float64, and its working set streams from 261,633 rows (D = 512), so the
    device pre-transform, then K1 and K2 once each on the float64 path (counted by path,
    from 0). LOO R² within 0.03 of the 1M anchor (one draw, as ``fit_1m``), first-call and
    repeat seconds. Each kernel held to its plain version on the fit's own tensors (the
    Gram within 1e-11 per entry, the sweep within 1e-10) and timed there, K1 beside
    ``torch.matmul`` in float64. Then, reported only, the 262,144-row float64 fit
    (streaming) beside the 261,632-row one (in memory, no kernel), in turns."""
    X, y = make_dataset(1 << 20, D_IN, seed=0, dtype=np.float64)
    torch.cuda.empty_cache()
    with recording_kernel_calls() as calls:
        reset_launches()
        first_s, model = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
        paths = _launches_by_path()
    check(paths == _one_launch_each(_build.PATH_FP64), f"fit_1m_f64: the fit's launches {paths}")
    check(model.pre_transform_ == "device", f"fit_1m_f64 took the {model.pre_transform_} pre-transform")
    check(abs(model.loo_score_ - LOO_R2_1M_DEVICE) <= ONE_DRAW_TOL,
          f"fit_1m_f64: LOO R² {model.loo_score_} vs {LOO_R2_1M_DEVICE}")
    repeat_s, _ = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
    g_args, _, G_k = calls["fused_augmented_gram"]
    g_abs, g_rel = gram_err(G_k, gram_mod.gram_plain(*g_args))
    check(math.isfinite(g_rel) and g_rel <= GRAM_TOL_F64, f"1M gram f64: max|ΔG_ij|/√(G_ii·G_jj) = {g_rel}")
    s_args, s_kw, (err_k, obj_k) = calls["fused_loo_sweep"]
    perr, pobj = sweep_mod.sweep_plain(*s_args, **s_kw)
    (e_abs, e_rel), (o_abs, o_rel) = rel_err(err_k, perr), rel_err(obj_k, pobj)
    check(math.isfinite(e_rel) and max(e_rel, o_rel) <= SWEEP_TOL_F64, f"1M sweep f64: relative errors {e_rel}, {o_rel}")
    common = {"route": "cuda", "precision": "float64 (either precision)"}
    gram_record = {"name": "fused_augmented_gram_f64", **common,
                   "source": "neo_ls_svm_torch/ops/cuda/csrc/gram_fp64.cu",
                   "replaces": "neo_ls_svm_tpu/ops/pallas/gram.py:61",
                   "launches": paths["fused_augmented_gram"][_build.PATH_FP64],
                   "max_abs_err": g_abs, "max_rel_err": g_rel, **gram_timings(list(g_args))}
    sweep_record = {"name": "fused_loo_sweep_f64", **common,
                    "source": "neo_ls_svm_torch/ops/cuda/csrc/sweep_fp64.cu",
                    "replaces": "neo_ls_svm_tpu/ops/pallas/sweep.py:111",
                    "launches": paths["fused_loo_sweep"][_build.PATH_FP64],
                    "max_abs_err": max(e_abs, o_abs), "max_rel_err": max(e_rel, o_rel),
                    **sweep_timings(list(s_args), s_kw)}
    fitted_1m = {"loo_score": model.loo_score_, "gamma": model.γ_}
    del calls, model, g_args, s_args, G_k
    torch.cuda.empty_cache()
    # Either side of the streaming threshold: 262,144 rows stream, 261,632 fit in memory.
    X2, y2 = make_dataset(262_144, D_IN, seed=0, dtype=np.float64)
    sides = {}
    for rows in (262_144, 261_632, 261_632, 262_144):
        reset_launches()
        seconds, fitted = timed(lambda: NeoLSSVM(device=dev).fit(X2[:rows], y2[:rows]))  # noqa: B023
        side = sides.setdefault(rows, {"fit_s": [], "launches_by_path": _launches_by_path(),
                                       "loo_score": fitted.loo_score_, "pre_transform_": fitted.pre_transform_})
        side["fit_s"].append(seconds)
    emit({"phase": "fit_1m_f64", "n": 1 << 20, "dtype": "float64", "first_fit_s": first_s, "repeat_fit_s": repeat_s,
          "launches_by_path": paths, **fitted_1m, "kernels": [gram_record, sweep_record],
          "either_side_of_the_streaming_threshold": sides})
    return gram_record, sweep_record


def gamma_gap(gamma: float, gammas: np.ndarray, loo_errors: np.ndarray) -> float:
    """How far from optimal ``gamma`` is under a "high" fit's LOO error over the γ grid:
    that error at the grid point nearest ``gamma``, relative to its minimum, less 1 (as
    the JAX package's tests hold precision="fast": the objective is flat near its
    minimum, so the grid index is no gate)."""
    idx = int(np.argmin(np.abs(gammas - gamma)))
    best = float(np.min(loo_errors))
    return float(loo_errors[idx]) / best - 1.0


def phase_fast(dev: torch.device, high_1m: dict) -> dict:
    """``precision="fast"`` on the card, with the caller's TF32 on throughout:
    (a) the default 1M fit, which must take the device pre-transform and launch K1 once
    on the 3×TF32 path and K2 once on the one-pass path; γ near-optimal under the "high"
    fit's LOO error (rel 1e-3) and LOO R² within 0.01 of it. (b) That K2 call's output
    against its f64 plain version on the fit's own tensors, under the one-pass limits,
    then timed: the ``kernels`` line's one-pass record. (c) The 262k in-memory route (no
    kernel; the two sweep contractions in cuBLAS TF32): γ near-optimal, LOO R² within
    0.005 of the "high" fit. (d) The TF32 scope: the caller's TF32 is really on (a plain
    product differs from its IEEE value), every fit and serving call leaves the caller's
    ``fp32_precision`` as it found it, and a "high" model's ``predict_std`` and
    ``decision_function`` equal, bit for bit, their values with the caller's TF32 off, as
    do the same model's after a pickle and a state-dict round trip."""
    matmul = torch.backends.cuda.matmul
    caller = matmul.fp32_precision
    check(caller == "tf32", f"fast: the caller's fp32_precision is {caller!r}, not 'tf32'")
    X, y = make_dataset(1 << 20, D_IN, seed=0)
    with recording_kernel_calls() as calls:
        reset_launches()
        fit_s, model = timed(lambda: NeoLSSVM(device=dev, precision="fast").fit(X, y))
        paths = _launches_by_path()
    check(matmul.fp32_precision == caller, f"fast: the fit left fp32_precision {matmul.fp32_precision!r}")
    check(paths == _one_launch_each(_build.PATH_TF32, _build.PATH_TF32_1), f"fast: the 1M fit's launches {paths}")
    check(model.pre_transform_ == "device", f"fast: the 1M fit took the {model.pre_transform_} pre-transform")
    gap_1m = gamma_gap(model.γ_, high_1m["gammas"], high_1m["loo_errors"])
    loo_diff_1m = abs(model.loo_score_ - high_1m["loo_score"])
    check(gap_1m <= 1e-3, f"fast 1M: γ {model.γ_} is {gap_1m} from optimal under the high fit's LOO error")
    check(loo_diff_1m <= 0.01, f"fast 1M: LOO R² {model.loo_score_} vs {high_1m['loo_score']}")
    objective_diff = float(np.max(np.abs(model.loo_errors_γs_ - high_1m["loo_errors"]) / high_1m["loo_errors"]))
    # (b) the one-pass K2 on the fit's own tensors
    s_args, s_kw, (err_k, obj_k) = calls["fused_loo_sweep"]
    check(s_kw.get("precision") == "fast", f"fast: K2 was called with {s_kw}")
    kw = {k: v for k, v in s_kw.items() if k != "precision"}
    perr, pobj = sweep_mod.sweep_plain(*(a.double() for a in s_args), **kw)
    err3, _ = sweep_mod.fused_loo_sweep(*s_args, **kw)
    emulated = emulated_sweep(*s_args, **kw, passes=1)
    readings = check_sweep_fast(err_k, obj_k, perr, pobj, rel_err(err3, perr)[1], kw["is_classifier"], "1M fast fit",
                                emulated)
    record = {
        "name": "fused_loo_sweep_one_pass",
        "route": "cuda",
        "source": "neo_ls_svm_torch/ops/cuda/csrc/sweep_1xtf32.cu",
        "replaces": "neo_ls_svm_tpu/ops/pallas/sweep.py:111",
        "precision": "fast (mxu_precision=DEFAULT in the TPU kernel)",
        "launches": paths["fused_loo_sweep"][_build.PATH_TF32_1],
        **readings,
        **sweep_timings(list(s_args), kw, "fast"),
    }
    emit({"phase": "fast", "n": 1 << 20, "fit_s": fit_s, "pre_transform_": model.pre_transform_,
          "launches_by_path": paths, "gamma": model.γ_, "high_gamma": high_1m["gamma"], "gamma_gap": gap_1m,
          "loo_score": model.loo_score_, "high_loo_score": high_1m["loo_score"], "loo_score_diff": loo_diff_1m,
          "loo_errors_max_rel_diff_from_high": objective_diff, "kernel": record,
          "breakdown": profiled_fit(X, y, dev, precision="fast")})
    del calls, model, s_args, err3
    torch.cuda.empty_cache()
    # (c) the in-memory route at 262,144 rows, in turns with its "high" twin
    X2, y2 = make_dataset(262_144, D_IN, seed=0)
    runs, models = {"fast": [], "high": []}, {}
    for precision in ("fast", "high", "high", "fast"):
        reset_launches()
        seconds, fitted = timed(lambda: NeoLSSVM(device=dev, precision=precision).fit(X2, y2))  # noqa: B023
        check(gram_mod.launches == 0 and sweep_mod.launches == 0, f"fast 262k: the {precision} fit launched a kernel")
        check(matmul.fp32_precision == caller, f"fast 262k: the {precision} fit left {matmul.fp32_precision!r}")
        runs[precision].append(seconds)
        models[precision] = fitted
    fast262, high262 = models["fast"], models["high"]
    check(fast262.pre_transform_ == "device", f"fast 262k: took the {fast262.pre_transform_} pre-transform")
    gap_262 = gamma_gap(fast262.γ_, high262.γs_, high262.loo_errors_γs_)
    loo_diff_262 = abs(fast262.loo_score_ - high262.loo_score_)
    check(gap_262 <= 1e-3, f"fast 262k: γ {fast262.γ_} is {gap_262} from optimal under the high fit's LOO error")
    check(loo_diff_262 <= 0.005, f"fast 262k: LOO R² {fast262.loo_score_} vs {high262.loo_score_}")
    # The TF32 contractions took effect: the objective over the grid is not the high fit's.
    diff_262 = float(np.max(np.abs(fast262.loo_errors_γs_ - high262.loo_errors_γs_) / high262.loo_errors_γs_))
    check(diff_262 > 0, "fast 262k: the objective equals the high fit's bit for bit: no TF32 product ran")
    # (d) the TF32 scope
    gen = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((2048, 2048), device=dev, generator=gen)
    with_tf32 = A @ A
    with matmul_precision("ieee"):
        ieee = A @ A
    check(not torch.equal(with_tf32, ieee), "fast: the caller's TF32 setting does not reach torch.matmul")
    X_test, _ = make_dataset(65_536, D_IN, seed=1)
    serving = {"predict_std": lambda m: m.predict_std(X_test), "decision_function": lambda m: m.decision_function(X_test)}
    matmul.fp32_precision = "ieee"
    try:
        want = {name: call(high262) for name, call in serving.items()}
    finally:
        matmul.fp32_precision = caller
    restored = {"fitted": high262, "pickle": pickle.loads(pickle.dumps(high262)),
                "state_dict": NeoLSSVM.from_state_dict(high262.to_state_dict(), device=dev)}
    for how, m in restored.items():
        for name, call in serving.items():
            got = call(m)
            check(matmul.fp32_precision == caller, f"fast: {how} {name} left fp32_precision {matmul.fp32_precision!r}")
            check(bool(np.array_equal(got, want[name])), f"fast: {how} {name} differs with the caller's TF32 on")
    emit({"phase": "fast_262k", "n": 262_144, "route": "inmemory", "fit_s": runs, "gamma": fast262.γ_,
          "high_gamma": high262.γ_, "gamma_gap": gap_262, "loo_score": fast262.loo_score_,
          "high_loo_score": high262.loo_score_, "loo_score_diff": loo_diff_262, "loo_errors_max_rel_diff_from_high": diff_262,
          "tf32_scope": {"caller": caller, "tf32_vs_ieee_matmul_max_abs": float((with_tf32 - ieee).abs().max()),
                         "bit_equal_with_caller_tf32_on_and_off": sorted(f"{h}.{n}" for h in restored for n in serving)}})
    return record


def phase_fit_1m_host(X, y, X_test, y_test, dev: torch.device) -> None:
    """The same 1M rows with the host pre-transform (bit-equal to the reference's)."""
    fit_s, model = timed(lambda: NeoLSSVM(device=dev, pre_transform="host").fit(X, y))
    check(model.pre_transform_ == "host", "fit_1m_host took the device pre-transform")
    check(abs(model.loo_score_ - LOO_R2_1M_HOST) <= 0.01, f"1M host LOO R² {model.loo_score_} vs {LOO_R2_1M_HOST}")
    t0 = time.perf_counter()
    sample_bins_quantized_ecdf(y)
    quantizer_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    OrthogonalRandomFourierFeatures().fit(X, y)  # the fit's host pre-transform, alone
    host_s = time.perf_counter() - t0
    emit({"phase": "fit_1m_host", "n": len(y), "fit_s": fit_s, "pre_transform_": model.pre_transform_,
          "host_pretransform_s": host_s, "of_which_target_quantizer_s": quantizer_s,
          "loo_score": model.loo_score_, "gamma": model.γ_, "test_r2": r2_score(y_test, model.predict(X_test))})


def phase_fit_262k(dev: torch.device) -> None:
    """The in-memory route at a payload of exactly 32 MiB: the default estimator (device
    pre-transform), its host-route twin, and the narrow transfer modes."""
    X, y = make_dataset(262_144, D_IN, seed=0)
    before = gram_mod.launches, sweep_mod.launches
    fit_s, model = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
    check((gram_mod.launches, sweep_mod.launches) == before, "the in-memory route launched a kernel")
    check(model.pre_transform_ == "device", f"the default 262k fit took the {model.pre_transform_} pre-transform")
    draws = hold_to_anchor(X, y, dev, model.loo_score_, LOO_R2_262K, "fit_262k")
    host_fit_s, host = timed(lambda: NeoLSSVM(device=dev, pre_transform="host").fit(X, y))
    t0 = time.perf_counter()
    OrthogonalRandomFourierFeatures().fit(X, y)  # the host twin's pre-transform, alone
    emit({"phase": "fit_262k", "n": 262_144, "route": "inmemory", "fit_s": fit_s,
          "pre_transform_": model.pre_transform_, "loo_score": model.loo_score_, "gamma": model.γ_,
          "host_route_fit_s": host_fit_s, "host_pretransform_s": time.perf_counter() - t0,
          "host_route_loo_score": host.loo_score_, **draws})
    X_test, y_test = make_dataset(65_536, D_IN, seed=1)
    modes = {"float32": {"fit_s": fit_s, "loo_score": model.loo_score_, "test_r2": r2_score(y_test, model.predict(X_test))}}
    for transfer in ("bfloat16", "int8"):
        seconds, lossy = timed(lambda: NeoLSSVM(device=dev, transfer=transfer).fit(X, y))  # noqa: B023
        check((lossy.pre_transform_, lossy.transfer_) == ("device", transfer), f"transfer={transfer}: wrong plan")
        check(abs(lossy.loo_score_ - model.loo_score_) <= 0.03,
              f"transfer={transfer}: LOO R² {lossy.loo_score_} vs float32 {model.loo_score_}")
        modes[transfer] = {"fit_s": seconds, "loo_score": lossy.loo_score_,
                           "test_r2": r2_score(y_test, lossy.predict(X_test))}
    emit({"phase": "transfer", "n": 262_144, "modes": modes})


def phase_fit_dual(dev: torch.device) -> None:
    """The dual route (n = 1024, float64) on the card against the same fit on the CPU."""
    X, y = make_dataset(1024 + 4096, D_IN, seed=3, dtype=np.float64)
    X_test = X[1024:]
    X, y = X[:1024], y[:1024]
    records = {}
    for task, target in (("regressor", y), ("classifier", np.where(y > np.median(y), 1, 0))):
        fit_s, card = timed(lambda: NeoLSSVM(device=dev).fit(X, target))  # noqa: B023
        host = NeoLSSVM(device="cpu").fit(X, target)
        check(card.dual_ and card.pre_transform_ == "host", f"dual {task}: not the dual route")
        check(card.γ_ == host.γ_, f"dual {task}: γ {card.γ_} on the card vs {host.γ_} on the CPU")
        np.testing.assert_allclose(card.α̂_, host.α̂_, rtol=1e-8, atol=1e-12, err_msg=f"dual {task}: α̂")
        predict_s, yhat = timed(lambda: card.predict(X_test))  # noqa: B023
        if task == "classifier":
            check(bool(np.array_equal(yhat, host.predict(X_test))), "dual classifier: labels differ from the CPU's")
        else:
            np.testing.assert_allclose(yhat, host.predict(X_test), rtol=1e-8, atol=1e-12, err_msg="dual predict")
        np.testing.assert_allclose(card.predict_std(X_test), host.predict_std(X_test), rtol=1e-6, atol=1e-10)
        records[task] = {"fit_s": fit_s, "predict_s": predict_s, "gamma": card.γ_, "loo_score": card.loo_score_,
                         "alpha_max_abs_diff": float(np.max(np.abs(card.α̂_ - host.α̂_)))}
    emit({"phase": "fit_dual", "n": 1024, "d": D_IN, "dtype": "float64", "predict_rows": 4096, **records})


# The NaN/inf cases on the card: dtype, rows, the route their default fit plans, and the
# transfer. The float32 ones cross whole and the card scans them; the narrow transfers are
# cast on the host, so the host scans them first.
NAN_CASES = (
    (np.float32, 1 << 20, "streaming", "float32"),
    (np.float32, 262_144, "inmemory", "float32"),
    (np.float64, 300_000, "streaming", "float32"),
    (np.float64, 200_000, "inmemory", "float32"),
    (np.float32, 262_144, "inmemory", "bfloat16"),
    (np.float32, 262_144, "inmemory", "int8"),
)


def phase_nan_on_card(dev: torch.device) -> None:
    """A NumPy X holding NaN, +inf or −inf at its first and its last value, on each case of
    ``NAN_CASES``: the fit raises sklearn's ``ValueError`` and leaves no fitted state. The
    spans say who found it: on a card-lane fit the host scanned no byte and the rows were
    uploaded first; on a host lane the fit ended in validation."""
    records = []
    for dtype, n, route, transfer in NAN_CASES:
        streams = est._primal_working_set_bytes(n, D_FEAT, np.dtype(dtype).itemsize) > est.STREAMING_BYTES_THRESHOLD
        check(streams == (route == "streaming"), f"nan_on_card: {n} {np.dtype(dtype).name} rows would not take {route}")
        X, y = make_dataset(n, D_IN, seed=0, dtype=dtype)
        on_card = transfer == "float32"
        for where in ((0, 0), (n - 1, D_IN - 1)):
            for value in (np.nan, np.inf, -np.inf):
                keep = X[where]
                X[where] = value
                model = NeoLSSVM(device=dev, transfer=transfer)
                profiling.clear_spans()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                    try:
                        model.fit(X, y)
                    except ValueError as e:
                        check(str(e) == "Input contains NaN or infinity.", f"nan_on_card: {e}")
                    else:
                        check(False, f"nan_on_card: {value} at {where} of {n} {transfer} rows was not caught")
                X[where] = keep
                check(not [k for k in vars(model) if k.endswith("_")], f"nan_on_card: fitted state {vars(model).keys()}")
                found = {r["name"]: r["attrs"] for r in profiling.spans()}
                if on_card:
                    check(found["neo.fit.validate"]["host_scanned_bytes"] == 0 and "neo.upload" in found,
                          f"nan_on_card: {transfer} raised after {found}")
                else:  # a span that raises leaves no record: the fit ended in validation
                    check(not found, f"nan_on_card: {transfer} raised after {found}")
        records.append({"dtype": np.dtype(dtype).name, "n": n, "route": route, "transfer": transfer,
                        "checked_on": "card" if on_card else "host"})
    profiling.clear_spans()
    emit({"phase": "nan_on_card", "cases": records, "ok": True})


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for mod in (gram_mod, sweep_mod, pass3_mod):
        mod.launches = 0
        mod.path_launches = dict.fromkeys(mod.path_launches, 0)


def read_launches(tag: str) -> dict:
    """The kernels' launch counts since ``reset_launches``; every kernel must have run."""
    launches = {"fused_augmented_gram": gram_mod.launches, "fused_loo_sweep": sweep_mod.launches,
                "fused_pass3": pass3_mod.launches}
    check(all(v >= 1 for v in launches.values()), f"{tag} did not launch every kernel: {launches}")
    return launches


def host_timed(fn):
    """(seconds on the host clock, the result) of host work."""
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


def phase_native(y: np.ndarray) -> None:
    """The native host loops against the Python loops, bit for bit, on a million points."""
    check(native.load() is not None and native.backend() == "native", "the native host loops did not load")
    gen = np.random.RandomState(7)
    means, weights = gen.randn(1 << 20), gen.rand(1 << 20) + 0.25
    before = dict(native.calls)
    pav_native_s, fitted = host_timed(lambda: pool_adjacent_violators(means, weights))
    pav_python_s, plain = host_timed(lambda: _pav_python(means, weights))
    check(bool(np.array_equal(fitted, plain)), "native pav_fit differs from the Python loop")
    codes = np.unique(y, return_inverse=True)[1]  # what the target quantizer scans
    scan_native_s, (hist, edges) = host_timed(lambda: hist_quantized_ecdf(codes))
    check(native.calls["pav_fit"] > before["pav_fit"] and native.calls["knot_scan"] > before["knot_scan"],
          f"the native loops were not the ones that ran: {native.calls}")
    native._FORCE_PYTHON = True
    try:
        scan_python_s, (hist_p, edges_p) = host_timed(lambda: hist_quantized_ecdf(codes))
    finally:
        native._FORCE_PYTHON = False
    check(bool(np.array_equal(hist, hist_p) and np.array_equal(edges, edges_p)),
          "the native knot scan differs from the Python loop")
    emit({"phase": "native", "backend": native.backend(), "build_s": native.build_seconds, "points": 1 << 20,
          "pav_native_s": pav_native_s, "pav_python_s": pav_python_s, "pav_blocks": int(len(np.unique(fitted))),
          "knot_scan_unique_values": int(codes.max()) + 1, "knot_scan_bins": int(len(hist)),
          "hist_native_s": scan_native_s, "hist_python_s": scan_python_s})


def phase_calibration(X, y, X_test, y_test, dev: torch.device) -> NeoLSSVM:
    """A default classifier on the 1M rows: isotonic ``predict_proba`` on held-out rows."""
    cut = float(np.median(y))
    labels, labels_test = (y > cut).astype(np.int64), (y_test > cut).astype(np.int64)
    reset_launches()
    fit_s, model = timed(lambda: NeoLSSVM(device=dev).fit(X, labels))
    launches = read_launches("the classifier's 1M fit")
    check("predict_proba_calibrator_" not in model._fitted_state(),
          "fit made the calibrator: it must wait for its first use")
    pav_calls = native.calls["pav_fit"]
    first_s, proba = timed(lambda: model.predict_proba(X_test))
    check(native.calls["pav_fit"] == pav_calls + 1, "the calibrator's PAV did not run in the native loop")
    repeat_s = statistics.median(timed(lambda: model.predict_proba(X_test))[0] for _ in range(5))
    decision = model.decision_function(X_test)
    check(proba.shape == (65_536, 2) and bool(np.all((proba >= 0) & (proba <= 1))), "predict_proba: not in [0, 1]")
    check(float(np.max(np.abs(proba.sum(axis=1) - 1))) <= 1e-6, "predict_proba: rows do not sum to 1")
    check(bool(np.all(np.diff(proba[np.argsort(decision, kind="stable"), 1]) >= -1e-12)),
          "predict_proba decreases somewhere in decision_function")
    brier = float(np.mean((proba[:, 1] - labels_test) ** 2))
    base = float(labels.mean())
    brier_base = float(np.mean((base - labels_test) ** 2))
    check(brier < brier_base, f"held-out Brier score {brier} is not below the base rate's {brier_base}")
    X_test_d = torch.from_numpy(X_test).to(dev)
    proba_d = model.predict_proba(X_test_d)
    check(isinstance(proba_d, torch.Tensor) and proba_d.device.type == "cuda", "tensor lane: no CUDA tensor came back")
    lane_diff = float(np.max(np.abs(proba_d.cpu().numpy() - proba)))
    check(lane_diff <= 1e-6, f"predict_proba: tensor lane {lane_diff} from the NumPy lane")
    tensor_s = statistics.median(timed(lambda: model.predict_proba(X_test_d))[0] for _ in range(5))
    on_cpu = NeoLSSVM.from_state_dict(model.to_state_dict(), device="cpu")
    # The CPU's float32 ŷ differs from the card's in its last bits, and the calibrator is a
    # staircase over a million thresholds, whose steps magnify that: ŷ is held within 1e-4,
    # the probabilities within 1e-5 in the mean and 0.01 at the worst row.
    cpu_decision_diff = float(np.max(np.abs(on_cpu.decision_function(X_test) - decision)))
    cpu_abs = np.abs(on_cpu.predict_proba(X_test) - proba)
    cpu_diff, cpu_mean_diff = float(cpu_abs.max()), float(cpu_abs.mean())
    check(cpu_decision_diff <= 1e-4 and cpu_mean_diff <= 1e-5 and cpu_diff <= 1e-2,
          f"the state restored on the CPU: ŷ {cpu_decision_diff}, probabilities {cpu_mean_diff} (mean) {cpu_diff} (max) off")
    # Where the first call's time goes: the calibrator's steps again, one by one, on the
    # same million LOO predictions.
    loo = model.loo_ŷ_.astype(np.float64)
    target = (labels == 1).astype(np.float64)
    lexsort_s, order = host_timed(lambda: np.lexsort((target, loo)))
    unique_s, (uniq, start) = host_timed(lambda: np.unique(loo[order], return_index=True))
    w_sorted = np.ones_like(loo)
    sums_w, sums_wy = np.add.reduceat(w_sorted, start), np.add.reduceat(target[order], start)
    pav_s, _ = host_timed(lambda: pool_adjacent_violators(sums_wy / sums_w, sums_w))
    emit({"phase": "calibration", "n": len(y), "fit_s": fit_s, "launches": launches, "loo_score": model.loo_score_,
          "predict_rows": 65_536, "first_predict_proba_s": first_s, "repeat_predict_proba_s": repeat_s,
          "tensor_lane_predict_proba_s": tensor_s, "tensor_lane_rows_per_s": 65_536 / tensor_s,
          "calibrator_steps_s": {"lexsort": lexsort_s, "unique": unique_s, "pav": pav_s},
          "thresholds": int(len(model.predict_proba_calibrator_.X_thresholds_)),
          "brier": brier, "brier_base_rate": brier_base, "test_accuracy": float(np.mean(model.predict(X_test) == labels_test)),
          "tensor_vs_numpy_max_abs": lane_diff, "cpu_restore_decision_max_abs": cpu_decision_diff,
          "cpu_restore_mean_abs": cpu_mean_diff, "cpu_restore_max_abs": cpu_diff})
    return model


def pinball_of(model: NeoLSSVM, quantiles: tuple) -> float:
    """The exact weighted pinball loss of the model's fitted level-1 planes on their own
    calibration design, the mean over the two targets and the quantiles."""
    q = np.asarray(quantiles, dtype=np.float64)
    w = model.sample_weight_calib_l1_.astype(np.float64)
    w = w / w.sum()
    losses = []
    for target_type in ("Δŷ", "Δŷ/ŷ"):
        A, target = model._conformal_design(target_type)
        planes = model.conformal_l1_[target_type][tuple(np.asarray(quantiles))].β_.astype(np.float64)
        r = target.astype(np.float64)[:, None] - np.hstack([A, np.ones((len(A), 1))]).astype(np.float64) @ planes
        losses.append(float(w @ np.maximum(q * r, (q - 1) * r).mean(axis=1)))
    return statistics.fmean(losses)


def coherence_report(model: NeoLSSVM, X_test: np.ndarray, quantiles: np.ndarray) -> dict:
    """Which held-out rows have quantiles that decrease somewhere, inside and outside the
    convex hull of the calibration rows' (σ, |ŷ|).

    The coherent LP orders the quantile planes on its level-1 calibration rows, hence (the
    planes are affine) on their convex hull, and the level-2 biases are clipped to keep that. A
    row beyond the hull extrapolates the planes, which may cross there, in the reference
    as here. So the hull's rows are held to non-decreasing quantiles, every one of them, up
    to the rounding of float32 serving (1e-4 of the median 95% width); the others are counted.
    """
    from scipy.spatial import Delaunay  # noqa: PLC0415

    def design(std, yhat):
        return np.column_stack([std, np.abs(yhat)]).astype(np.float64)

    calib = design(model.nonconformity_calib_l1_, model.ŷ_calib_l1_)
    scale = calib.max(axis=0) - calib.min(axis=0)
    rows = design(model.predict_std(X_test), model.decision_function(X_test))
    inside = Delaunay(calib / scale).find_simplex(rows / scale) >= 0
    slack = 1e-4 * float(np.median(quantiles[:, -1] - quantiles[:, 0]))
    decreases = (np.diff(quantiles.astype(np.float64), axis=1) < -slack).any(axis=1)
    return {"rows_inside_hull": int(inside.sum()), "rows_inside_that_decrease": int((inside & decreases).sum()),
            "rows_outside_hull": int((~inside).sum()), "rows_outside_that_decrease": int((~inside & decreases).sum())}


def phase_conformal(X, y, X_test, y_test, dev: torch.device) -> NeoLSSVM:
    """The default 1M regressor: conformal intervals and quantiles on held-out rows, the
    exact LPs against the smooth Newton solver on the card, and the tensor lane."""
    seven = (0.025, 0.05, 0.1, 0.5, 0.9, 0.95, 0.975)
    reset_launches()
    fit_s, model = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
    launches = read_launches("the regressor's 1M fit")
    check("conformal_l1_" not in model._fitted_state(), "fit made the conformal split: it must wait for its first use")
    first_s, interval = timed(lambda: model.predict_interval(X_test, coverage=0.9))
    repeat_s = statistics.median(timed(lambda: model.predict_interval(X_test, coverage=0.9))[0] for _ in range(5))
    check(interval.shape == (65_536, 2) and bool(np.all(np.isfinite(interval))), "predict_interval: bad output")
    coverage = float(np.mean((interval[:, 0] <= y_test) & (y_test <= interval[:, 1])))
    check(0.87 <= coverage <= 0.95, f"predict_interval(coverage=0.9) covers {coverage} of the held-out rows")
    lp_seven_s, _ = timed(lambda: model._fit_conformal_pair(seven))
    lp_blocks = {t: model.conformal_l1_[t][seven].solver_diagnostics_ for t in ("Δŷ", "Δŷ/ŷ")}
    quantiles = model.predict_quantiles(X_test, quantiles=seven)
    monotone = coherence_report(model, X_test, quantiles)
    check(quantiles.shape == (65_536, 7) and monotone["rows_inside_that_decrease"] == 0,
          f"predict_quantiles: a row inside the calibration rows' hull has decreasing quantiles: {monotone}")
    smooth = NeoLSSVM(device=dev, conformal_method="smooth").fit(X, y)
    check(bool(np.array_equal(smooth.ŷ_calib_l1_, model.ŷ_calib_l1_)), "the smooth model's split is another one")
    pair = tuple(np.asarray(((1 - 0.9) / 2, 1 - (1 - 0.9) / 2)))
    newton_pair_s, _ = timed(lambda: smooth._fit_conformal_pair(pair))
    newton_seven_s, _ = timed(lambda: smooth._fit_conformal_pair(seven))
    gaps = {}
    for name, qs in (("interval", pair), ("seven", seven)):
        exact_loss, smooth_loss = pinball_of(model, qs), pinball_of(smooth, qs)
        gaps[name] = {"exact_lp": exact_loss, "smooth_newton": smooth_loss, "gap": smooth_loss / exact_loss - 1}
        check(-1e-6 <= gaps[name]["gap"] <= SMOOTH_GAP_LIMIT,
              f"smooth pinball loss {smooth_loss} vs the LP's {exact_loss} ({name})")
    smooth_monotone = coherence_report(smooth, X_test, smooth.predict_quantiles(X_test, quantiles=seven))
    check(smooth_monotone["rows_inside_that_decrease"] == 0, f"smooth predict_quantiles decrease inside the hull: {smooth_monotone}")
    smooth_interval = smooth.predict_interval(X_test, coverage=0.9)
    smooth_coverage = float(np.mean((smooth_interval[:, 0] <= y_test) & (y_test <= smooth_interval[:, 1])))
    X_test_d = torch.from_numpy(X_test).to(dev)
    lanes = {}
    for name, call in (("predict_interval", lambda m, A: m.predict_interval(A, coverage=0.9)),
                       ("predict_quantiles", lambda m, A: m.predict_quantiles(A, quantiles=seven)),
                       ("decision_function", lambda m, A: m.decision_function(A)),
                       ("predict_std", lambda m, A: m.predict_std(A)),
                       ("predict", lambda m, A: m.predict(A))):
        out_d = call(model, X_test_d)
        check(isinstance(out_d, torch.Tensor) and out_d.device.type == "cuda", f"{name}: no CUDA tensor came back")
        np.testing.assert_allclose(out_d.cpu().numpy(), call(model, X_test), rtol=1e-5, atol=1e-5, err_msg=name)
        seconds = statistics.median(timed(lambda: call(model, X_test_d))[0] for _ in range(5))  # noqa: B023
        lanes[name] = {"tensor_lane_s": seconds, "tensor_lane_rows_per_s": 65_536 / seconds}
    try:
        model.predict(X_test_d.cpu().to("meta"))
    except ValueError:
        pass
    else:
        raise AssertionError("a tensor on another device did not raise")
    emit({"phase": "conformal", "n": len(y), "fit_s": fit_s, "launches": launches, "predict_rows": 65_536,
          "first_predict_interval_s": first_s, "repeat_predict_interval_s": repeat_s, "coverage_at_0.9": coverage,
          "mean_width": float(np.mean(interval[:, 1] - interval[:, 0])), "lp_seven_quantiles_s": lp_seven_s, "lp_seven_quantiles_blocks": lp_blocks,
          "newton_interval_s": newton_pair_s, "newton_seven_quantiles_s": newton_seven_s,
          "smooth_coverage_at_0.9": smooth_coverage, "pinball": gaps, "seven_quantiles": monotone,
          "smooth_seven_quantiles": smooth_monotone,
          "tensor_lane": lanes})
    return model


def phase_state_dict(models: dict, X_test: np.ndarray, dev: torch.device) -> None:
    """A state-dict round trip and a pickle round trip on the card, bit for bit."""
    X_test_d = torch.from_numpy(X_test).to(dev)
    records = {}
    for task, model in models.items():
        calls = {"decision_function": lambda m: m.decision_function(X_test), "predict_std": lambda m: m.predict_std(X_test),
                 "tensor_decision": lambda m: m.decision_function(X_test_d).cpu().numpy()}
        if task == "classifier":
            calls["predict_proba"] = lambda m: m.predict_proba(X_test)
        calls["predict_quantiles"] = lambda m: m.predict_quantiles(X_test)
        want = {name: call(model) for name, call in calls.items()}
        state_s, restored = timed(lambda: NeoLSSVM.from_state_dict(model.to_state_dict(), device=dev))  # noqa: B023
        blob = pickle.dumps(model)
        unpickled = pickle.loads(blob)
        check("_device_cache" not in vars(unpickled), "pickle: device handles travelled")
        for how, other in (("state_dict", restored), ("pickle", unpickled)):
            for name, call in calls.items():
                check(bool(np.array_equal(call(other), want[name])), f"{task} {how}: {name} is not bit-equal")
        records[task] = {"round_trip_s": state_s, "pickle_bytes": len(blob), "checked": sorted(calls)}
    emit({"phase": "state_dict", **records})


def phase_tensor_io(X, y, dev: torch.device) -> None:
    """``fit`` on a CUDA tensor against ``fit`` on the same NumPy rows, three fits each in
    turns (NumPy, tensor, tensor, NumPy, …), since one fit's time moves with the host."""
    records = {how: {"fit_s": []} for how in ("numpy", "tensor")}
    for how in ("numpy", "tensor", "tensor", "numpy", "numpy", "tensor"):
        torch.cuda.empty_cache()
        rows = X if how == "numpy" else torch.from_numpy(X).to(dev)
        target = y if how == "numpy" else torch.from_numpy(y).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        fit_s, model = timed(lambda: NeoLSSVM(device=dev, pre_transform="device").fit(rows, target))  # noqa: B023
        check(model.pre_transform_ == "device", f"the fit on {how} rows took the {model.pre_transform_} pre-transform")
        records[how]["fit_s"].append(fit_s)
        records[how].update({"peak_device_bytes": torch.cuda.max_memory_allocated(dev), "gamma": model.γ_,
                             "loo_score": model.loo_score_, "launches": read_launches(f"the fit on {how} rows")})
        del rows, target, model
    for record in records.values():
        record["fit_median_s"] = statistics.median(record["fit_s"])
    check(records["numpy"]["gamma"] == records["tensor"]["gamma"], f"tensor_io: γ differs: {records}")
    check(abs(records["numpy"]["loo_score"] - records["tensor"]["loo_score"]) <= 1e-6, f"tensor_io: LOO R² differs: {records}")
    emit({"phase": "tensor_io", "n": len(y), **records})


MESH_DIR = Path(__file__).resolve().parent / "build" / "mesh_smoke"
MESH_RANKS, MESH_ROW_CHUNK, N_MESH_FIT = 4, 16_384, 1 << 22
# More random_state values of the (c) fit, whose LOO R² distance from one GPU's is
# reported (not gated): how much room the 1e-5 gate has beyond the default draw.
MESH_DRAWS = (1, 2, 3)
# K2's f32 limit (relative, over the whole γ grid), and how far the LOO R² of two fits of
# the same rows may part when one sums the Gram and the sweep over 4 row shards.
SWEEP_TOL_F32, MESH_LOO_TOL = 1e-4, 1e-5
# Rank 0's peak device memory over a mesh fit, at most this many times the largest of the
# other ranks': every rank pre-transforms its own block of rows.
PEAK_RATIO_LIMIT = 1.25


def note(what: str) -> None:
    """A progress line on standard error, for a run that stops in the middle of a phase."""
    print(f"[{time.strftime('%H:%M:%S')}] {what}", file=sys.stderr, flush=True)


def _launches_by_path() -> dict:
    return {"fused_augmented_gram": dict(gram_mod.path_launches), "fused_loo_sweep": dict(sweep_mod.path_launches),
            "fused_pass3": dict(pass3_mod.path_launches)}


def _one_launch_each(path: str, sweep_path: str | None = None) -> dict:
    """One launch of each kernel, K1 on ``path`` and K2 on ``sweep_path`` (default: the
    same path), and none on any other path. K3 has the 3×TF32 path alone: one launch when K1
    takes it, none when the fit is float64."""
    paths = {"fused_augmented_gram": path, "fused_loo_sweep": sweep_path or path, "fused_pass3": path}
    mods = {"fused_augmented_gram": gram_mod, "fused_loo_sweep": sweep_mod, "fused_pass3": pass3_mod}
    return {name: {p: int(p == paths[name]) for p in mods[name].path_launches} for name in mods}


def block_medians(mesh, X_l: torch.Tensor, y_all: torch.Tensor, w_all: torch.Tensor) -> np.ndarray:
    """The per-bin medians of the device pre-transform's bins from this rank's block of
    rows, every sum over rows completed over the mesh's ``data`` axis."""
    from functools import partial  # noqa: PLC0415

    from neo_ls_svm_torch.parallel import collectives  # noqa: PLC0415
    from neo_ls_svm_torch.parallel import mesh as tmesh  # noqa: PLC0415

    data, num_bins = mesh.get_group("data"), PT_KW["num_bins"]
    rows = tmesh._block(mesh, len(y_all), tmesh.axis_size(mesh, "data"))
    codes, _ = _target_codes(y_all, w_all, num_bins=num_bins, is_classifier=False)
    return affine_mod.grouped_weighted_median(
        X_l, w_all[rows], codes[rows], num_bins,
        row_sum=partial(collectives.sum_over, group=data), row_gather=partial(collectives.gather_rows, group=data),
    ).cpu().numpy()


def _mesh_rank(rank: int, world: int, workdir: Path, backend: str, tasks: tuple) -> None:
    """One rank of the ``mesh`` phase, in a process of its own. With gloo every rank
    computes on card 0 (the sums pass through the host); with NCCL rank r on card r."""
    import datetime  # noqa: PLC0415

    import torch.distributed as dist  # noqa: PLC0415

    from neo_ls_svm_torch.parallel import mesh as tmesh  # noqa: PLC0415
    from neo_ls_svm_torch.parallel.mesh import make_mesh, sharded_primal_fit_streaming  # noqa: PLC0415

    torch.cuda.set_device(rank if backend == "nccl" else 0)
    # The caller's TF32 is on, as in main(): every fit must scope its own products.
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    torch.set_num_threads(2)  # four ranks share the host's cores
    dist.init_process_group(backend, init_method=f"file://{workdir}/rendezvous-{backend}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=600))
    load = lambda name: np.load(workdir / f"{name}.npy", mmap_mode="r")  # noqa: E731
    out = {}
    note(f"mesh: {backend} rank {rank} of {world} joined")
    if "functions" in tasks:
        X, y, M_map, b_map = (load(k) for k in ("X", "y", "M", "b"))
        kw = {"is_classifier": False, "row_chunk": MESH_ROW_CHUNK}
        meshes = {shape: make_mesh(*shape) for shape in ((world, 1), (world // 2, 2))}
        for tag, shape, rows, dtype, precision in (("f32", (world, 1), len(y), np.float32, "high"),
                                                    ("f32_fast", (world, 1), len(y), np.float32, "fast"),
                                                    ("f64", (world, 1), N_KERNEL, np.float64, "high"),
                                                    ("feature_axis", (world // 2, 2), len(y), np.float32, "high")):
            mesh = meshes[shape]
            ops = [np.asarray(a[:rows] if a.shape[0] == len(y) else a, dtype) for a in (X, M_map, b_map, y)]
            reset_launches()
            seconds, r = timed(lambda: sharded_primal_fit_streaming(  # noqa: B023
                mesh, ops[0], ops[1], ops[2], ops[3], np.ones(rows, dtype), gamma_grid(dtype), **kw,
                sweep_precision=precision))  # noqa: B023
            note(f"mesh: {backend} rank {rank}: {tag} fit {seconds:.2f} s")
            out[tag] = {"seconds": seconds, "launches_by_path": _launches_by_path(),
                        **{k: r[k].cpu().numpy() for k in ("loo_errors_gammas", "optimum_index", "loo_score", "beta_emb")}}
        # The device pre-transform on each rank's block of the same rows, the draws of one
        # GPU's seed made on rank 0 and sent: f32 on the 1M rows, f64 on the first 131,072.
        mesh, dev = meshes[(world, 1)], tmesh.mesh_device(meshes[(world, 1)])
        for tag, rows, dtype in (("pt_f32", len(y), np.float32), ("pt_f64", N_KERNEL, np.float64)):
            X_l = tmesh._stage_rows(mesh, np.asarray(X[:rows], dtype), world, dev)
            y_all, w_all = (tmesh._stage_padded(a, world, dev)
                            for a in (np.asarray(y[:rows], dtype), np.ones(rows, dtype)))
            seconds, pt = timed(lambda: tmesh.sharded_device_pre_transform(  # noqa: B023
                mesh, X_l, y_all, w_all, pt_generator(dev), **PT_KW))  # noqa: B023
            out[tag] = {"seconds": seconds, **{k: v.cpu().numpy() for k, v in pt.items()}}
            if tag == "pt_f32":
                out[tag]["medians"] = block_medians(mesh, X_l, y_all, w_all)
    if "estimator" in tasks:
        # Two fits: the first builds the mesh's groups and warms the libraries; the
        # launches and results are the second's.
        # Each rank's peak device memory over the second fit, and its pre-transform's seconds.
        seconds, pretransform_s, real = [], [], tmesh.sharded_device_pre_transform

        def timed_pretransform(*args, **kwargs):
            pt_s, pt = timed(lambda: real(*args, **kwargs))
            pretransform_s.append(pt_s)
            return pt

        tmesh.sharded_device_pre_transform = timed_pretransform
        try:
            for _ in range(2):
                reset_launches()
                torch.cuda.reset_peak_memory_stats()
                fit_s, model = timed(lambda: NeoLSSVM(mesh="auto").fit(load("X4"), load("y4")))
                seconds.append(fit_s)
        finally:
            tmesh.sharded_device_pre_transform = real
        note(f"mesh: {backend} rank {rank}: estimator fits {seconds}")
        out["estimator"] = {"seconds": seconds, "launches_by_path": _launches_by_path(),
                            "peak_memory_bytes": torch.cuda.max_memory_allocated(), "pretransform_s": pretransform_s,
                            "mesh_shape": tuple(model.mesh_.shape), "pre_transform": model.pre_transform_,
                            "loo_errors_gammas": model.loo_errors_γs_, "loo_score": model.loo_score_,
                            "predict": model.predict(load("X_test"))}
        np.save(workdir / f"loo_residuals-{backend}-{rank}.npy", model.loo_residuals_)
        out["draws"] = {seed: NeoLSSVM(mesh="auto", random_state=seed).fit(load("X4"), load("y4")).loo_score_
                        for seed in MESH_DRAWS}
    dist.destroy_process_group()
    (workdir / f"rank-{backend}-{rank}.pkl").write_bytes(pickle.dumps(out))


def run_ranks(world: int, workdir: Path, backend: str, tasks: tuple, timeout: float = 600.0) -> list[dict]:
    """Start ``world`` ranks of ``_mesh_rank`` and wait for them; fail unless every rank
    exited with 0 within ``timeout`` seconds."""
    import torch.multiprocessing as mp  # noqa: PLC0415

    context = mp.start_processes(_mesh_rank, args=(world, workdir, backend, tasks), nprocs=world,
                                 join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=max(deadline - time.monotonic(), 0.0)):
            check(time.monotonic() < deadline, f"mesh: the {backend} ranks did not finish within {timeout} s")
    finally:
        for proc in context.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=30)
    codes = [proc.exitcode for proc in context.processes]
    check(codes == [0] * world, f"mesh: {backend} rank exit codes {codes}")
    return [pickle.loads((workdir / f"rank-{backend}-{rank}.pkl").read_bytes()) for rank in range(world)]


def objective_agreement(ours: np.ndarray, i_ours: int, ref: np.ndarray, i_ref: int, tag: str) -> dict:
    """Hold a γ-grid objective against the single-GPU one: relative error over the grid
    within K2's f32 limit, and the same argmin, or else an argmin whose objective is within
    that limit of the reference minimum."""
    rel = float(np.max(np.abs(ours.astype(np.float64) - ref) / np.abs(ref)))
    check(rel <= SWEEP_TOL_F32, f"{tag}: objective relative error {rel}")
    gap = abs(float(ref[i_ours]) - float(ref[i_ref])) / abs(float(ref[i_ref]))
    check(i_ours == i_ref or gap <= SWEEP_TOL_F32, f"{tag}: γ index {i_ours} vs {i_ref}, objective gap {gap}")
    return {"objective_rel_err": rel, "gamma_index": i_ours, "single_gamma_index": i_ref, "index_objective_gap": gap}


def hold_estimator_ranks(ranks: list[dict], single: NeoLSSVM, single_predict: np.ndarray, single_draws: dict,
                         workdir: Path, backend: str) -> dict:
    """Checks of a multi-rank ``NeoLSSVM(mesh="auto")`` fit against the single-GPU default fit."""
    world = len(ranks)
    first = ranks[0]["estimator"]
    ref = single.loo_errors_γs_.astype(np.float64)
    agree = objective_agreement(first["loo_errors_gammas"], int(np.argmin(first["loo_errors_gammas"])), ref,
                                int(np.argmin(ref)), f"mesh {backend} estimator")
    residuals = np.load(workdir / f"loo_residuals-{backend}-0.npy")
    for rank, result in enumerate(ranks):
        est_r = result["estimator"]
        check(est_r["mesh_shape"] == (world, 1) and est_r["pre_transform"] == "device",
              f"mesh {backend} rank {rank}: mesh {est_r['mesh_shape']}, pre-transform {est_r['pre_transform']}")
        check(est_r["launches_by_path"] == _one_launch_each(_build.PATH_TF32),
              f"mesh {backend} rank {rank}: launches {est_r['launches_by_path']}")
        check(bool(np.array_equal(np.load(workdir / f"loo_residuals-{backend}-{rank}.npy"), residuals)),
              f"mesh {backend} rank {rank}: loo_residuals_ differ from rank 0's")
    # Every rank pre-transforms its own block: no rank holds all of X or the n × d
    # intermediates, so rank 0 holds what the others hold.
    peaks = [r["estimator"]["peak_memory_bytes"] for r in ranks]
    if world > 1:
        check(peaks[0] <= PEAK_RATIO_LIMIT * max(peaks[1:]), f"mesh {backend}: rank peaks {peaks} bytes")
    loo_diff = abs(first["loo_score"] - single.loo_score_)
    check(loo_diff <= MESH_LOO_TOL, f"mesh {backend} estimator: LOO R² {first['loo_score']} vs {single.loo_score_}")
    # rtol 1e-4, and an absolute floor of 1e-5 of the predictions' scale for the ŷ near 0.
    np.testing.assert_allclose(first["predict"], single_predict, rtol=1e-4,
                               atol=1e-5 * float(np.max(np.abs(single_predict))), err_msg="mesh predict")
    draw_diffs = {seed: abs(ranks[0]["draws"][seed] - single_draws[seed]) for seed in MESH_DRAWS}
    return {"ranks": world, "mesh_fit_s": first["seconds"], "loo_score": first["loo_score"], "loo_score_diff": loo_diff,
            "loo_score_diff_by_random_state": draw_diffs, "loo_score_diff_max_over_draws": max(draw_diffs.values()),
            "predict_max_abs_diff": float(np.max(np.abs(first["predict"] - single_predict))),
            "peak_memory_bytes_per_rank": peaks, "rank0_peak_over_largest_other": peaks[0] / max(peaks[1:] or peaks),
            "pretransform_s_per_rank": [r["estimator"]["pretransform_s"] for r in ranks],
            "launches_per_rank": [r["estimator"]["launches_by_path"] for r in ranks], **agree}


def row_order_noise(X: np.ndarray, y: np.ndarray, dev: torch.device) -> dict:
    """One GPU's own f32 sensitivity to the order of the rows, at each draw of (c): the
    LOO R² of ``primal_fit_streaming`` on the rows as given and in a fixed random order,
    with that draw's M and b. Exactly, the order changes nothing; in f32 it changes the
    summation order of the Gram and the sweep, as the ranks' partial sums do."""
    X_d, y_d = upload_rows(X, "float32", dev), est._to_device(y, dev)
    w_d, g_d = torch.ones_like(y_d), torch.from_numpy(gamma_grid(np.float32)).to(dev)
    order = torch.randperm(len(y), generator=torch.Generator().manual_seed(7)).to(dev)
    diffs = {}
    for seed in (42, *MESH_DRAWS):  # 42: the estimator's default random_state
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        pt = device_pre_transform(X_d, y_d, w_d, generator, **PT_KW)
        loo = [float(primal_fit_streaming(X_d[rows], pt["M"], pt["b"], y_d[rows], w_d, g_d, None, is_classifier=False,
                                          row_chunk=MESH_ROW_CHUNK)["loo_score"]) for rows in (slice(None), order)]
        diffs[seed] = abs(loo[1] - loo[0])
    return diffs


def phase_mesh(dev: torch.device) -> dict[str, list[int]]:
    """The mesh route on the one card: 4 ranks with gloo on CUDA tensors (the sums pass
    through the host), then NCCL in a world of one rank (and over several cards, where the
    machine has them). Returns each kernel's launches on each rank: in the estimator fit,
    and for K2's one-pass path and the f64 kernels in (a)."""
    import torch.distributed as dist  # noqa: PLC0415

    from neo_ls_svm_torch.parallel.mesh import make_mesh  # noqa: PLC0415

    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    X, y = make_dataset(1 << 20, D_IN, seed=0)
    X4, y4 = make_dataset(N_MESH_FIT, D_IN, seed=0)
    X_test, _ = make_dataset(65_536, D_IN, seed=1)
    X_d, y_d = upload_rows(X, "float32", dev), est._to_device(y, dev)
    w_d = torch.ones_like(y_d)
    pt = device_pre_transform(X_d, y_d, w_d, pt_generator(dev), **PT_KW)  # the 1M fit's M and b
    codes, _ = _target_codes(y_d, w_d, num_bins=PT_KW["num_bins"], is_classifier=False)
    single_medians = affine_mod.grouped_weighted_median(X_d, w_d, codes, PT_KW["num_bins"]).cpu().numpy()
    single_pt_s = statistics.median(
        timed(lambda: device_pre_transform(X_d, y_d, w_d, pt_generator(dev), **PT_KW))[0] for _ in range(3))
    single_pt = {
        "pt_f32": {k: v.cpu().numpy() for k, v in pt.items()},
        "pt_f64": {k: v.cpu().numpy() for k, v in device_pre_transform(
            *(a[:N_KERNEL].double() for a in (X_d, y_d, w_d)), pt_generator(dev), **PT_KW).items()},
    }
    for name, array in (("X", X), ("y", y), ("M", pt["M"].cpu().numpy()), ("b", pt["b"].cpu().numpy()),
                        ("X4", X4), ("y4", y4), ("X_test", X_test)):
        np.save(MESH_DIR / f"{name}.npy", array)
    # The single-GPU references: primal_fit_streaming on the same operands, f32 and f64,
    # and the default estimator on the 4M rows.
    single = {}
    for tag, rows, dtype in (("f32", len(y), np.float32), ("f64", N_KERNEL, np.float64)):
        g_d = torch.from_numpy(gamma_grid(dtype)).to(dev)
        ops = [a[:rows].to(g_d.dtype) if a.shape[0] == len(y) else a.to(g_d.dtype) for a in (X_d, pt["M"], pt["b"], y_d, w_d)]
        result = primal_fit_streaming(*ops, g_d, None, is_classifier=False, row_chunk=MESH_ROW_CHUNK, num_samples=rows)
        single[tag] = {k: v.cpu().numpy() for k, v in result.items()}
    del X_d, y_d, w_d, pt, codes
    note("mesh: single-GPU references of (a) done")
    single_fit_s = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        fit_s, single_model = timed(lambda: NeoLSSVM(device=dev).fit(X4, y4))
        single_fit_s.append(fit_s)
    single_peak = torch.cuda.max_memory_allocated()
    single_predict = single_model.predict(X_test)
    single_draws = {seed: NeoLSSVM(device=dev, random_state=seed).fit(X4, y4).loo_score_ for seed in MESH_DRAWS}
    order_noise = row_order_noise(X4, y4, dev)
    torch.cuda.empty_cache()
    note(f"mesh: single-GPU 4M fits {single_fit_s} s; starting {MESH_RANKS} gloo ranks")
    ranks = run_ranks(MESH_RANKS, MESH_DIR, "gloo", ("functions", "estimator"))
    record: dict = {"phase": "mesh", "multi_rank_backend": "gloo on CUDA tensors: 4 ranks on one card, sums through the host",
                    "single_gpu_row_order_loo_diff_by_random_state": order_noise}
    # (a) Function level, (4, 1): K1 and K2 once on each rank's 262,144 rows.
    f32 = ranks[0]["f32"]
    for rank, result in enumerate(ranks):
        for tag, path in (("f32", _build.PATH_TF32), ("f64", _build.PATH_FP64)):
            check(result[tag]["launches_by_path"] == _one_launch_each(path),
                  f"mesh {tag} rank {rank}: launches {result[tag]['launches_by_path']}")
        check(int(result["f32"]["optimum_index"]) == int(f32["optimum_index"]), f"mesh: rank {rank} took another γ")
    agree = objective_agreement(f32["loo_errors_gammas"], int(f32["optimum_index"]),
                                single["f32"]["loo_errors_gammas"].astype(np.float64),
                                int(single["f32"]["optimum_index"]), "mesh f32")
    loo_a = float(f32["loo_score"])
    check(abs(loo_a - float(single["f32"]["loo_score"])) <= MESH_LOO_TOL,
          f"mesh f32: LOO R² {loo_a} vs {single['f32']['loo_score']}")
    f64 = ranks[0]["f64"]
    check(int(f64["optimum_index"]) == int(single["f64"]["optimum_index"]), "mesh f64: γ differs")
    np.testing.assert_allclose(f64["beta_emb"], single["f64"]["beta_emb"], rtol=1e-9, atol=1e-12, err_msg="mesh f64 β")
    record["function_level"] = {
        "mesh": [MESH_RANKS, 1], "rows_per_rank": (1 << 20) // MESH_RANKS, "row_chunk": MESH_ROW_CHUNK,
        "seconds_rank0": f32["seconds"], "loo_score": loo_a, "single_loo_score": float(single["f32"]["loo_score"]),
        **agree, "f64_rows": N_KERNEL, "f64_beta_max_abs_diff": float(np.max(np.abs(f64["beta_emb"] - single["f64"]["beta_emb"]))),
        "launches_per_rank": [r["f32"]["launches_by_path"] for r in ranks],
    }
    # (a, pre-transform) The device pre-transform on each rank's 262,144 rows, the draws of
    # one GPU's seed: per-bin medians bit-equal (unit weights: every mass an exact integer),
    # M and b distances reported in f32, and f64 at 131,072 rows within rtol 1e-9.
    for rank, result in enumerate(ranks):
        check(bool(np.array_equal(result["pt_f32"]["medians"], single_medians)),
              f"mesh pre-transform rank {rank}: medians")
        for tag in ("pt_f32", "pt_f64"):
            for key, value in single_pt[tag].items():
                check(bool(np.array_equal(result[tag][key], ranks[0][tag][key])),
                      f"mesh {tag} rank {rank}: {key} differs")
    distances = {}
    for tag in ("pt_f32", "pt_f64"):
        for key in ("M", "b", "pt_shift", "pt_scale", "pt_A"):
            ours, ref = ranks[0][tag][key].astype(np.float64), single_pt[tag][key].astype(np.float64)
            distances[f"{tag}_{key}_max_abs_diff"] = float(np.max(np.abs(ours - ref)))
            distances[f"{tag}_{key}_max_diff_over_max_abs"] = float(np.max(np.abs(ours - ref)) / np.max(np.abs(ref)))
            if tag == "pt_f64":
                np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-9 * float(np.max(np.abs(ref))),
                                           err_msg=f"mesh f64 pre-transform {key}")
    record["function_level_pretransform"] = {
        "rows_per_rank": (1 << 20) // MESH_RANKS, "medians_bit_equal": True, "f64_rows": N_KERNEL,
        "seconds_rank0": ranks[0]["pt_f32"]["seconds"], "seconds_per_rank": [r["pt_f32"]["seconds"] for r in ranks],
        "single_gpu_seconds": single_pt_s, **distances,
    }
    # (a, fast) The same fit under sweep_precision="fast": K2 once a rank on the one-pass path.
    fast = ranks[0]["f32_fast"]
    for rank, result in enumerate(ranks):
        check(result["f32_fast"]["launches_by_path"] == _one_launch_each(_build.PATH_TF32, _build.PATH_TF32_1),
              f"mesh f32 fast rank {rank}: launches {result['f32_fast']['launches_by_path']}")
    single_errors = single["f32"]["loo_errors_gammas"].astype(np.float64)
    fast_gap = float(single_errors[int(fast["optimum_index"])]) / float(single_errors.min()) - 1.0
    fast_loo_diff = abs(float(fast["loo_score"]) - float(single["f32"]["loo_score"]))
    check(fast_gap <= 1e-3, f"mesh f32 fast: γ {fast_gap} from optimal under one GPU's high objective")
    check(fast_loo_diff <= 0.01, f"mesh f32 fast: LOO R² {fast['loo_score']} vs {single['f32']['loo_score']}")
    record["function_level_fast"] = {
        "seconds_rank0": fast["seconds"], "loo_score": float(fast["loo_score"]), "loo_score_diff_from_single_high": fast_loo_diff,
        "gamma_index": int(fast["optimum_index"]), "gamma_gap": fast_gap,
        "launches_per_rank": [r["f32_fast"]["launches_by_path"] for r in ranks],
    }
    # (b) The feature axis, (2, 2): plain torch passes, no kernel.
    feature = ranks[0]["feature_axis"]
    check(all(v == 0 for p in feature["launches_by_path"].values() for v in p.values()), "mesh (2, 2) launched a kernel")
    check(abs(float(feature["loo_score"]) - loo_a) <= MESH_LOO_TOL, f"mesh (2, 2): LOO R² {feature['loo_score']} vs {loo_a}")
    record["feature_axis"] = {"mesh": [MESH_RANKS // 2, 2], "seconds_rank0": feature["seconds"],
                              "loo_score": float(feature["loo_score"]), "gamma_index": int(feature["optimum_index"])}
    # (c) The estimator, NeoLSSVM(mesh="auto") on 4,194,304 rows.
    record["estimator"] = {"n": N_MESH_FIT,
                           **hold_estimator_ranks(ranks, single_model, single_predict, single_draws, MESH_DIR, "gloo"),
                           "single_fit_s": single_fit_s, "single_gpu_peak_memory_bytes": single_peak,
                           "note": "four ranks share one card and sum through the host: the times say nothing of scaling"}
    estimator_launches = {name: [r["estimator"]["launches_by_path"][name][_build.PATH_TF32] for r in ranks]
                          for name in ("fused_augmented_gram", "fused_loo_sweep", "fused_pass3")}
    estimator_launches["fused_loo_sweep_one_pass"] = [r["f32_fast"]["launches_by_path"]["fused_loo_sweep"][_build.PATH_TF32_1]
                                                      for r in ranks]
    for name in ("fused_augmented_gram", "fused_loo_sweep"):  # (a) in f64, 131,072 rows
        estimator_launches[f"{name}_f64"] = [r["f64"]["launches_by_path"][name][_build.PATH_FP64] for r in ranks]
    # (d) NCCL: a world of one rank through the mesh route, against the default 1M fit.
    dist.init_process_group("nccl", init_method=f"file://{MESH_DIR}/rendezvous-nccl-one", world_size=1, rank=0)
    try:
        mesh = make_mesh(num_data=1)
        reset_launches()
        one_s, one = timed(lambda: NeoLSSVM(device=dev, mesh=mesh).fit(X, y))
        one_launches = read_launches("the NCCL world-of-one fit")
    finally:
        dist.destroy_process_group()
    ref_s, ref = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
    check(one.γ_ == ref.γ_ and abs(one.loo_score_ - ref.loo_score_) <= 1e-6,
          f"mesh NCCL world of one: γ {one.γ_} vs {ref.γ_}, LOO R² {one.loo_score_} vs {ref.loo_score_}")
    record["nccl_world_of_one"] = {"n": len(y), "fit_s": one_s, "single_fit_s": ref_s, "gamma": one.γ_,
                                   "loo_score": one.loo_score_, "single_loo_score": ref.loo_score_, "launches": one_launches}
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = min(cards, 4)
        nccl = run_ranks(world, MESH_DIR, "nccl", ("estimator",))
        record["nccl_cards"] = {**hold_estimator_ranks(nccl, single_model, single_predict, single_draws, MESH_DIR, "nccl"),
                                "single_fit_s": single_fit_s}
    else:
        record["nccl_cards"] = f"not run: {cards} card"
    emit(record)
    return estimator_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    # The caller's TF32 is on for the whole run: every gate must pass with it, which shows
    # that the port's fits and serving entries scope their own products (utils/precision.py).
    torch.backends.cuda.matmul.fp32_precision = "tf32"
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    if name != CARD:
        raise RuntimeError(f"bound_ms needs the data-sheet peaks of {name!r}; this script holds {CARD!r}'s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "torch": torch.__version__,
          "cuda": torch.version.cuda, "ptxas": ptxas_report(_build.build_log)})
    if sys.argv[1:] == ["mesh"]:  # the mesh phase alone, e.g. on a machine with several cards
        phase_mesh(dev)
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
        return 0
    data = phase_gram(dev)
    phase_sweep(data)
    del data
    torch.cuda.empty_cache()
    phase_ragged(dev)
    phase_parity_small(dev)
    gram_record, sweep_record, pass3_record, high_1m = phase_fit_1m(dev)
    fast_record = phase_fast(dev, high_1m)
    gram64_record, sweep64_record = phase_fit_1m_f64(dev)
    phase_fit_262k(dev)
    phase_fit_dual(dev)
    phase_nan_on_card(dev)
    X, y = make_dataset(1 << 20, D_IN, seed=0)
    X_test, y_test = make_dataset(65_536, D_IN, seed=1)
    phase_native(y)
    classifier = phase_calibration(X, y, X_test, y_test, dev)
    regressor = phase_conformal(X, y, X_test, y_test, dev)
    phase_state_dict({"classifier": classifier, "regressor": regressor}, X_test, dev)
    del classifier, regressor
    phase_tensor_io(X, y, dev)
    mesh_launches = phase_mesh(dev)
    kernels = [gram_record, sweep_record, pass3_record, fast_record, gram64_record, sweep64_record]
    for kernel in kernels:
        kernel["mesh_launches_per_rank"] = mesh_launches[kernel["name"]]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
