"""Narrow host→device uploads: ``transfer="bfloat16"`` and ``transfer="int8"``.

A model fitted with a narrow ``transfer`` casts its feature rows on the host, uploads the
narrow array and widens it on the device, at fit time and per prediction chunk. The
targets and weights stay full precision. Counterpart of the wire modes of
``neo_ls_svm_tpu.utils.transfer``, without its staged chunk-train upload.
"""

from collections.abc import Callable

import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.utils.device import padded
from neo_ls_svm_torch.utils.profiling import span


def symmetric_int8_grid(
    rows: npt.NDArray,
) -> tuple[npt.NDArray, Callable[[npt.NDArray], npt.NDArray]]:
    """Per-column symmetric int8 quantisation grid: ``x ≈ q·scale``, q ∈ [-127, 127].

    Returns ``(scale, cast_fn)`` where ``cast_fn`` quantises rows to int8. The grid rows
    may differ from the cast target (the fit computes the grid from positive-weight rows
    only). Columns whose magnitude is zero, or so small that ``absmax/127`` underflows
    to a subnormal whose reciprocal overflows, fall back to ``scale = 1``: their values
    quantise to 0, which is what they round to anyway.

    Each upload dequantises immediately on the device, so fit-time and serving-time
    uploads may use different grids.
    """
    dtype = rows.dtype
    col_absmax = np.maximum(rows.max(axis=0), -rows.min(axis=0))
    scale = (col_absmax / 127.0).astype(dtype)
    scale = np.where(scale >= np.finfo(dtype).tiny, scale, dtype.type(1.0))
    inv_scale = (1.0 / scale).astype(dtype)

    def cast_fn(chunk: npt.NDArray) -> npt.NDArray:
        return np.clip(np.rint(chunk * inv_scale), -127, 127).astype(np.int8)

    return scale, cast_fn


def upload_rows(
    X: npt.NDArray,
    transfer: str,
    device: torch.device,
    grid_rows: npt.NDArray | None = None,
    pad_rows: int = 0,
) -> torch.Tensor:
    """Feature rows → a tensor of X's dtype on ``device``, crossing at ``transfer``'s width,
    followed by ``pad_rows`` zero rows written on the device.

    ``"float32"`` uploads X as it is (whatever its dtype). ``"bfloat16"`` rounds the
    features to an 8-bit mantissa on the host. ``"int8"`` quantises them on the
    per-column grid of ``grid_rows`` (X itself when None) and multiplies by the grid's
    scale on the device. The result is one ``(n + pad_rows, d)`` buffer on the device: X's
    rows are copied (and widened) into its head and its tail is zero-filled there, so the
    host makes no padded copy of X and the device holds X once at its width. The upload is
    the span ``neo.upload``, whose ``bytes`` attribute counts what crosses to the device and
    ``pad_rows`` the rows zero-filled on it (``utils/profiling.py``).
    """
    with span("neo.upload", device=device) as crossed:
        X = np.ascontiguousarray(X)
        dtype = torch.from_numpy(np.empty(0, X.dtype)).dtype
        crossed["pad_rows"] = pad_rows
        if transfer == "bfloat16":
            crossed["bytes"] = X.size * 2
            return padded(torch.from_numpy(X).to(torch.bfloat16), pad_rows, device, dtype)
        if transfer == "int8":
            scale, cast_fn = symmetric_int8_grid(X if grid_rows is None else grid_rows)
            X_q = cast_fn(X)
            crossed["bytes"] = X_q.nbytes + scale.nbytes
            out = padded(torch.from_numpy(X_q), pad_rows, device, dtype)
            out[: X.shape[0]].mul_(torch.from_numpy(scale).to(device)[None, :])
            return out
        if not X.flags.writeable:
            X = X.copy()  # torch warns on wrapping a non-writable buffer
        crossed["bytes"] = X.nbytes
        return padded(torch.from_numpy(X), pad_rows, device)
