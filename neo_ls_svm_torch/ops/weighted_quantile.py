"""Weighted quantiles.

Two implementations of the reference's weighted quantile (``_weighted_quantile.py:35-77``):

- :func:`weighted_quantile`: host NumPy, bit-compatible with the reference; the host-side
  supervised pre-transform fit uses it, where exact parity matters.
- :func:`weighted_quantile_torch`: the same convention on tensors, on whatever device they
  lie; the on-device pre-transform uses it to cut the target into equal-mass bins.

Counterparts of ``weighted_quantile`` and ``weighted_quantile_jax`` of
``neo_ls_svm_tpu.ops.weighted_quantile``.

It uses the reference's averaged lower/upper ECDF convention
``(interp(q, p_lower, a) + interp(q, p_upper, a)) / 2`` (rationale at
``_weighted_quantile.py:69-71``: it yields 0.5 for a=(0,1,1), w=(2,1,1), q=0.5 where the
standard midpoint convention does not).
"""

import numpy as np
import numpy.typing as npt
import torch

FloatTensor = npt.NDArray[np.floating]
FloatVector = npt.NDArray[np.floating]


def _batched_interp(q: np.ndarray, p: np.ndarray, a: np.ndarray) -> np.ndarray:
    # Equivalent of the reference's numba ``_parallel_interp``: row-wise np.interp.
    out = np.empty((a.shape[0], len(q)), dtype=a.dtype)
    for i in range(a.shape[0]):
        out[i, :] = np.interp(q, p[i, :], a[i, :])
    return out


# Tests flip this off to compare the O(n) uniform-weight fast path against the
# general argsort path on identical inputs (they must agree BIT-exactly).
_ENABLE_UNIFORM_FAST_PATH = True


def _uniform_weight_quantile_2d(a: np.ndarray, w0: np.ndarray, q: float) -> np.ndarray:
    """Bit-exact fast path of :func:`weighted_quantile` for UNIFORM weights, 2-D a,
    ``axis=0``, one quantile.

    With equal weights the sorted-weight vector — hence both ECDF position arrays —
    is data-independent, so the full O(n log n) argsort reduces to an O(n)
    ``np.partition`` for the 2×2 bracketing order statistics. Exactness: the p
    arrays are reconstructed with the same cumsum arithmetic the general path uses,
    the bracket index is ``np.interp``'s own choice (largest j with p[j] ≤ q, i.e.
    ``searchsorted(..., 'right') - 1``), and the final interpolation reuses
    ``np.interp`` on the bracketing pair — identical floating-point operations to
    the general path, which reads only those two entries anyway.

    One caveat: among tied ±0.0 values, partition and argsort may select a
    differently-SIGNED zero representative (both paths' tie order is arbitrary);
    the results compare equal (−0.0 == +0.0) but can differ in the sign bit.
    """
    n, d = a.shape
    # The p arrays carry the WEIGHT dtype in the general path (cumsum of the sorted
    # weights), independent of a's dtype — reproduce that exactly.
    w_vec = np.full(n, w0, dtype=w0.dtype)
    cw = np.cumsum(w_vec)
    total = cw[-1]
    p_lower = (cw - w_vec) / total
    p_upper = cw / total

    def bracket(p_vec: np.ndarray) -> tuple[int, int]:
        j = int(np.searchsorted(p_vec, q, side="right")) - 1
        if j < 0:
            return 0, 0  # q below p[0]: np.interp clamps to fp[0]
        if j >= n - 1:
            return n - 1, n - 1  # q at/above p[-1]: clamps to fp[-1]
        return j, j + 1

    lo0, lo1 = bracket(p_lower)
    up0, up1 = bracket(p_upper)
    kth = sorted({lo0, lo1, up0, up1})
    at = np.ascontiguousarray(a.T)  # (d, n): partition along the contiguous axis
    part = np.partition(at, kth, axis=1)
    result = np.empty((1, d), dtype=a.dtype)
    for col in range(d):
        vals = {k: part[col, k] for k in kth}
        lower = np.interp(q, p_lower[[lo0, lo1]], [vals[lo0], vals[lo1]])
        upper = np.interp(q, p_upper[[up0, up1]], [vals[up0], vals[up1]])
        result[0, col] = (np.asarray(lower, a.dtype) + np.asarray(upper, a.dtype)) / 2
    return result


def weighted_quantile(
    a: FloatTensor,
    w: FloatTensor,
    q: float | FloatVector,
    axis: int | None = None,
) -> np.ndarray:
    """Compute the weighted q'th quantile of the data along the specified axis."""
    a = np.ascontiguousarray(np.asarray(a))
    w = np.ascontiguousarray(np.asarray(w))
    assert a.ndim == w.ndim, "Array and weights must have the same number of dimensions"
    assert axis is None or (0 <= axis < a.ndim), "Axis must be one of the array's dimensions"
    assert np.all(w >= 0), "Weights must be nonnegative"
    # Uniformity is checked on the PRE-broadcast weights (O(n), not O(n·d) over the
    # broadcast view, and non-uniform callers skip straight to the general path).
    uniform_w = w.size > 0 and np.ptp(w) == 0 and float(w.flat[0]) > 0
    w = np.broadcast_to(w, a.shape)
    q_arr = np.ravel(np.asarray([q])).astype(a.dtype)
    if (
        _ENABLE_UNIFORM_FAST_PATH
        and uniform_w
        and axis == 0
        and a.ndim == 2
        and q_arr.size == 1
        and a.shape[0] >= 64
    ):
        return _uniform_weight_quantile_2d(a, w.flat[0], float(q_arr[0]))
    if axis is None:
        a_flat, w_flat = np.ravel(a), np.ravel(w)
        order = np.argsort(a_flat)
        a_sorted, w_sorted = a_flat[order], w_flat[order]
        cw = np.cumsum(w_sorted)
        p_lower = (cw - w_sorted) / cw[-1]
        p_upper = cw / cw[-1]
        result = (
            0.5 * np.interp(q_arr, p_lower, a_sorted) + 0.5 * np.interp(q_arr, p_upper, a_sorted)
        ).astype(a.dtype)
        return result
    # Move the reduction axis last and flatten the leading axes into rows.
    a_moved, w_moved = np.moveaxis(a, axis, -1), np.moveaxis(w, axis, -1)
    lead_shape = a_moved.shape
    rows_a = np.reshape(a_moved, (-1, lead_shape[-1]))
    rows_w = np.reshape(w_moved, (-1, lead_shape[-1]))
    order = np.argsort(rows_a, axis=1)
    rows_a = np.take_along_axis(rows_a, order, axis=1)
    rows_w = np.take_along_axis(rows_w, order, axis=1)
    cw = np.cumsum(rows_w, axis=1)
    total = cw[:, [-1]].copy()
    p_lower = (cw - rows_w) / total
    p_upper = cw / total
    result = (_batched_interp(q_arr, p_lower, rows_a) + _batched_interp(q_arr, p_upper, rows_a)) / 2
    result = np.reshape(result, lead_shape[:-1] + (len(q_arr),))
    result = np.moveaxis(result, -1, axis)
    return result


def _interp_rows(q: torch.Tensor, p: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Row-wise linear interpolation of the points (p[r], a[r]) at every q: (R, Q).

    ``torch`` has no ``interp``. This one follows ``jnp.interp``: the bracket is the last
    knot at or below q (``searchsorted`` from the right, so among tied knots the last
    wins), a zero-width bracket returns its left value, and q outside the knots takes the
    end values.
    """
    n = p.shape[1]
    qq = q.expand(p.shape[0], -1).contiguous()
    i = torch.searchsorted(p.contiguous(), qq, right=True).clamp(1, n - 1)
    p_lo, p_hi = torch.gather(p, 1, i - 1), torch.gather(p, 1, i)
    a_lo, a_hi = torch.gather(a, 1, i - 1), torch.gather(a, 1, i)
    dx = p_hi - p_lo
    np_dtype = np.float64 if p.dtype == torch.float64 else np.float32
    flat = dx.abs() <= float(np.spacing(np.finfo(np_dtype).eps))
    f = torch.where(flat, a_lo, a_lo + ((qq - p_lo) / torch.where(flat, torch.ones_like(dx), dx)) * (a_hi - a_lo))
    f = torch.where(qq < p[:, :1], a[:, :1], f)
    return torch.where(qq > p[:, -1:], a[:, -1:], f)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for a vector x and one set of knots, on tensors."""
    return _interp_rows(x[None, :], xp[None, :], fp[None, :])[0]


def weighted_quantile_torch(
    a: torch.Tensor, w: torch.Tensor, q: "torch.Tensor | float", axis: int = 0
) -> torch.Tensor:
    """Weighted quantiles along ``axis`` on the tensors' device, with no host read.

    Same averaged lower/upper ECDF convention as :func:`weighted_quantile`.
    """
    a = torch.movedim(a, axis, -1)
    w = torch.movedim(w, axis, -1).expand(a.shape)
    lead_shape = a.shape
    rows_a = a.reshape(-1, lead_shape[-1])
    rows_w = w.reshape(-1, lead_shape[-1])
    order = torch.argsort(rows_a, dim=1, stable=True)
    rows_a = torch.gather(rows_a, 1, order)
    rows_w = torch.gather(rows_w, 1, order)
    cw = torch.cumsum(rows_w, dim=1)
    total = cw[:, -1:]
    p_lower = (cw - rows_w) / total
    p_upper = cw / total
    q = torch.atleast_1d(torch.as_tensor(q, dtype=a.dtype, device=a.device))[None, :]
    result = 0.5 * (_interp_rows(q, p_lower, rows_a) + _interp_rows(q, p_upper, rows_a))
    result = result.reshape(lead_shape[:-1] + (q.shape[1],))
    return torch.movedim(result, -1, axis)
