"""The port's device rules, in one place.

An entry point runs on the card unless the caller asks for the CPU, and never moves to the
CPU on its own (:func:`resolve_device`). A ``torch.Tensor`` given to ``fit`` or to a serving
entry must already lie on the model's device (:func:`require_device`): nothing is moved
silently. Counterpart of ``neo_ls_svm_tpu.utils.validation.is_device_array`` and of the
``jax.device_put`` calls spread over the JAX estimator.
"""

from typing import Any

import numpy as np
import numpy.typing as npt
import torch


def is_tensor(value: Any) -> bool:
    """True for a ``torch.Tensor``: the one test ``fit`` and the serving entries apply to
    X, y and the sample weights alike."""
    return isinstance(value, torch.Tensor)


def resolve_device(device: "str | torch.device") -> torch.device:
    """``device`` as a CUDA or CPU ``torch.device``; raises when it names a CUDA device
    and none is available."""
    resolved = torch.device(device)
    if resolved.type not in ("cuda", "cpu"):
        msg = f"device must be a CUDA or CPU device, got {device!r}."
        raise ValueError(msg)
    if resolved.type == "cuda" and not torch.cuda.is_available():
        msg = (
            f"device={device!r} needs a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU."
        )
        raise RuntimeError(msg)
    return resolved


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one (``cuda`` without an index is the current CUDA device)."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def require_device(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise ``ValueError`` naming both devices unless ``tensor`` lies on ``device``."""
    if not same_device(tensor.device, device):
        msg = (
            f"{what} is a tensor on {tensor.device}, but the model runs on {device}; "
            f"move it with .to({str(device)!r}) first (nothing is moved silently)."
        )
        raise ValueError(msg)


def padded(a: torch.Tensor, pad: int, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` on ``device`` at ``dtype`` (``a``'s own when None), followed by ``pad`` zero
    rows written there. The rows cross at ``a``'s width and widen on ``device``, into one
    buffer: no padded copy of ``a`` is made on the host or beside it on the device. With
    no pad this is ``a.to(device).to(dtype)``, which copies nothing that is in place."""
    dtype = a.dtype if dtype is None else dtype
    if not pad:
        return a.to(device).to(dtype)
    out = torch.empty((a.shape[0] + pad, *a.shape[1:]), dtype=dtype, device=device)
    out[a.shape[0] :].zero_()
    # A host→device copy_ between dtypes would convert on the host: a crosses first.
    out[: a.shape[0]].copy_(a if a.dtype == dtype else a.to(device))
    return out


def to_device(a: npt.ArrayLike, device: torch.device, dtype: Any = None, pad: int = 0) -> torch.Tensor:
    """Host array → tensor on ``device`` (a read-only array is copied first: torch warns on
    wrapping a non-writable buffer), followed by ``pad`` zero rows (:func:`padded`)."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if not a.flags.writeable:
        a = a.copy()
    return padded(torch.from_numpy(a), pad, device)


def torch_dtype(dtype: npt.DTypeLike) -> torch.dtype:
    """The torch dtype of a NumPy dtype."""
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The NumPy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype
