"""Bit-equality of what two fits of the port leave behind (arrays, tensors, plain values,
dicts and lists of them), for the CPU tests that hold two routes or two settings alike."""

import numpy as np
import torch


def same(a, b) -> bool:
    """Bit-equal arrays and tensors, equal plain values, the same inside dicts and lists."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, (int, float, complex, str, bool, type(None), torch.device)):
        return a == b or (a != a and b != b)
    return type(a) is type(b)  # an object of the fit, such as its feature map
