"""The precision of the port's float32 cuBLAS products, scoped to the products themselves.

The JAX package passes ``precision=`` to each ``jnp.dot``: HIGHEST (float32 accuracy) by
default, DEFAULT (one MXU pass) for the γ-sweep's contractions under
``NeoLSSVM(precision="fast")``. PyTorch has no per-call precision for ``torch.matmul``;
it reads one process-wide flag, ``torch.backends.cuda.matmul.fp32_precision``, at each
product. So the port sets that flag around its own products and restores the caller's
value when they are done:

* ``"ieee"`` around ``fit``, every serving entry and the solvers' public functions, so that
  they compute in IEEE float32 whatever the caller set for its own work;
* ``"tf32"`` around the in-memory sweep's two contractions and the feature-axis sweep's
  three products under ``precision="fast"`` (one TF32 pass on the tensor cores).

Only the new API is used: once a caller has set ``fp32_precision``, reading the legacy
``allow_tf32`` raises in PyTorch, so saving through it would break such a caller. Float64
products and CPU products are IEEE whatever the flag says, so on the CPU the scopes change
no result. The flag is per process, not per thread: two threads that enter scopes at once
may restore each other's values out of order.
"""

import contextlib
from collections.abc import Iterator
from typing import Literal

import torch

MatmulPrecision = Literal["ieee", "tf32"]

# The cuBLAS precision of the γ-sweep's products under each NeoLSSVM precision: "high" is
# IEEE float32, as JAX's Precision.HIGHEST; "fast" one TF32 pass, as one MXU pass under
# Precision.DEFAULT.
SWEEP_MATMUL: dict[str, MatmulPrecision] = {"high": "ieee", "fast": "tf32"}


@contextlib.contextmanager
def matmul_precision(precision: MatmulPrecision) -> Iterator[None]:
    """Run the float32 CUDA products inside at ``precision``, then restore the caller's
    setting. Also a decorator: ``@matmul_precision("ieee")``."""
    matmul = torch.backends.cuda.matmul
    saved = matmul.fp32_precision
    matmul.fp32_precision = precision
    try:
        yield
    finally:
        matmul.fp32_precision = saved


def check_sweep_precision(sweep_precision: str) -> None:
    """Raise ``ValueError`` unless ``sweep_precision`` is "high" or "fast"."""
    if sweep_precision not in SWEEP_MATMUL:
        msg = f"sweep_precision must be 'high' or 'fast', got {sweep_precision!r}."
        raise ValueError(msg)
