"""Neo LS-SVM on PyTorch and CUDA: the port of ``neo_ls_svm_tpu`` to NVIDIA GPUs.

The one exported symbol is ``NeoLSSVM``; the building blocks (feature maps, affine
stack, solvers, kernels) are importable from their submodules. The package imports
``torch``, ``numpy`` and ``scipy`` only — never ``jax`` or the JAX package.
"""

from neo_ls_svm_torch.models.estimator import NeoLSSVM

__all__ = ["NeoLSSVM"]
