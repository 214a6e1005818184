"""Op layer: the host pre-transform (quantizer, affine stack, random Fourier features), the
device pre-transform, the kernel matrices of the dual route, and the CUDA kernels.

The names the JAX package's ``neo_ls_svm_tpu.ops`` exports, under the port's names
(``weighted_quantile_torch`` for ``weighted_quantile_jax``). The host ``weighted_quantile``
function is not re-exported: its name is its submodule's, which it would shadow. Import it
from ``neo_ls_svm_torch.ops.weighted_quantile``.
"""

from neo_ls_svm_torch.ops.affine import AffineFeatureMap, AffineNormalizer, AffineSeparator
from neo_ls_svm_torch.ops.kernels import rbf_kernel, squared_distances
from neo_ls_svm_torch.ops.orff import (
    KernelApproximatingFeatureMap,
    OrthogonalRandomFourierFeatures,
    RandomFourierFeatures,
    complexity_sinc_matrix,
)
from neo_ls_svm_torch.ops.quantizer import (
    Quantizer,
    hist_quantized_ecdf,
    sample_bins_quantized_ecdf,
    sample_weights_quantized_ecdf,
)
from neo_ls_svm_torch.ops.weighted_quantile import weighted_quantile_torch

__all__ = [
    "AffineFeatureMap",
    "AffineNormalizer",
    "AffineSeparator",
    "KernelApproximatingFeatureMap",
    "OrthogonalRandomFourierFeatures",
    "Quantizer",
    "RandomFourierFeatures",
    "complexity_sinc_matrix",
    "hist_quantized_ecdf",
    "rbf_kernel",
    "sample_bins_quantized_ecdf",
    "sample_weights_quantized_ecdf",
    "squared_distances",
    "weighted_quantile_torch",
]
