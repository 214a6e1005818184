"""Op layer: the host pre-transform (quantizer, affine stack, random Fourier features), the
device pre-transform, the kernel matrices of the dual route, and the CUDA kernels."""
