"""Op layer: the host pre-transform (quantizer, affine stack, random Fourier features)
and the CUDA kernels."""
