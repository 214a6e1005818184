"""Kernel-approximating random feature maps.

Rebuild of the reference's feature maps (``_feature_maps.py``): maps φ: Rᵈ → Cᴰ⁺¹ with
φ(x) = [exp(-1j·Z'x)/√D, 1] so that φ(x)ᴴφ(y) approximates the Gaussian kernel
exp(-‖A(x-y)‖²/2) for the learned affine metric A.

Device representation: complex features never materialise on the GPU. The solver
consumes the *linear map* U = X@M + b (the affine pre-transform folded in — ref
``_feature_maps.py:150``) and forms the real pair (cos U, sin U) on the device; all
downstream algebra runs in the real 2(D+1) symmetric embedding of the Hermitian system
(see ``models/primal.py``). The host-side ``transform`` returns the reference-compatible
complex matrix for API parity and testing.

A copy of ``neo_ls_svm_tpu.ops.orff``. The shipped complexity matrix is the identity; the
exact sinc-product matrix (:func:`complexity_sinc_matrix`, jitted XLA code in the JAX
package) is a plain torch function here, reached through
:meth:`RandomFourierFeatures.complexity_matrix_exact`.

RNG parity: Z, its blockwise QR orthogonalisation, and the χ row rescale are drawn from
``np.random.RandomState`` in the reference's call order (``_feature_maps.py:213-222``),
so fitted maps match bit-for-bit for a given ``random_state``.
"""

from abc import ABC, abstractmethod
from typing import Any

import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.ops.affine import AffineFeatureMap, AffineSeparator
from neo_ls_svm_torch.utils.base import BaseEstimator, TransformerMixin
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_torch.utils.validation import check_random_state


@matmul_precision("ieee")
def complexity_sinc_matrix(Z: torch.Tensor, *, fast_approx: bool = False) -> torch.Tensor:
    """Compute ``1/d · Z'Z ∘ [Πₖ sinc(Zₖᵢ - Zₖⱼ)]ᵢⱼ``.

    The surface-complexity regularisation matrix ∫‖∇ₓφ(x)'w‖²dx over the normalised
    feature cube (derivation: ref ``_feature_maps.py:71-96``): one product (Z'Z) and the
    elementwise product of the unnormalised sinc of each row's pairwise differences. With
    ``fast_approx`` the diagonal approximation — the identity — is returned, which is the
    reference's shipped default (``_feature_maps.py:133-135``).
    """
    d, D = Z.shape
    if fast_approx:
        return torch.eye(D, dtype=Z.dtype, device=Z.device)
    gram = Z.T @ Z
    eps = torch.finfo(Z.dtype).eps
    sinc_prod = torch.ones((D, D), dtype=Z.dtype, device=Z.device)
    for k in range(d):
        dz = Z[k, :, None] - Z[k, None, :]
        factor = torch.where(dz.abs() > eps, torch.sin(dz) / torch.where(dz == 0, 1.0, dz), 1.0)
        sinc_prod = sinc_prod * factor
    return gram * sinc_prod / d


class KernelApproximatingFeatureMap(ABC, BaseEstimator, TransformerMixin):
    """Abstract kernel-approximating feature map (ref ``_feature_maps.py:58-114``)."""

    def __init__(
        self,
        affine_feature_map: AffineFeatureMap | None = None,
        num_features: int = 512,
        random_state: Any = 42,
    ):
        self.num_features = num_features
        self.affine_feature_map = affine_feature_map or AffineSeparator()
        self.random_state = random_state

    @property
    def D(self) -> int:
        """Alias for ``num_features``."""
        return self.num_features

    @property
    @abstractmethod
    def complexity_matrix(self) -> npt.NDArray:
        """The (D+1)×(D+1) complexity regularisation matrix (bias entry included)."""

    @abstractmethod
    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "KernelApproximatingFeatureMap":
        """Fit this transformer."""
        self.affine_feature_map.fit(X, y, sample_weight)
        self.n_features_in_ = X.shape[1]
        return self

    @abstractmethod
    def transform(self, X: npt.NDArray) -> npt.NDArray:
        """Transform the given data with this transformer."""

    def linear_map(self) -> tuple[npt.NDArray, npt.NDArray]:
        """Return ``(M, b)`` with U = X@M + b the feature phases, for device fusion.

        ``cos(U)/√D`` and ``-sin(U)/√D`` are the real/imaginary feature planes; the
        trailing bias column of φ is appended downstream.
        """
        M, offset, inv_scale = self.affine_feature_map.linear_form(self.n_features_in_)
        if M is None:
            # Identity-A map: phases are the scaled/shifted features themselves.
            M = np.diag(np.ravel(inv_scale))
            offset = -np.reshape(
                np.ravel(getattr(self.affine_feature_map, "shift_", self.affine_feature_map.shift))
                * np.ravel(inv_scale),
                (1, -1),
            )
        return M, offset


class RandomFourierFeatures(KernelApproximatingFeatureMap):
    """Random Fourier Features: Z ∈ Rᵈˣᴰ with i.i.d. N(0,1) entries.

    Complex features are kept over the real [cos, sin] doubling because they halve the
    linear system (the reference's note 1, ``_feature_maps.py:180-185``); on the GPU the
    complex algebra is carried as the exact real 2(D+1) symmetric embedding instead.
    """

    @classmethod
    def _fourier_features(
        cls, d: int, D: int, dtype: npt.DTypeLike, random_state: Any
    ) -> npt.NDArray:
        generator = check_random_state(random_state)
        Z: npt.NDArray = generator.randn(d, D).astype(dtype)
        return Z

    @property
    def complexity_matrix(self) -> npt.NDArray:
        """The shipped fast-approximation complexity matrix: the identity, extended with
        a diagonal entry that also shrinks the bias (ref ``_feature_maps.py:129-135``)."""
        return np.eye(self.D + 1, dtype=self.Z_.dtype)

    def complexity_matrix_exact(self) -> npt.NDArray:
        """The full sinc-product complexity matrix (the reference's dormant exact path),
        computed on the CPU."""
        C = np.eye(self.D + 1, dtype=self.Z_.dtype)
        C[:-1, :-1] = complexity_sinc_matrix(torch.tensor(self.Z_), fast_approx=False).numpy()
        return C

    def fit(
        self,
        X: npt.NDArray,
        y: npt.NDArray | None = None,
        sample_weight: npt.NDArray | None = None,
    ) -> "RandomFourierFeatures":
        """Fit the affine pre-transform, draw Z, and fold Z into the affine map."""
        super().fit(X, y, sample_weight)
        A = getattr(self.affine_feature_map, "A_", self.affine_feature_map.A)
        # Refit idempotence: if the affine map still carries OUR previous fold (its
        # fit validates but does not re-learn A_ for plain AffineFeatureMaps), undo
        # it — folding Z into an already-folded A@Z would silently corrupt the map.
        folded_prev = getattr(self, "folded_A_", None)
        if (
            A is not None
            and folded_prev is not None
            and A.shape == folded_prev.shape
            and np.array_equal(A, folded_prev)
        ):
            A = self.prefold_A_
        d = A.shape[1] if A is not None else X.shape[1]
        self.Z_: npt.NDArray = self._fourier_features(d, self.D, X.dtype, self.random_state)
        folded = A @ self.Z_ if A is not None else self.Z_
        self.affine_feature_map.A_ = folded
        self.prefold_A_ = A
        self.folded_A_ = folded
        return self

    def transform(self, X: npt.NDArray) -> npt.NDArray:
        """Host-side complex transform φ(X) = [exp(-1j·XA)/√D, 1] ∈ Cⁿˣ⁽ᴰ⁺¹⁾."""
        U = self.affine_feature_map.transform(X)
        out_dtype = np.complex64 if U.dtype == np.float32 else np.complex128
        phi = np.empty((U.shape[0], self.D + 1), dtype=out_dtype)
        phi[:, :-1] = np.exp(-1j * U, dtype=out_dtype) / np.sqrt(self.D)
        phi[:, -1] = 1
        return phi


class OrthogonalRandomFourierFeatures(RandomFourierFeatures):
    """Orthogonal Random Fourier Features: blockwise-orthogonalised Z with χ-rescaled
    row norms, reducing kernel-approximation variance (ref ``_feature_maps.py:206-223``,
    following Yu et al. 2016, arXiv:1610.09072)."""

    @classmethod
    def _fourier_features(
        cls, d: int, D: int, dtype: npt.DTypeLike, random_state: Any
    ) -> npt.NDArray:
        generator = check_random_state(random_state)
        Z: npt.NDArray = generator.randn(d, D).astype(dtype)
        for j in range(0, D, d):
            Q, _ = np.linalg.qr(Z[:, j : j + d])
            Z[:, j : j + d] = Q
        chi_scale = np.sqrt(generator.chisquare(d, size=(1, Z.shape[1])).astype(dtype))
        Z *= chi_scale
        return Z
