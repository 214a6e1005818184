"""Neo LS-SVM — the sklearn-compatible estimator, on PyTorch and CUDA inside.

PyTorch port of ``neo_ls_svm_tpu.models.estimator``: validation, task-type inference, the
primal / dual and in-memory / streaming route splits, and pandas passthrough happen at the
host boundary (mirroring the reference's ``NeoLSSVM``, ref ``_neo_ls_svm.py:43-821``);
every O(n·D)+ floating-point operation runs on the estimator's device through
``models/primal.py`` (n > 1024) or ``models/dual.py`` (n ≤ 1024). The supervised
pre-transform of a primal fit runs on the host in NumPy, bit-equal to the reference, or on
the device (``ops/pretransform_device.py``) once the feature payload reaches
``routing.AUTO_DEVICE_PT_MIN_BYTES`` or when ``pre_transform="device"`` asks for it.

The estimator runs on the card (``device="cuda"``, the default) unless the caller asks
for the CPU with ``device="cpu"``; it never moves to the CPU on its own. What this port
does not cover yet raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that
ports it.
"""

from typing import TYPE_CHECKING, Any, Literal

import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.models import routing
from neo_ls_svm_torch.models.dual import dual_decision_function, dual_fit, dual_predict_var
from neo_ls_svm_torch.models.primal import (
    gamma_grid,
    primal_decision_function,
    primal_fit,
    primal_fit_streaming,
    primal_predict_var,
    trim_per_row,
)
from neo_ls_svm_torch.ops.affine import AffineSeparator
from neo_ls_svm_torch.ops.orff import (
    KernelApproximatingFeatureMap,
    OrthogonalRandomFourierFeatures,
    RandomFourierFeatures,
)
from neo_ls_svm_torch.ops.pretransform_device import DEVICE_PRETRANSFORM_BINS, device_pre_transform
from neo_ls_svm_torch.utils.base import BaseEstimator, clone
from neo_ls_svm_torch.utils.metrics import accuracy_score, r2_score
from neo_ls_svm_torch.utils.transfer import upload_rows
from neo_ls_svm_torch.utils.validation import (
    _check_n_features,
    check_array,
    check_consistent_length,
    check_is_fitted,
    check_random_state,
    check_X_y,
    is_pandas,
)

if TYPE_CHECKING:  # pandas is an optional I/O convenience, never a runtime dependency.
    import pandas as pd

DUAL_THRESHOLD = 1024  # n ≤ 1024 → dual space (ref _neo_ls_svm.py:375).
STREAMING_BYTES_THRESHOLD = 6 * 1024**3  # In-memory working set above this → stream.
STREAMING_ROW_CHUNK = 32768
PREDICT_CHUNK_ROWS = 1 << 20  # Chunk predictions beyond this many rows (bounds the
# transient n×2M feature block on the device).
# What a fit leaves behind and a refit must not serve: route-conditional attributes
# (``classes_``, the dual route's ``X_``) would leak across task types and routes.
_FIT_STATE = (
    "_device_cache",
    "classes_",
    "X_",
    "α̂_",
    "_chol",
    "beta_emb_",
    "β̂_",
    "_eig_Qs",
    "_eig_lam",
    "loo_leverage_",
    "primal_feature_map_",
    "dual_feature_map_",
    "_M_map",
    "_b_map",
    "_inv_c0",
)


def _primal_working_set_bytes(n_rows: int, num_features: int, itemsize: int) -> int:
    """Primal-solver working-set estimate: ~3 transient copies of the n×2M real
    embedding of φ. The fit's route decision thresholds on it."""
    return 3 * n_rows * 2 * (num_features + 1) * itemsize


def _maybe_pandas_series(values: npt.NDArray, X_df: Any) -> Any:
    if is_pandas(X_df):
        try:
            import pandas as pd
        except ImportError:
            return values
        return pd.Series(values, index=X_df.index)
    return values


def _to_device(a: npt.NDArray, device: torch.device) -> torch.Tensor:
    """Host array → tensor on ``device`` (a read-only array is copied first: torch
    warns on wrapping a non-writable buffer)."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to neo_ls_svm_torch yet (ROADMAP.md, {item}); "
        "use neo_ls_svm_tpu for it."
    )


def _reject_tensor(*values: Any) -> None:
    if any(isinstance(v, torch.Tensor) for v in values):
        raise _not_ported("torch.Tensor input", "Queue 1 item 8, device-resident I/O")


class NeoLSSVM(BaseEstimator):
    """Neo LS-SVM: a modern least-squares SVM with O(n) training and hyperparameter-free
    LOO tuning, running its linear algebra on an NVIDIA GPU through PyTorch and
    hand-written CUDA kernels.

    ``device`` names the torch device the solver runs on. It defaults to ``"cuda"``;
    ``fit`` raises when CUDA is unavailable unless ``device="cpu"`` was passed.
    """

    def __init__(
        self,
        *,
        primal_feature_map: KernelApproximatingFeatureMap | Literal["auto"] = "auto",
        dual_feature_map: AffineSeparator | Literal["auto"] = "auto",
        dual: bool | Literal["auto"] = "auto",
        estimator_type: Literal["auto", "classifier", "regressor"] = "auto",
        random_state: int | np.random.RandomState | None = 42,
        precision: Literal["high", "fast"] = "high",
        pre_transform: Literal["auto", "host", "device"] = "auto",
        transfer: Literal["auto", "float32", "bfloat16", "int8"] = "auto",
        mesh: Any = None,
        conformal_method: Literal["exact", "smooth"] = "exact",
        device: str | torch.device = "cuda",
    ) -> None:
        self.primal_feature_map = primal_feature_map
        self.dual_feature_map = dual_feature_map
        self.dual = dual
        self.random_state = random_state
        self.estimator_type = estimator_type
        self.precision = precision
        self.pre_transform = pre_transform
        self.transfer = transfer
        self.mesh = mesh
        self.conformal_method = conformal_method
        self.device = device

    # ------------------------------------------------------------------ fitting

    def _resolve_device(self) -> torch.device:
        device = torch.device(self.device)
        if device.type not in ("cuda", "cpu"):
            msg = f"device must be a CUDA or CPU device, got {self.device!r}."
            raise ValueError(msg)
        if device.type == "cuda" and not torch.cuda.is_available():
            msg = (
                f"NeoLSSVM(device={self.device!r}) needs a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU."
            )
            raise RuntimeError(msg)
        return device

    def _check_options(self) -> None:
        """Reject invalid option values (ValueError) and valid ones this port does not
        cover yet (NotImplementedError)."""
        if self.pre_transform not in ("auto", "host", "device"):
            msg = f"pre_transform must be 'auto', 'host' or 'device', got {self.pre_transform!r}."
            raise ValueError(msg)
        if self.transfer not in ("auto", "float32", "bfloat16", "int8"):
            msg = (
                f"transfer must be 'auto', 'float32', 'bfloat16' or 'int8', "
                f"got {self.transfer!r}."
            )
            raise ValueError(msg)
        if self.conformal_method not in ("exact", "smooth"):
            msg = f"conformal_method must be 'exact' or 'smooth', got {self.conformal_method!r}."
            raise ValueError(msg)
        if self.precision not in ("high", "fast"):
            msg = f"precision must be 'high' or 'fast', got {self.precision!r}."
            raise ValueError(msg)
        if self.transfer not in ("auto", "float32") and self.pre_transform == "host":
            msg = (
                f"transfer={self.transfer!r} requires the on-device pre-transform: the "
                "host pre-transform path carries the bit-parity contract, which a lossy "
                "feature upload would silently break."
            )
            raise ValueError(msg)
        if self.mesh is not None:
            raise _not_ported("mesh", "Queue 1 item 10, multi-GPU")

    def fit(
        self,
        X: "npt.NDArray | pd.DataFrame",
        y: "npt.NDArray | pd.Series",
        sample_weight: "npt.NDArray | pd.Series | None" = None,
    ) -> "NeoLSSVM":
        """Fit this predictor."""
        _reject_tensor(X, y, sample_weight)
        device = self._resolve_device()
        self._check_options()
        X, y = check_X_y(X, y, dtype=(np.float64, np.float32), ensure_min_samples=2)
        y = np.ravel(np.asarray(y))
        sample_weight_ = (
            np.ones(y.shape, X.dtype)
            if sample_weight is None
            else np.ravel(np.asarray(sample_weight)).astype(X.dtype)
        )
        check_consistent_length(y, sample_weight_)
        if np.sum(sample_weight_) <= 0:
            msg = "The sample weights are all zero; at least one weight must be positive."
            raise ValueError(msg)
        for name in _FIT_STATE:
            self.__dict__.pop(name, None)
        self.n_features_in_ = X.shape[1]
        self.y_dtype_: npt.DTypeLike = y.dtype
        self.device_ = device
        # Infer the task type from the target (two classes → classifier; numeric or
        # datetime-like → regressor; ref :347-373).
        unique_y = np.unique(y)
        inferred: str | None = None
        if len(unique_y) == 2:
            inferred = "classifier"
        elif (
            np.issubdtype(y.dtype, np.number)
            or np.issubdtype(y.dtype, np.datetime64)
            or np.issubdtype(y.dtype, np.timedelta64)
        ):
            inferred = "regressor"
        self._estimator_type: str | None = (
            inferred if self.estimator_type == "auto" else self.estimator_type
        )
        if self._estimator_type == "classifier" and len(unique_y) != 2:
            if np.issubdtype(y.dtype, np.floating) and np.any(y != np.round(y)):
                msg = (
                    "Unknown label type: continuous. Maybe you are trying to fit a "
                    "classifier, which expects discrete classes on a regression target."
                )
                raise ValueError(msg)
            msg = (
                "Only binary classification is supported. The type of the target is "
                f"{'multiclass' if len(unique_y) > 2 else 'constant'}."
            )
            raise ValueError(msg)
        if self._estimator_type == "classifier":
            self.classes_: npt.NDArray = unique_y
            y_ = np.ones(y.shape, dtype=X.dtype)
            y_[y == self.classes_[0]] = -1
        elif self._estimator_type == "regressor":
            y_ = y.astype(X.dtype)
        else:
            msg = "Target type not supported"
            raise ValueError(msg)
        is_classifier = self._estimator_type == "classifier"
        if self.precision == "high":
            # f32 accuracy, as the JAX package's Precision.HIGHEST: cuBLAS products in IEEE
            # float32 (TF32 off), the hand-written f32 kernels in 3×TF32 (three tensor-core
            # passes, as HIGHEST's multi-pass bf16). precision="fast" runs the same products
            # in this port (a one-pass variant waits, ROADMAP.md).
            torch.backends.cuda.matmul.allow_tf32 = False
            if torch.backends.cuda.matmul.allow_tf32:
                msg = "TF32 matmuls are still enabled; precision='high' needs IEEE float32."
                raise RuntimeError(msg)
        # Primal vs dual routing (ref :375).
        self.dual_ = bool(X.shape[0] <= DUAL_THRESHOLD if self.dual == "auto" else self.dual)
        self.primal_ = not self.dual_
        fit_route = self._fit_primal if self.primal_ else self._fit_dual
        result = fit_route(X, y_, sample_weight_, is_classifier=is_classifier, device=device)
        self._set_fit_attributes({k: v.cpu().numpy() for k, v in result.items()})
        return self

    def _fit_primal(
        self,
        X: npt.NDArray,
        y_: npt.NDArray,
        sample_weight_: npt.NDArray,
        *,
        is_classifier: bool,
        device: torch.device,
    ) -> dict[str, torch.Tensor]:
        """The primal route (n > 1024): resolve the pre-transform and the solver route,
        then fit on ``device``."""
        self.primal_feature_map_ = clone(
            OrthogonalRandomFourierFeatures()
            if self.primal_feature_map == "auto"
            else self.primal_feature_map
        )
        fm = self.primal_feature_map_
        n_rows = X.shape[0]
        num_features = int(getattr(fm, "num_features", 512))
        working_set_bytes = _primal_working_set_bytes(n_rows, num_features, X.dtype.itemsize)
        route = "streaming" if working_set_bytes > STREAMING_BYTES_THRESHOLD else "inmemory"
        # The device pre-transform applies to a random-Fourier feature map whose
        # complexity matrix is the shipped identity (a subclass overriding
        # `complexity_matrix` needs the whitened-GEVD solver, which the host path feeds).
        device_pt_eligible = (
            isinstance(fm, RandomFourierFeatures)
            and type(fm).complexity_matrix is RandomFourierFeatures.complexity_matrix
        )
        self.pre_transform_, self.transfer_ = routing._resolve_fit_plan(
            self.pre_transform,
            self.transfer,
            payload_bytes=n_rows * X.shape[1] * X.dtype.itemsize,
            device_pt_eligible=device_pt_eligible,
        )
        use_device_pt = self.pre_transform_ == "device" and device_pt_eligible
        # pre_transform_ records the route actually taken: an explicit
        # pre_transform="device" on an ineligible fit falls to the host path.
        self.pre_transform_ = "device" if use_device_pt else "host"
        if self.transfer_ != "float32" and not use_device_pt:
            msg = (
                f"transfer={self.transfer!r} only applies when the fit takes the "
                "on-device pre-transform route (primal, random-Fourier feature map "
                "with the identity complexity matrix); this fit would route "
                f"through {route!r} with the host pre-transform, silently "
                "ignoring the narrow upload you opted into."
            )
            raise ValueError(msg)
        self.γs_ = gamma_grid(X.dtype, num=1024)
        g_d = _to_device(self.γs_, device)
        # Streaming: zero-weight padding rows to a chunk multiple, added before the
        # pre-transform so that their weight excludes them everywhere; num_samples keeps
        # the true n.
        row_pad = (-n_rows) % STREAMING_ROW_CHUNK if route == "streaming" else 0
        X_p = np.vstack([X, np.zeros((row_pad, X.shape[1]), X.dtype)]) if row_pad else X
        y_d = _to_device(np.concatenate([y_, np.zeros(row_pad, X.dtype)]), device)
        s_d = _to_device(np.concatenate([sample_weight_, np.zeros(row_pad, X.dtype)]), device)
        # Zero-weight rows must not shape the int8 grid: an absurd-valued one would stretch
        # it and quantise the real data to zero.
        grid_rows = X[sample_weight_ > 0] if self.transfer_ == "int8" else None
        X_d = upload_rows(X_p, self.transfer_, device, grid_rows=grid_rows)
        C_emb = None
        pt: dict[str, torch.Tensor] = {}
        if use_device_pt:
            generator = torch.Generator(device=device)
            generator.manual_seed(self._device_pt_seed())
            affine = fm.affine_feature_map
            pt = device_pre_transform(
                X_d,
                y_d,
                s_d,
                generator,
                num_bins=2 if is_classifier else DEVICE_PRETRANSFORM_BINS,
                num_features=num_features,
                edge_sample_size=int(getattr(affine, "edge_sample_size", 384)),
                edge_search_multiplier=int(getattr(affine, "edge_search_multiplier", 4)),
                rank_threshold=float(getattr(affine, "rank_threshold", 2e-2)),
                is_classifier=is_classifier,
                # A plain RandomFourierFeatures map keeps its configured i.i.d. Gaussian
                # draw; only the orthogonal variant gets the blockwise QR + χ rescale.
                orthogonal=isinstance(fm, OrthogonalRandomFourierFeatures),
            )
            M_d, b_d = pt.pop("M"), pt.pop("b")
        else:
            fm.fit(X, y_, sample_weight_)
            M_map, b_map = fm.linear_map()
            M_d, b_d = _to_device(M_map.astype(X.dtype), device), _to_device(b_map.astype(X.dtype), device)
            # Surface-complexity regulariser. The shipped complexity matrix is the identity
            # (C_emb=None); a custom feature map with a nontrivial matrix routes through the
            # whitened-GEVD path (ref _neo_ls_svm.py:116-124).
            C = np.asarray(fm.complexity_matrix, dtype=X.dtype)
            if not np.array_equiv(C, C[0, 0] * np.eye(C.shape[0], dtype=X.dtype)):
                C_n = C / (np.mean(np.abs(np.diag(C))) * (n_rows * C.shape[0]))
                zeros = np.zeros_like(C_n)
                C_emb = _to_device(np.block([[C_n, zeros], [zeros, C_n]]), device)
        if route == "streaming":
            result = primal_fit_streaming(
                X_d,
                M_d,
                b_d,
                y_d,
                s_d,
                g_d,
                C_emb,
                is_classifier=is_classifier,
                row_chunk=STREAMING_ROW_CHUNK,
                num_samples=n_rows,
            )
            result = trim_per_row(result, n_rows)
        else:
            result = primal_fit(
                X_d, M_d, b_d, y_d, s_d, g_d, C_emb, is_classifier=is_classifier, num_samples=n_rows
            )
        # The GEVD (custom-C) eigenbasis is C-orthonormal: resolvent scale is 1.
        self._inv_c0 = 1.0 if C_emb is not None else float(n_rows * (num_features + 1))
        self._device_cache = {
            "beta_emb": result["beta_emb"],
            "Qs": result["Qs"],
            "lam": result["lam"],
            "M_map": M_d,
            "b_map": b_d,
        }
        return {**result, "M_map": M_d, "b_map": b_d, **pt}

    def _device_pt_seed(self) -> int:
        """The generator seed of the device pre-transform, from ``random_state``."""
        rs = self.random_state
        if isinstance(rs, (int, np.integer)):
            return int(rs)
        return int(check_random_state(rs).randint(0, 2**31 - 1))

    def _fit_dual(
        self,
        X: npt.NDArray,
        y_: npt.NDArray,
        sample_weight_: npt.NDArray,
        *,
        is_classifier: bool,
        device: torch.device,
    ) -> dict[str, torch.Tensor]:
        """The dual route (n ≤ 1024, or ``dual=True``): the host pre-transform, then the
        kernel system on ``device``."""
        if self.transfer not in ("auto", "float32"):
            msg = (
                f"transfer={self.transfer!r} only applies to the on-device "
                f"pre-transform route; this fit (n={X.shape[0]} ≤ {DUAL_THRESHOLD}) "
                "routes to the dual solver with the host pre-transform."
            )
            raise ValueError(msg)
        self.pre_transform_, self.transfer_ = "host", "float32"
        nz = sample_weight_ > 0
        X, y_, sample_weight_ = X[nz], y_[nz], sample_weight_[nz]
        self.dual_feature_map_ = clone(
            AffineSeparator() if self.dual_feature_map == "auto" else self.dual_feature_map
        )
        self.dual_feature_map_.fit(X, y_, sample_weight_)
        self.X_ = self.dual_feature_map_.transform(X)
        self.γs_ = gamma_grid(X.dtype, num=128)
        X_d = _to_device(self.X_, device)
        result = dual_fit(
            X_d,
            _to_device(y_, device),
            _to_device(sample_weight_, device),
            _to_device(self.γs_, device),
            is_classifier=is_classifier,
        )
        self._device_cache = {"alpha": result["alpha"], "chol": result["chol"], "X_train": X_d}
        return result

    def _set_fit_attributes(self, result: dict[str, npt.NDArray]) -> None:
        """The reference's fitted attributes (ref :146-187) as NumPy arrays."""
        self.γ_ = float(result["gamma"])
        if self.primal_:
            beta_emb = result["beta_emb"]
            M = beta_emb.shape[0] // 2
            self.beta_emb_ = beta_emb
            # Reference-compatible complex coefficient view: β̂ = u + i·v.
            self.β̂_ = beta_emb[:M] + 1j * beta_emb[M:]
            self._eig_Qs = result["Qs"]
            self._eig_lam = result["lam"]
            self.loo_leverage_ = result["loo_leverage"]
            self._M_map, self._b_map = result["M_map"], result["b_map"]
            if "pt_folded" in result:
                # pre_transform="device": the pre-transform state was fitted on the
                # device; populate the host feature map from the one pull.
                fm = self.primal_feature_map_
                affine = fm.affine_feature_map
                affine.n_features_in_ = fm.n_features_in_ = self.n_features_in_
                affine.shift_ = result["pt_shift"]
                affine.scale_ = result["pt_scale"]
                affine.A_ = result["pt_folded"]
                fm.Z_ = result["pt_Z"]
                fm.prefold_A_ = result["pt_A"]
                fm.folded_A_ = result["pt_folded"]
        else:
            self.α̂_ = result["alpha"]
            self._chol = result["chol"]
        self.loo_errors_γs_ = result["loo_errors_gammas"]
        self.loo_residuals_ = result["loo_residuals"]
        self.loo_ŷ_ = result["loo_yhat"]
        self.loo_error_ = float(result["loo_error"])
        self.loo_score_ = float(result["loo_score"])
        self.loo_std_ = result["loo_std"]
        self.residuals_ = result["residuals"]

    # ------------------------------------------------------------- core predictors

    def _compute_dtype(self) -> np.dtype:
        """The dtype the fit ran in, which serving runs in too."""
        return (self._M_map if self.primal_ else self.X_).dtype

    def _device(self, key: str) -> torch.Tensor:
        """A serving tensor on the fit's device, uploaded from the host state on first
        use (e.g. after a restore from a state dict)."""
        cache = self.__dict__.setdefault("_device_cache", {})
        if key not in cache:
            dtype = self._compute_dtype()
            host = {
                "beta_emb": lambda: self.beta_emb_,
                "Qs": lambda: self._eig_Qs,
                "lam": lambda: self._eig_lam,
                "M_map": lambda: self._M_map,
                "b_map": lambda: self._b_map,
                "gamma": lambda: np.asarray(self.γ_, dtype=dtype),
                "inv_c0": lambda: np.asarray(self._inv_c0, dtype=dtype),
                "alpha": lambda: self.α̂_,
                "chol": lambda: self._chol,
                "X_train": lambda: self.X_,
            }[key]()
            cache[key] = _to_device(np.asarray(host, dtype=dtype), self.device_)
        return cache[key]

    def _in_chunks(self, X: npt.NDArray, fn: Any) -> npt.NDArray:
        """Apply a device function over row chunks of X and return a host array. A chunk
        crosses to the device at the width the model was fitted with (``transfer_``)."""
        X = X.astype(self._compute_dtype(), copy=False)
        parts = [
            fn(upload_rows(X[start : start + PREDICT_CHUNK_ROWS], self.transfer_, self.device_))
            for start in range(0, X.shape[0], PREDICT_CHUNK_ROWS)
        ]
        return torch.cat(parts).cpu().numpy()

    def _validated(self, X: Any) -> npt.NDArray:
        check_is_fitted(self, ["γ_"])
        _reject_tensor(X)
        return _check_n_features(self, check_array(X, dtype=(np.float64, np.float32)))

    def _decision(self, X_np: npt.NDArray) -> npt.NDArray:
        if self.primal_:
            return self._in_chunks(
                X_np,
                lambda X_c: primal_decision_function(
                    X_c, self._device("M_map"), self._device("b_map"), self._device("beta_emb")
                ),
            )
        return self._in_chunks(
            self.dual_feature_map_.transform(X_np),
            lambda X_c: dual_decision_function(X_c, self._device("X_train"), self._device("alpha")),
        )

    def decision_function(self, X: "npt.NDArray | pd.DataFrame") -> "npt.NDArray | pd.Series":
        """Evaluate the prediction function ŷ(x) (ref ``:655-681``)."""
        return _maybe_pandas_series(self._decision(self._validated(X)), X)

    def predict_std(self, X: "npt.NDArray | pd.DataFrame") -> "npt.NDArray | pd.Series":
        """Bayesian estimate of the predictive standard deviation (ref ``:452-487``)."""
        X_np = self._validated(X)
        if self.primal_:
            var = self._in_chunks(
                X_np,
                lambda X_c: primal_predict_var(
                    X_c,
                    self._device("M_map"),
                    self._device("b_map"),
                    self._device("Qs"),
                    self._device("lam"),
                    self._device("gamma"),
                    self._device("inv_c0"),
                ),
            )
        else:
            var = self._in_chunks(
                self.dual_feature_map_.transform(X_np),
                lambda X_c: dual_predict_var(X_c, self._device("X_train"), self._device("chol")),
            )
        return _maybe_pandas_series(np.sqrt(np.maximum(var, 0.0)), X)

    # ------------------------------------------------------------------- prediction

    def predict(
        self,
        X: "npt.NDArray | pd.DataFrame",
        *,
        coverage: float | None = None,
        quantiles: npt.ArrayLike | None = None,
    ) -> "npt.NDArray | pd.Series":
        """Predict labels (classifier) or values (regressor) on a given dataset."""
        if coverage is not None or quantiles is not None:
            raise _not_ported("predict(coverage=…/quantiles=…)", "Queue 1 item 7, calibration")
        yhat_df = self._decision(self._validated(X))
        if self._estimator_type == "classifier":
            # Ties at 0 break to the negative class (sklearn decision_function contract).
            yhat_sign = np.sign(yhat_df)
            yhat_sign[yhat_sign == 0] = -1
            yhat = self.classes_[((yhat_sign + 1) // 2).astype(np.intp)]
        else:
            yhat = yhat_df
        if not np.issubdtype(self.y_dtype_, np.integer):
            yhat = yhat.astype(self.y_dtype_)
        return _maybe_pandas_series(yhat, X)

    def predict_proba(self, X: Any) -> Any:
        """Calibrated class probabilities: not ported yet."""
        raise _not_ported("predict_proba", "Queue 1 item 7, calibration")

    def predict_quantiles(self, X: Any, *, quantiles: Any = (0.025, 0.05, 0.1, 0.5, 0.9, 0.95, 0.975)) -> Any:
        """Conformally calibrated quantiles: not ported yet."""
        raise _not_ported("predict_quantiles", "Queue 1 item 7, calibration")

    def predict_interval(self, X: Any, *, coverage: float = 0.95) -> Any:
        """Conformally calibrated prediction intervals: not ported yet."""
        raise _not_ported("predict_interval", "Queue 1 item 7, calibration")

    def score(
        self,
        X: "npt.NDArray | pd.DataFrame",
        y: "npt.NDArray | pd.Series",
        sample_weight: npt.NDArray | None = None,
    ) -> float:
        """Accuracy (classifier) or R² (regressor) on the given data."""
        yhat = self.predict(X)
        if self._estimator_type == "classifier":
            return accuracy_score(np.asarray(y), np.asarray(yhat), sample_weight=sample_weight)
        return r2_score(
            np.asarray(y).astype(np.float64),
            np.asarray(yhat).astype(np.float64),
            sample_weight=sample_weight,
        )
