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
for the CPU with ``device="cpu"``; it never moves to the CPU on its own. ``fit`` and every
serving entry also take a ``torch.Tensor`` that already lies on the model's device: it is
validated from its metadata only (no finiteness scan, no host copy) and the serving
entries answer with a tensor on that device; a tensor on another device raises.

``mesh=`` fits on several GPUs, one process (rank) each (``parallel/mesh.py``): every rank
calls ``fit`` with the full data, the rows are sharded over the mesh's ``data`` axis, and
every rank ends with the whole fitted model on its own GPU, where it serves as a
single-GPU model does.

After a fit, the isotonic calibrator of a classifier and the two-level conformal split are
made at first use (``predict_proba``, ``predict_quantiles``, pickling, …), not in ``fit``:
at a million rows their sorts and permutation are host work of the order of the whole fit.

``fit`` and every serving entry run their float32 cuBLAS products in IEEE float32 and then
restore the caller's ``torch.backends.cuda.matmul.fp32_precision`` (``utils/precision.py``):
the caller's TF32 setting governs the caller's own products only. ``precision="fast"``
(the JAX package's ``sweep_precision=DEFAULT``) runs the γ-sweep alone in one TF32 pass,
on every primal route.

A pickle carries no device: a restored model serves on the device its ``device``
parameter names in the loading process (``"cuda"``: the current device), resolved at first
use, never on the index it was fitted on and never on the CPU by itself.
"""

from typing import TYPE_CHECKING, Any, Literal, NamedTuple

import numpy as np
import numpy.typing as npt
import torch
from torch.distributed.device_mesh import DeviceMesh

from neo_ls_svm_torch.models import routing
from neo_ls_svm_torch.models.conformal import ConformalMixin
from neo_ls_svm_torch.models.dual import dual_decision_function, dual_fit, dual_predict_var
from neo_ls_svm_torch.models.isotonic import IsotonicCalibrator
from neo_ls_svm_torch.models.primal import (
    _primal_working_set_bytes,
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
from neo_ls_svm_torch.ops.weighted_quantile import interp
from neo_ls_svm_torch.parallel.collectives import group_size
from neo_ls_svm_torch.parallel.mesh import (
    AXES,
    axis_size,
    make_mesh,
    mesh_device,
    sharded_primal_fit,
    sharded_primal_fit_device_pt,
    sharded_primal_fit_streaming,
)
from neo_ls_svm_torch.utils.base import BaseEstimator, clone, sklearn_tags
from neo_ls_svm_torch.utils.device import (
    is_tensor,
    numpy_dtype,
    padded,
    require_device,
    resolve_device,
    to_device as _to_device,
    torch_dtype,
)
from neo_ls_svm_torch.utils.metrics import accuracy_score, r2_score
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_torch.utils.profiling import span
from neo_ls_svm_torch.utils.transfer import upload_rows
from neo_ls_svm_torch.utils.validation import (
    _check_n_features,
    assert_all_finite,
    check_array,
    check_consistent_length,
    check_is_fitted,
    check_random_state,
    check_X_y,
    is_pandas,
    train_test_split,
)

if TYPE_CHECKING:  # pandas is an optional I/O convenience, never a runtime dependency.
    import pandas as pd

DUAL_THRESHOLD = 1024  # n ≤ 1024 → dual space (ref _neo_ls_svm.py:375).
STREAMING_BYTES_THRESHOLD = 6 * 1024**3  # In-memory working set above this → stream.
STREAMING_ROW_CHUNK = 32768
PREDICT_CHUNK_ROWS = 1 << 20  # Chunk predictions beyond this many rows (bounds the
# transient n×2M feature block on the device).
# The conformal calibration split, in the order ``train_test_split`` returns it: the level-1
# and level-2 part of the LOO std, the LOO ŷ, the LOO residuals and the sample weights.
_CONFORMAL_SPLIT_ATTRS = tuple(
    f"{stem}_calib_{level}_"
    for stem in ("nonconformity", "ŷ", "residuals", "sample_weight")
    for level in ("l1", "l2")
)
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
    "_calibration_ctx",
    "predict_proba_calibrator_",
    *_CONFORMAL_SPLIT_ATTRS,
    "conformal_l1_",
    "conformal_l2_",
)
# Fitted attributes made at first use from ``_calibration_ctx`` (see ``__getattr__``), and
# the method that makes each.
_LAZY_CALIBRATION = {
    "predict_proba_calibrator_": "_materialize_calibrator",
    **dict.fromkeys((*_CONFORMAL_SPLIT_ATTRS, "conformal_l1_", "conformal_l2_"), "_materialize_conformal_split"),
}


class _PrimalPlan(NamedTuple):
    """How a primal fit runs, resolved once while the fit is validated, from what it can
    observe: X's shape, type and dtype, the mesh and the options. The host's NaN/inf scan
    of X and the stage both follow it."""

    feature_map: KernelApproximatingFeatureMap  # an unfitted clone of the configured map
    num_features: int
    working_set_bytes: int
    route: str  # "mesh", "streaming" or "inmemory"
    row_pad: int  # zero-weight rows a streaming fit adds, to a chunk multiple
    keeps_tensor: bool  # a tensor X stays on the device; any other X is a host array
    use_device_pt: bool
    transfer: str
    # The device, not the host, checks X for NaN and inf: a NumPy X whose rows go whole to
    # one device for the device pre-transform at full width.
    finite_on_device: bool


def _complexity_embedding(
    fm: KernelApproximatingFeatureMap, dtype: np.dtype, n_rows: int, device: torch.device
) -> torch.Tensor | None:
    """The surface-complexity regulariser in the real embedding, normalised: None for the
    shipped identity; a custom feature map with a nontrivial matrix routes through the
    whitened-GEVD path (ref _neo_ls_svm.py:116-124)."""
    C = np.asarray(fm.complexity_matrix, dtype=dtype)
    if np.array_equiv(C, C[0, 0] * np.eye(C.shape[0], dtype=dtype)):
        return None
    C_n = C / (np.mean(np.abs(np.diag(C))) * (n_rows * C.shape[0]))
    zeros = np.zeros_like(C_n)
    return _to_device(np.block([[C_n, zeros], [zeros, C_n]]), device)


def _maybe_pandas_series(values: npt.NDArray, X_df: Any) -> Any:
    if is_pandas(X_df):
        try:
            import pandas as pd
        except ImportError:
            return values
        return pd.Series(values, index=X_df.index)
    return values


class NeoLSSVM(ConformalMixin, BaseEstimator):
    """Neo LS-SVM: a modern least-squares SVM with O(n) training and hyperparameter-free
    LOO tuning, running its linear algebra on an NVIDIA GPU through PyTorch and
    hand-written CUDA kernels.

    ``device`` names the torch device the solver runs on. It defaults to ``"cuda"``;
    ``fit`` raises when CUDA is unavailable unless ``device="cpu"`` was passed. A
    ``torch.Tensor`` input must lie on that device.

    ``mesh`` is None (one device), ``"auto"`` (a mesh over every rank when a process
    group of more than one rank is initialised, else None) or a
    ``torch.distributed.device_mesh.DeviceMesh`` with axes ("data", "feature")
    (``parallel.mesh.make_mesh``). A mesh fit runs on each rank's own device of the
    mesh's device type.
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
        return resolve_device(self.device)

    def _check_options(self) -> None:
        """Reject invalid option values (ValueError)."""
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

    def _resolve_mesh(self, device: torch.device) -> DeviceMesh | None:
        """``mesh_``: "auto" builds a mesh over every rank when a process group of more
        than one rank exists (the JAX package's "more than one visible device"), else
        None; a ("data", "feature") DeviceMesh passes through."""
        if self.mesh is None:
            return None
        if isinstance(self.mesh, str) and self.mesh == "auto":
            return make_mesh(device_type=device.type) if group_size(None) > 1 else None
        if isinstance(self.mesh, DeviceMesh) and self.mesh.mesh_dim_names == AXES:
            if self.mesh.device_type != device.type:
                msg = f"the mesh computes on {self.mesh.device_type!r} devices, but device={self.device!r}."
                raise ValueError(msg)
            return self.mesh
        msg = (
            "mesh must be None, 'auto', or a torch.distributed.device_mesh.DeviceMesh with "
            f"axes {AXES} (parallel.mesh.make_mesh), got {self.mesh!r}."
        )
        raise ValueError(msg)

    def _validate_fit_device_X(self, X: torch.Tensor, device: torch.device) -> torch.Tensor:
        """Metadata-only validation of a training X that is a tensor.

        Shape and dtype come from the tensor's metadata and the NaN/inf scan is skipped: a
        finiteness reduction would read the device, which this lane exists to avoid (the
        caller's pipeline owns its data hygiene). ``check_X_y``'s dtype policy: float32 and
        float64 pass through, everything else widens to float64.
        """
        if X.ndim != 2:
            msg = f"Expected 2D array, got {X.ndim}D tensor instead."
            raise ValueError(msg)
        if X.shape[0] < 2:
            msg = f"Found array with {X.shape[0]} sample(s) while a minimum of 2 is required."
            raise ValueError(msg)
        if X.shape[1] < 1:
            msg = (
                f"Found array with 0 feature(s) (shape={tuple(X.shape)}) while a minimum "
                "of 1 is required."
            )
            raise ValueError(msg)
        if X.is_complex():
            msg = "Complex data not supported."
            raise ValueError(msg)
        require_device(X, device, "X")
        if self.transfer not in ("auto", "float32"):
            msg = (
                f"transfer={self.transfer!r} narrows the host→device upload, but X is "
                "already a tensor on the device: there is no upload to narrow."
            )
            raise ValueError(msg)
        X = X.detach()
        return X if X.dtype in (torch.float32, torch.float64) else X.to(torch.float64)

    @matmul_precision("ieee")
    def fit(
        self,
        X: "npt.NDArray | torch.Tensor | pd.DataFrame",
        y: "npt.NDArray | torch.Tensor | pd.Series",
        sample_weight: "npt.NDArray | torch.Tensor | pd.Series | None" = None,
    ) -> "NeoLSSVM":
        """Fit this predictor.

        X may be a ``torch.Tensor`` on the model's device: it is then validated from its
        metadata only and never copied to the host on the primal route with the device
        pre-transform, which such a fit takes wherever it is eligible. The O(n) target and
        weights are pulled once, so the host-side task and label logic is unchanged.

        A NumPy X whose rows go whole to one device for the device pre-transform at full
        width crosses as the caller holds it: the device pads it and checks it for NaN and
        inf in one exact reduction (``neo.fit.finite``), and the host makes no pass over it.
        Every other route scans X on the host first. A fit that raises leaves the estimator
        as it found it.
        """
        unfitted = dict(self.__dict__)
        try:
            return self._fit(X, y, sample_weight)
        except BaseException:
            self.__dict__.clear()
            self.__dict__.update(unfitted)
            raise

    def _plan_primal(self, X: "npt.NDArray | torch.Tensor", itemsize: int) -> _PrimalPlan:
        """Resolve the primal route's plan for X (a validated host array or tensor)."""
        fm = clone(
            OrthogonalRandomFourierFeatures() if self.primal_feature_map == "auto" else self.primal_feature_map
        )
        n_rows, n_cols = X.shape
        num_features = int(getattr(fm, "num_features", 512))
        working_set_bytes = _primal_working_set_bytes(n_rows, num_features, itemsize)
        if self.mesh_ is not None:
            route = "mesh"
        else:
            route = "streaming" if working_set_bytes > STREAMING_BYTES_THRESHOLD else "inmemory"
        # The device pre-transform applies to a random-Fourier feature map whose
        # complexity matrix is the shipped identity (a subclass overriding
        # `complexity_matrix` needs the whitened-GEVD solver, which the host path feeds).
        eligible = (
            isinstance(fm, RandomFourierFeatures)
            and type(fm).complexity_matrix is RandomFourierFeatures.complexity_matrix
        )
        # A tensor X takes the device pre-transform wherever it is eligible and the caller
        # did not ask for the host's (which would cost the pull this lane avoids).
        keeps_tensor = is_tensor(X) and eligible and self.pre_transform != "host"
        pre_transform, transfer = routing._resolve_fit_plan(
            "device" if keeps_tensor else self.pre_transform,
            self.transfer,
            payload_bytes=n_rows * n_cols * itemsize,
            device_pt_eligible=eligible,
        )
        use_device_pt = pre_transform == "device" and eligible
        return _PrimalPlan(
            feature_map=fm,
            num_features=num_features,
            working_set_bytes=working_set_bytes,
            route=route,
            row_pad=(-n_rows) % STREAMING_ROW_CHUNK if route == "streaming" else 0,
            keeps_tensor=keeps_tensor,
            use_device_pt=use_device_pt,
            transfer=transfer,
            # Every other route reads X on the host (the dual route's and the host
            # pre-transform's feature maps, a mesh's per-rank staging) or casts it there
            # (transfer="bfloat16" or "int8" can turn a finite value into inf, or a NaN into
            # an integer), so the host scans X first.
            finite_on_device=not is_tensor(X) and route != "mesh" and use_device_pt and transfer == "float32",
        )

    def _fit(
        self,
        X: "npt.NDArray | torch.Tensor | pd.DataFrame",
        y: "npt.NDArray | torch.Tensor | pd.Series",
        sample_weight: "npt.NDArray | torch.Tensor | pd.Series | None",
    ) -> "NeoLSSVM":
        with span("neo.fit"):
            with span("neo.fit.validate") as checked:
                device = self._resolve_device()
                self._check_options()
                self.mesh_ = self._resolve_mesh(device)
                if self.mesh_ is not None:
                    device = mesh_device(self.mesh_)  # this rank's own GPU
                # The one pull of y and the weights, whichever of them are tensors.
                y, sample_weight = (
                    v.detach().cpu().numpy() if is_tensor(v) else v for v in (y, sample_weight)
                )
                X_on_device = is_tensor(X)
                if X_on_device:
                    X = self._validate_fit_device_X(X, device)
                    x_dtype = numpy_dtype(X.dtype)
                    y = np.ravel(np.asarray(y))
                    check_consistent_length(X, y)
                    # y is on the host here, so check_X_y's finiteness gate costs no device read;
                    # only the O(n·d) scan of X is skipped (a NaN in y would fit an all-NaN model).
                    if np.issubdtype(y.dtype, np.floating) and not np.all(np.isfinite(y)):
                        msg = "Input y contains NaN or infinity."
                        raise ValueError(msg)
                else:
                    X, y = check_X_y(
                        X, y, dtype=(np.float64, np.float32), ensure_min_samples=2, ensure_all_finite=False
                    )
                    x_dtype = X.dtype
                    y = np.ravel(np.asarray(y))
                dual = bool(X.shape[0] <= DUAL_THRESHOLD if self.dual == "auto" else self.dual)
                plan = None if dual else self._plan_primal(X, np.dtype(x_dtype).itemsize)
                host_scan = not X_on_device and not (plan is not None and plan.finite_on_device)
                if host_scan:
                    assert_all_finite(X)
                checked["host_scanned_bytes"] = X.nbytes if host_scan else 0
                sample_weight_ = (
                    np.ones(y.shape, x_dtype)
                    if sample_weight is None
                    else np.ravel(np.asarray(sample_weight)).astype(x_dtype)
                )
                check_consistent_length(y, sample_weight_)
                if np.sum(sample_weight_) <= 0:
                    msg = "The sample weights are all zero; at least one weight must be positive."
                    raise ValueError(msg)
            with span("neo.fit.target"):
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
                    y_ = np.ones(y.shape, dtype=x_dtype)
                    y_[y == self.classes_[0]] = -1
                elif self._estimator_type == "regressor":
                    y_ = y.astype(x_dtype)
                else:
                    msg = "Target type not supported"
                    raise ValueError(msg)
                is_classifier = self._estimator_type == "classifier"
            # Primal vs dual routing (ref :375).
            self.dual_ = dual
            self.primal_ = not self.dual_
            if X_on_device and (plan is None or not plan.keeps_tensor):
                # These routes run the host pre-transform (the dual solver's feature map, the
                # bit-parity pre-transform the caller asked for, or a custom feature map's),
                # which needs X on the host: one explicit pull, small for the dual route
                # (n ≤ 1024) and the stated cost of turning the device route down.
                X = X.cpu().numpy()
            if self.dual_:
                nz = sample_weight_ > 0
                X, y_, sample_weight_ = X[nz], y_[nz], sample_weight_[nz]
                result = self._fit_dual(X, y_, sample_weight_, is_classifier=is_classifier, device=device)
            else:
                result = self._fit_primal(X, y_, sample_weight_, plan, is_classifier=is_classifier, device=device)
            with span("neo.fit.pull", device=device) as pulled:
                fitted = {k: v.cpu().numpy() for k, v in result.items()}
                pulled["bytes"] = sum(a.nbytes for a in fitted.values())
            self._set_fit_attributes(fitted)
            # The calibrator and the conformal split are made from this at first use.
            self._calibration_ctx = {
                "y_": y_,
                "sample_weight": sample_weight_,
                "is_classifier": is_classifier,
                "num_rows": len(y_),
                "made": {},  # what is made at first use: the fit's __dict__ stays as it is
            }
        return self

    def _fit_primal(
        self,
        X: "npt.NDArray | torch.Tensor",
        y_: npt.NDArray,
        sample_weight_: npt.NDArray,
        plan: _PrimalPlan,
        *,
        is_classifier: bool,
        device: torch.device,
    ) -> dict[str, torch.Tensor]:
        """The primal route (n > 1024): fit on ``device`` as ``plan`` says. X is a host
        array, or a validated tensor on ``device`` where ``plan.keeps_tensor``. Where
        ``plan.finite_on_device``, the host did not scan X for NaN and inf: the device
        checks it right after the upload."""
        with span("neo.fit.stage"):
            self.primal_feature_map_ = fm = plan.feature_map
            n_rows = X.shape[0]
            dtype = y_.dtype  # X's dtype, as a NumPy dtype whether X is an array or a tensor
            num_features = plan.num_features
            route = plan.route
            use_device_pt = plan.use_device_pt
            # pre_transform_ records the route actually taken: an explicit
            # pre_transform="device" on an ineligible fit falls to the host path.
            self.pre_transform_ = "device" if use_device_pt else "host"
            self.transfer_ = plan.transfer
            if self.transfer_ != "float32" and route == "mesh":
                msg = (
                    f"transfer={self.transfer!r} is not supported on the mesh route: "
                    "sharded fits stage rows at full precision."
                )
                raise ValueError(msg)
            if self.transfer_ != "float32" and not use_device_pt:
                msg = (
                    f"transfer={self.transfer!r} only applies when the fit takes the "
                    "on-device pre-transform route (primal, random-Fourier feature map "
                    "with the identity complexity matrix); this fit would route "
                    f"through {route!r} with the host pre-transform, silently "
                    "ignoring the narrow upload you opted into."
                )
                raise ValueError(msg)
            self.γs_ = gamma_grid(dtype, num=1024)
            if route != "mesh":  # a mesh stages its rows on each rank (_fit_mesh)
                g_d = _to_device(self.γs_, device)
                # Streaming: zero-weight padding rows to a chunk multiple, added before the
                # pre-transform so that their weight excludes them everywhere; num_samples keeps
                # the true n. They are written on the device (here and in upload_rows): the
                # host makes no padded copy.
                row_pad = plan.row_pad
                y_d = _to_device(y_, device, pad=row_pad)
                s_d = _to_device(sample_weight_, device, pad=row_pad)
                if is_tensor(X):  # X never visits the host
                    X_d = padded(X, row_pad, device).contiguous()
                else:
                    # Zero-weight rows must not shape the int8 grid: an absurd-valued one would
                    # stretch it and quantise the real data to zero.
                    grid_rows = X[sample_weight_ > 0] if self.transfer_ == "int8" else None
        if route == "mesh":
            return self._fit_mesh(
                X,
                y_,
                sample_weight_,
                is_classifier=is_classifier,
                device=device,
                use_device_pt=use_device_pt,
                stream=plan.working_set_bytes / axis_size(self.mesh_, "data") > STREAMING_BYTES_THRESHOLD,
            )
        if not is_tensor(X):
            X_d = upload_rows(X, self.transfer_, device, grid_rows=grid_rows, pad_rows=row_pad)
        if plan.finite_on_device:  # the host's scan, as one exact reduction on the device
            with span("neo.fit.finite", device=device) as scanned:
                rows = X_d[:n_rows]
                scanned["bytes"] = rows.numel() * rows.element_size()
                # Min and max carry any NaN, and an infinity is an extreme: both are finite
                # exactly when every value is, and no n × d temporary is made.
                if not bool(torch.isfinite(torch.stack(torch.aminmax(rows))).all()):
                    msg = "Input contains NaN or infinity."
                    raise ValueError(msg)
        C_emb = None
        pt: dict[str, torch.Tensor] = {}
        if use_device_pt:
            generator, settings = self._device_pt_settings(fm, is_classifier, device)
            pt = device_pre_transform(
                X_d, y_d, s_d, generator, num_features=num_features, is_classifier=is_classifier, **settings
            )
            M_d, b_d = pt.pop("M"), pt.pop("b")
        else:
            fm.fit(X, y_, sample_weight_)
            M_map, b_map = fm.linear_map()
            M_d, b_d = _to_device(M_map.astype(dtype), device), _to_device(b_map.astype(dtype), device)
            C_emb = _complexity_embedding(fm, dtype, n_rows, device)
        # precision="fast" reaches the γ-sweep alone, as JAX's sweep_precision=DEFAULT.
        kw = {
            "is_classifier": is_classifier,
            "num_samples": n_rows,
            "sweep_precision": self.precision,
            "working_set_bytes": plan.working_set_bytes,
        }
        if route == "streaming":
            result = primal_fit_streaming(
                X_d, M_d, b_d, y_d, s_d, g_d, C_emb, row_chunk=STREAMING_ROW_CHUNK, **kw
            )
            result = trim_per_row(result, n_rows)
        else:
            result = primal_fit(X_d, M_d, b_d, y_d, s_d, g_d, C_emb, **kw)
        return {**self._keep_primal_state(result, M_d, b_d, C_emb, n_rows, num_features), **pt}

    def _keep_primal_state(
        self,
        result: dict[str, torch.Tensor],
        M_d: torch.Tensor,
        b_d: torch.Tensor,
        C_emb: torch.Tensor | None,
        n_rows: int,
        num_features: int,
    ) -> dict[str, torch.Tensor]:
        """Keep the serving tensors of a primal fit on its device; the result with them."""
        # The GEVD (custom-C) eigenbasis is C-orthonormal: resolvent scale is 1.
        self._inv_c0 = 1.0 if C_emb is not None else float(n_rows * (num_features + 1))
        self._device_cache = {
            "beta_emb": result["beta_emb"],
            # Row-major, as a restored model uploads it: eigh's column-major Qs would take
            # another BLAS path in serving and round the variance otherwise.
            "Qs": result["Qs"].contiguous(),
            "lam": result["lam"],
            "M_map": M_d,
            "b_map": b_d,
        }
        return {**result, "M_map": M_d, "b_map": b_d}

    def _fit_mesh(
        self,
        X: "npt.NDArray | torch.Tensor",
        y_: npt.NDArray,
        sample_weight_: npt.NDArray,
        *,
        is_classifier: bool,
        device: torch.device,
        use_device_pt: bool,
        stream: bool,
    ) -> dict[str, torch.Tensor]:
        """The mesh route: every rank passes all rows, the solver shards them over the
        mesh's ``data`` axis, streaming each rank's rows when its share of the working set
        is above the threshold, and every rank keeps the whole result on ``device``."""
        fm = self.primal_feature_map_
        n_rows = X.shape[0]
        num_features = int(getattr(fm, "num_features", 512))
        dtype = y_.dtype
        if use_device_pt:
            # The generator is drawn from on the first rank only.
            generator, settings = self._device_pt_settings(fm, is_classifier, device)
            result = sharded_primal_fit_device_pt(
                self.mesh_,
                X,
                y_,
                sample_weight_,
                generator,
                self.γs_,
                is_classifier=is_classifier,
                num_features=num_features,
                stream=stream,
                row_chunk=STREAMING_ROW_CHUNK,
                sweep_precision=self.precision,
                **settings,
            )
            return self._keep_primal_state(result, result["pt_M"], result["pt_b"], None, n_rows, num_features)
        # Every rank runs the host pre-transform: NumPy, the same bits on each.
        fm.fit(X, y_, sample_weight_)
        M_map, b_map = fm.linear_map()
        M_d, b_d = _to_device(M_map.astype(dtype), device), _to_device(b_map.astype(dtype), device)
        C_emb = _complexity_embedding(fm, dtype, n_rows, device)
        sharded_fit = sharded_primal_fit_streaming if stream else sharded_primal_fit
        result = sharded_fit(
            self.mesh_,
            X,
            M_d,
            b_d,
            y_,
            sample_weight_,
            self.γs_,
            C_emb,
            is_classifier=is_classifier,
            sweep_precision=self.precision,
        )
        return self._keep_primal_state(result, M_d, b_d, C_emb, n_rows, num_features)

    def _device_pt_settings(
        self, fm: RandomFourierFeatures, is_classifier: bool, device: torch.device
    ) -> tuple[torch.Generator, dict[str, Any]]:
        """The device pre-transform's generator on ``device``, seeded from
        ``random_state``, and its settings for the feature map ``fm``: the same for one
        device and for a mesh."""
        rs = self.random_state
        seed = int(rs) if isinstance(rs, (int, np.integer)) else int(check_random_state(rs).randint(0, 2**31 - 1))
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        affine = fm.affine_feature_map
        return generator, {
            "num_bins": 2 if is_classifier else DEVICE_PRETRANSFORM_BINS,
            "edge_sample_size": int(getattr(affine, "edge_sample_size", 384)),
            "edge_search_multiplier": int(getattr(affine, "edge_search_multiplier", 4)),
            "rank_threshold": float(getattr(affine, "rank_threshold", 2e-2)),
            # A plain RandomFourierFeatures map keeps its configured i.i.d. Gaussian draw;
            # only the orthogonal variant gets the blockwise QR + χ rescale.
            "orthogonal": isinstance(fm, OrthogonalRandomFourierFeatures),
        }

    def _fit_dual(
        self,
        X: npt.NDArray,
        y_: npt.NDArray,
        sample_weight_: npt.NDArray,
        *,
        is_classifier: bool,
        device: torch.device,
    ) -> dict[str, torch.Tensor]:
        """The dual route (n ≤ 1024, or ``dual=True``), on rows of positive weight: the host
        pre-transform, then the kernel system on ``device``."""
        if self.transfer not in ("auto", "float32"):
            msg = (
                f"transfer={self.transfer!r} only applies to the on-device "
                f"pre-transform route; this fit (n={X.shape[0]} ≤ {DUAL_THRESHOLD}) "
                "routes to the dual solver with the host pre-transform."
            )
            raise ValueError(msg)
        self.pre_transform_, self.transfer_ = "host", "float32"
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

    # ------------------------------------------- calibration state, made at first use

    def _materialize_calibrator(self) -> None:
        """Isotonic probability calibration on the LOO predictions (ref ``:406-412``): at
        a million rows a lexsort, a ``unique`` and the PAV loop, so it waits for the first
        ``predict_proba``."""
        ctx = self.__dict__.get("_calibration_ctx")
        if ctx is None or not ctx["is_classifier"] or "predict_proba_calibrator_" in ctx["made"]:
            return
        calibrator = IsotonicCalibrator(out_of_bounds="clip", y_min=0, y_max=1, increasing=True)
        y_ = ctx["y_"]
        target = np.zeros_like(y_)
        target[y_ == np.max(y_)] = 1.0
        calibrator.fit(self.loo_ŷ_, target, ctx["sample_weight"])
        ctx["made"]["predict_proba_calibrator_"] = calibrator

    def _materialize_conformal_split(self) -> None:
        """The two-level conformal calibration split (ref ``:414-430``): a permutation of
        all rows, so it waits for the first conformal call."""
        ctx = self.__dict__.get("_calibration_ctx")
        if ctx is None or "conformal_l1_" in ctx["made"]:
            return
        num_rows = ctx["num_rows"]
        split = train_test_split(
            self.loo_std_,
            self.loo_ŷ_,
            self.loo_residuals_,
            ctx["sample_weight"],
            train_size=min(1440, max(1024, (num_rows * 2) // 3), num_rows - 1),
            random_state=self.random_state,
        )
        made = dict(zip(_CONFORMAL_SPLIT_ATTRS, split))
        made["conformal_l2_"] = {"Δŷ": {}, "Δŷ/ŷ": {}}  # per target: quantiles → level-2 biases
        made["conformal_l1_"] = {"Δŷ": {}, "Δŷ/ŷ": {}}  # per target: quantiles → level-1 CQR
        ctx["made"].update(made)

    def _fitted_state(self) -> dict[str, Any]:
        """``vars(self)`` with the calibration state made at first use so far."""
        ctx = self.__dict__.get("_calibration_ctx")
        return {**self.__dict__, **(ctx["made"] if ctx is not None else {})}

    def __getattr__(self, name: str) -> Any:
        # Normal lookup failed. A restored model's device is resolved from the device
        # parameter at its first use, in this process (it raises where that device is
        # missing: nothing moves to the CPU by itself).
        if name == "device_" and "γ_" in self.__dict__:
            self.device_ = self._resolve_device()
            return self.device_
        # A calibration attribute of the last fit is made at its first use and kept beside
        # the fit's inputs: a serving call leaves the fit's __dict__ as it is (sklearn's
        # check_dict_unchanged), and a refit drops both.
        maker = _LAZY_CALIBRATION.get(name)
        ctx = self.__dict__.get("_calibration_ctx")
        if maker is not None and ctx is not None:
            getattr(self, maker)()
            if name in ctx["made"]:
                return ctx["made"][name]
        msg = f"{type(self).__name__!r} object has no attribute {name!r}"
        raise AttributeError(msg)

    def __getstate__(self) -> dict[str, Any]:
        """The pickled state: everything a fit left, with the calibration state made first
        and without the device handles (the host attributes carry the same state) or the
        device they lie on: the loading process resolves its own (``__getattr__``)."""
        self._materialize_calibrator()
        self._materialize_conformal_split()
        state = self._fitted_state()
        state.pop("_device_cache", None)
        state.pop("device_", None)
        state.pop("_calibration_ctx", None)
        # A mesh is a resource of the process group: the model restores on one device.
        state.pop("mesh_", None)
        state["mesh"] = None
        return state

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

    def _validated(self, X: Any) -> "npt.NDArray | torch.Tensor":
        """X ready for serving: a tensor on the model's device in the compute dtype,
        validated from its metadata only (no NaN/inf scan: a reduction pulled to the host
        would cost the round trip the tensor lane exists to avoid; serving pipelines own
        their data hygiene), or a host array under the full sklearn validation contract."""
        check_is_fitted(self, ["γ_"])
        if not is_tensor(X):
            return _check_n_features(self, check_array(X, dtype=(np.float64, np.float32)))
        if X.ndim != 2:
            msg = f"Expected 2D array, got {X.ndim}D tensor instead."
            raise ValueError(msg)
        _check_n_features(self, X)
        require_device(X, self.device_, "X")
        return X.detach().to(torch_dtype(self._compute_dtype()))

    def _in_chunks(self, X: "npt.NDArray | torch.Tensor", fn: Any, *, device_out: bool) -> Any:
        """Apply a device function over row chunks of X. A host array crosses to the
        device chunk by chunk, at the width the model was fitted with (``transfer_``); a
        tensor is sliced where it lies. With ``device_out`` the result stays a tensor on
        the device, else it is pulled once."""
        host_in = not is_tensor(X)
        if host_in:
            # copy=False: no O(n·d) host duplicate when the dtype already matches.
            X = X.astype(self._compute_dtype(), copy=False)
        parts = []
        for start in range(0, max(X.shape[0], 1), PREDICT_CHUNK_ROWS):
            X_c = X[start : start + PREDICT_CHUNK_ROWS]
            parts.append(fn(upload_rows(X_c, self.transfer_, self.device_) if host_in else X_c))
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out if device_out else out.cpu().numpy()

    def _device_dual_transform(self, X: torch.Tensor) -> torch.Tensor:
        """The dual feature map's affine form applied on the device (no host transform)."""
        cache = self.__dict__.setdefault("_device_cache", {})
        if "dual_map" not in cache:
            # linear_form returns (M, offset, inv_scale) for a map with a matrix A, and
            # (None, shift, inv_scale) for a pure shift and scale.
            M, offset, inv_scale = self.dual_feature_map_.linear_form(self.n_features_in_)
            dtype = self.X_.dtype
            row = np.asarray(offset, dtype).reshape(1, -1)
            if M is None:
                scale_row = np.broadcast_to(np.asarray(inv_scale, dtype), offset.shape).reshape(1, -1)
                cache["dual_map"] = (None, _to_device(row, self.device_), _to_device(scale_row, self.device_))
            else:
                cache["dual_map"] = (_to_device(M.astype(dtype), self.device_), _to_device(row, self.device_), None)
        M_d, off_d, inv_scale_d = cache["dual_map"]
        if M_d is None:
            return (X - off_d) * inv_scale_d
        return X @ M_d + off_d

    @matmul_precision("ieee")
    def _serve(self, X: "npt.NDArray | torch.Tensor", primal_fn: Any, dual_fn: Any, *, device_out: bool) -> Any:
        """Run the model's serving function over a validated X: ``primal_fn`` on chunks of
        X, or ``dual_fn`` on chunks of the dual feature map's transform of X (on the host
        for a host array, where that map was fitted; on the device for a tensor). The one
        route choice of every serving entry, so the host and tensor lanes cannot part; its
        products are IEEE float32 whatever the caller set."""
        if self.primal_:
            return self._in_chunks(X, primal_fn, device_out=device_out)
        if is_tensor(X):
            return self._in_chunks(
                X, lambda X_c: dual_fn(self._device_dual_transform(X_c)), device_out=device_out
            )
        return self._in_chunks(self.dual_feature_map_.transform(X), dual_fn, device_out=device_out)

    def _decision(self, X_v: "npt.NDArray | torch.Tensor") -> "npt.NDArray | torch.Tensor":
        """ŷ for a validated X: a tensor for a tensor, an array for an array."""
        return self._serve(
            X_v,
            lambda X_c: primal_decision_function(
                X_c, self._device("M_map"), self._device("b_map"), self._device("beta_emb")
            ),
            lambda X_c: dual_decision_function(X_c, self._device("X_train"), self._device("alpha")),
            device_out=is_tensor(X_v),
        )

    def decision_function(
        self, X: "npt.NDArray | torch.Tensor | pd.DataFrame"
    ) -> "npt.NDArray | torch.Tensor | pd.Series":
        """Evaluate the prediction function ŷ(x) (ref ``:655-681``). A tensor on the
        model's device comes back as a tensor on that device, with no host copy."""
        yhat = self._decision(self._validated(X))
        return yhat if is_tensor(yhat) else _maybe_pandas_series(yhat, X)

    def predict_std(
        self, X: "npt.NDArray | torch.Tensor | pd.DataFrame"
    ) -> "npt.NDArray | torch.Tensor | pd.Series":
        """Bayesian estimate of the predictive standard deviation (ref ``:452-487``).

        Uncalibrated; its value is as a nonconformity score for the conformal stack. A
        tensor on the model's device comes back as a tensor on that device.
        """
        X_v = self._validated(X)
        var = self._serve(
            X_v,
            lambda X_c: primal_predict_var(
                X_c,
                self._device("M_map"),
                self._device("b_map"),
                self._device("Qs"),
                self._device("lam"),
                self._device("gamma"),
                self._device("inv_c0"),
            ),
            lambda X_c: dual_predict_var(X_c, self._device("X_train"), self._device("chol")),
            device_out=is_tensor(X_v),
        )
        if is_tensor(var):
            return torch.sqrt(torch.clamp(var, min=0.0))
        return _maybe_pandas_series(np.sqrt(np.maximum(var, 0.0)), X)

    # ------------------------------------------------------------------- prediction

    def predict(
        self,
        X: "npt.NDArray | torch.Tensor | pd.DataFrame",
        *,
        coverage: float | None = None,
        quantiles: npt.ArrayLike | None = None,
    ) -> "npt.NDArray | torch.Tensor | pd.Series | pd.DataFrame":
        """Predict on a given dataset: labels (classifier) or values (regressor), an
        interval under ``coverage=``, or quantiles under ``quantiles=``.

        A tensor on the model's device gives a regressor with a floating target a tensor
        of point predictions on that device. Class labels and other target dtypes are
        mapped on the host from the pulled ŷ and come back as NumPy.
        """
        if coverage is not None and quantiles is not None:
            msg = "Pass coverage or quantiles, not both."
            raise ValueError(msg)
        if coverage is not None:
            return self.predict_interval(X, coverage=coverage)
        if quantiles is not None:
            return self.predict_quantiles(X, quantiles=quantiles)
        yhat_df = self._decision(self._validated(X))
        if is_tensor(yhat_df):
            if self._estimator_type == "regressor" and np.issubdtype(self.y_dtype_, np.floating):
                return yhat_df.to(torch_dtype(self.y_dtype_))
            yhat_df = yhat_df.cpu().numpy()
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

    def predict_proba(
        self, X: "npt.NDArray | torch.Tensor | pd.DataFrame"
    ) -> "npt.NDArray | torch.Tensor | pd.Series | pd.DataFrame":
        """Predict class probabilities (classifier) or point predictions (regressor).

        A tensor on the model's device stays there: a classifier returns the (n, 2)
        calibrated probabilities as a tensor (the isotonic calibration is an ``interp`` on
        the device against the float64 thresholds), a regressor its point predictions.
        """
        yhat_df = self._decision(self._validated(X))
        is_classifier = self._estimator_type == "classifier"
        if is_tensor(yhat_df):
            if not is_classifier:
                return yhat_df
            proba_pos = interp(yhat_df.to(torch.float64), *self._iso_thresholds_device())
            return torch.stack([1 - proba_pos, proba_pos], dim=1).to(yhat_df.dtype)
        if is_classifier:
            proba_pos = self.predict_proba_calibrator_.transform(yhat_df)
            proba = np.hstack([1 - proba_pos[:, np.newaxis], proba_pos[:, np.newaxis]])
        else:
            proba = yhat_df
            if not np.issubdtype(self.y_dtype_, np.integer):
                proba = yhat_df.astype(self.y_dtype_)
        if is_pandas(X):
            try:
                import pandas as pd
            except ImportError:
                return proba
            if is_classifier:
                return pd.DataFrame(proba, index=X.index, columns=self.classes_)
            return pd.Series(proba, index=X.index)
        return proba

    def score(
        self,
        X: "npt.NDArray | pd.DataFrame",
        y: "npt.NDArray | pd.Series",
        sample_weight: npt.NDArray | None = None,
    ) -> float:
        """Accuracy (classifier) or R² (regressor) on the given data."""
        yhat, y = (v.detach().cpu().numpy() if is_tensor(v) else v for v in (self.predict(X), y))
        if self._estimator_type == "classifier":
            return accuracy_score(np.asarray(y), np.asarray(yhat), sample_weight=sample_weight)
        return r2_score(
            np.asarray(y).astype(np.float64),
            np.asarray(yhat).astype(np.float64),
            sample_weight=sample_weight,
        )

    # ---------------------------------------------------------------- persistence

    def to_state_dict(self) -> dict[str, Any]:
        """The fitted model as a nested dict of plain arrays and scalars, in the layout of
        the JAX package's state dicts. ``NeoLSSVM.from_state_dict`` restores a model whose
        predictions are bit-identical. Plain pickling also works."""
        from neo_ls_svm_torch.utils.serialization import model_to_state_dict  # noqa: PLC0415

        check_is_fitted(self, ["γ_"])
        return model_to_state_dict(self)

    @classmethod
    def from_state_dict(cls, state: dict[str, Any], device: "str | torch.device" = "cuda") -> "NeoLSSVM":
        """Rebuild a fitted model on ``device`` from :meth:`to_state_dict` output."""
        from neo_ls_svm_torch.utils.serialization import model_from_state_dict  # noqa: PLC0415

        return model_from_state_dict(state, device=device)

    def _more_tags(self) -> dict[str, Any]:
        return {"binary_only": True, "requires_y": True}

    def __sklearn_tags__(self):  # noqa: ANN204 - sklearn protocol
        """A binary-only classifier or a regressor, by the fitted task, else by
        ``estimator_type``; y is required."""
        kind = None if self.estimator_type == "auto" else self.estimator_type
        kind = getattr(self, "_estimator_type", None) or kind
        return sklearn_tags(kind, target_required=True, multi_class=False)
