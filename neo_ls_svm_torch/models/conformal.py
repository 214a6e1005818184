"""Conformal prediction stack: two-level CQR calibration + quantile/interval serving.

Everything the reference's conformal path does (``_neo_ls_svm.py:489-532`` level fitting,
``:554-624`` quantile combination, ``:636-645`` intervals) lives here as a mixin the
estimator inherits. The level-1/level-2 fits are tiny host-side problems (HiGHS LPs, or
the batched smooth Newton on the model's device); serving has a host lane (NumPy or pandas
in, one upload per chunk, one pull, NumPy or pandas out) and a tensor lane
(``torch.Tensor`` on the model's device in, tensor out, no host copy after the one-time
upload of the planes and thresholds). Both lanes run the same tensor programs
(:func:`_conformal_quantiles`, :func:`_isotonic_proba`), so they cannot part.

PyTorch port of ``neo_ls_svm_tpu.models.conformal``.
"""

from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Literal

import numpy as np
import numpy.typing as npt
import torch

from neo_ls_svm_torch.models.cqr import (
    CoherentLinearQuantileRegressor,
    coherent_linear_quantile_regression_batched,
)
from neo_ls_svm_torch.models.dual import dual_decision_var
from neo_ls_svm_torch.models.primal import primal_decision_var
from neo_ls_svm_torch.ops.weighted_quantile import interp
from neo_ls_svm_torch.utils.device import is_tensor, to_device
from neo_ls_svm_torch.utils.precision import matmul_precision
from neo_ls_svm_torch.utils.validation import check_is_fitted, is_pandas

if TYPE_CHECKING:  # pandas is an optional I/O convenience, never a runtime dependency.
    import pandas as pd

CONFORMAL_L2_MIN = 128  # Level-2 bias needs ≥ 128 samples (ref :514).


def _coverage_clamped_biases(
    bias_abs: npt.NDArray,
    bias_rel: npt.NDArray,
    quantiles: npt.NDArray,
    priority: str,
) -> tuple[npt.NDArray, npt.NDArray]:
    """Copies of the level-2 biases, clamped outward when coverage has priority.

    ``priority="coverage"`` only allows outward quantile expansion (upper quantiles
    may shift up, lower down — ref ``_neo_ls_svm.py:571-577``).
    """
    bias_abs, bias_rel = bias_abs.copy(), bias_rel.copy()
    if priority == "coverage":
        quantiles = np.asarray(quantiles)
        upper, lower = 0.5 <= quantiles, quantiles <= 0.5
        bias_abs[upper] = np.maximum(bias_abs[upper], 0)
        bias_abs[lower] = np.minimum(bias_abs[lower], 0)
        bias_rel[upper] = np.maximum(bias_rel[upper], 0)
        bias_rel[lower] = np.minimum(bias_rel[lower], 0)
    return bias_abs, bias_rel


@matmul_precision("ieee")
def _conformal_quantiles(
    yhat: torch.Tensor,  # (n,) decision-function values
    std: torch.Tensor,  # (n,) Bayesian predictive std (the nonconformity score)
    beta_abs: torch.Tensor,  # (F+1, Q) level-1 CQR coefficients, absolute target
    bias_abs: torch.Tensor,  # (Q,) level-2 bias (coverage-clamped by the caller)
    beta_rel: torch.Tensor,  # (F+1, Q) level-1 CQR coefficients, relative target
    bias_rel: torch.Tensor,  # (Q,)
    *,
    is_regressor: bool,
) -> torch.Tensor:
    """The conformal combine (ref ``_neo_ls_svm.py:554-624``): two tiny products against
    the fitted CQR planes, the per-row min-dispersion choice between absolute and
    relative corrections, and the recentre on ŷ. Returns (n, Q). The products are IEEE
    float32 whatever the caller set, as the serving entries' are."""
    abs_yhat = torch.abs(yhat)
    feats = torch.stack([std, abs_yhat], dim=1) if is_regressor else std[:, None]
    pred_abs = feats @ beta_abs[:-1] + (beta_abs[-1] + bias_abs)[None, :]
    pred_rel = feats @ beta_rel[:-1] + (beta_rel[-1] + bias_rel)[None, :]
    delta = torch.stack([pred_abs, abs_yhat[:, None] * pred_rel], dim=2)  # (n, Q, 2)
    # The population std over the quantiles, as np.std.
    dispersion = torch.std(delta, dim=1, unbiased=False)  # (n, 2)
    # A tie goes to "absolute", as np.argmin's first minimum does.
    pick_relative = dispersion[:, 1] < dispersion[:, 0]
    return yhat[:, None] + torch.where(pick_relative[:, None], delta[:, :, 1], delta[:, :, 0])


def _isotonic_proba(
    yhat_quantiles: torch.Tensor,  # (n, Q)
    x_thresholds: torch.Tensor,
    y_thresholds: torch.Tensor,
) -> torch.Tensor:
    """Per-quantile isotonic calibration and class stacking. :func:`interp` clamps to the
    end values, which is the host calibrator's ``out_of_bounds="clip"`` with thresholds in
    [0, 1]. Returns (n, Q, 2)."""
    proba = interp(yhat_quantiles.reshape(-1), x_thresholds, y_thresholds).reshape(yhat_quantiles.shape)
    return torch.stack([1 - torch.flip(proba, dims=(1,)), proba], dim=2)


class ConformalMixin:
    """Conformal calibration + quantile/interval prediction for ``NeoLSSVM``.

    Consumes the estimator's fitted calibration attributes (``ŷ_calib_*_``,
    ``nonconformity_calib_*_``, ``residuals_calib_*_``, ``sample_weight_calib_l1_``)
    and its serving primitives (``_validated``, ``_serve``, ``_device``); provides
    ``predict_quantiles`` / ``predict_interval``.
    """

    def _primal_decision_var_device(self, X_c: torch.Tensor) -> torch.Tensor:
        """ŷ and σ² for one chunk, stacked (n, 2): the conformal paths need both, and
        ``primal_decision_var`` builds the O(n·2M·d) feature block once for the two."""
        return primal_decision_var(
            X_c,
            self._device("M_map"),
            self._device("b_map"),
            self._device("beta_emb"),
            self._device("Qs"),
            self._device("lam"),
            self._device("gamma"),
            self._device("inv_c0"),
        )

    def _dual_decision_var_device(self, X_c: torch.Tensor) -> torch.Tensor:
        """ŷ and σ² for one (dual-transformed) chunk, stacked (n, 2), sharing the
        n×n_train RBF block."""
        return dual_decision_var(
            X_c, self._device("X_train"), self._device("alpha"), self._device("chol")
        )

    def _decision_var_in_chunks(self, X: Any, *, device_out: bool) -> Any:
        """Fused ŷ and σ² stacked (n, 2) over row chunks of a validated X (a tensor on the
        model's device, or a host array that crosses once per chunk)."""
        return self._serve(
            X,
            self._primal_decision_var_device,
            self._dual_decision_var_device,
            device_out=device_out,
        )

    def _conformal_design(self, target_type: str, level: str = "l1") -> tuple:
        """The (X, y) design of one conformal level for one target type
        (ref ``_neo_ls_svm.py:497-510``): nonconformity score (+ |ŷ| for regressors)
        against the negated (possibly ŷ-relative) calibration residuals."""
        yhat = getattr(self, f"ŷ_calib_{level}_")
        eps = np.finfo(self.ŷ_calib_l1_.dtype).eps
        abs_yhat = np.maximum(np.abs(yhat), eps)
        X = getattr(self, f"nonconformity_calib_{level}_")[:, np.newaxis]
        if self._estimator_type == "regressor":
            X = np.hstack([X, np.abs(yhat[:, np.newaxis])])
        relative = "/ŷ" in target_type
        y = -getattr(self, f"residuals_calib_{level}_") / (abs_yhat if relative else 1)
        return X, y

    def _conformal_level2_bias(
        self,
        cqr_l1: CoherentLinearQuantileRegressor,
        target_type: str,
        quantiles: npt.NDArray,
        X_l1: npt.NDArray,
        y_l1: npt.NDArray,
    ) -> npt.NDArray:
        """Level 2: per-quantile bias on top of the level-1 quantile predictions,
        clipped so coherence survives (ref ``:511-531``)."""
        bias_l2 = np.zeros(quantiles.shape, dtype=self.ŷ_calib_l1_.dtype)
        if len(self.ŷ_calib_l2_) >= CONFORMAL_L2_MIN:
            X_l2, y_l2 = self._conformal_design(target_type, level="l2")
            # reshape: predict squeezes a single-quantile fit to 1-D (reference API
            # contract); the level-2 bias indexes per quantile, so restore (n, Q).
            delta_l2 = cqr_l1.predict(X_l2).reshape(len(X_l2), -1)
            clip = cqr_l1.intercept_clip(np.vstack([X_l1, X_l2]), np.hstack([y_l1, y_l2]))
            for j, quantile in enumerate(quantiles):
                intercept_l2 = np.quantile(y_l2 - delta_l2[:, j], quantile)
                bias_l2[j] = np.clip(intercept_l2, clip[0, j], clip[1, j])
        return bias_l2

    def _conformal_fitted(self, target_type: str, key: tuple) -> bool:
        """Whether the levels of this quantile tuple are fitted, and by the method the
        model is set to now (levels fitted under the other method are fitted anew)."""
        fitted = self.conformal_l1_[target_type].get(key)
        return fitted is not None and fitted.method == self.conformal_method

    def _fit_conformal_pair(self, quantiles: npt.ArrayLike) -> None:
        """Fit the "Δŷ" and "Δŷ/ŷ" level-1 regressors together.

        The two level-1 CQR fits share the design matrix; only the target differs
        (absolute vs ŷ-relative residuals). ``conformal_method="exact"`` (default)
        overlaps the two independent HiGHS LPs through a 2-thread pool (HiGHS releases
        the GIL during the C++ solve). ``conformal_method="smooth"`` solves both problems
        as one T = 2 batch of the damped-Newton solver on the model's device
        (:func:`~neo_ls_svm_torch.models.cqr.coherent_linear_quantile_regression_batched`),
        trading the LP's exact optimum for the smooth solver's ≤ 0.5% pinball gap. Later
        :meth:`_lazily_fit_conformal_predictor` calls hit the cache either way.
        """
        key = tuple(np.asarray(quantiles))
        missing = [t for t in ("Δŷ", "Δŷ/ŷ") if not self._conformal_fitted(t, key)]
        if len(missing) < 2:
            # 0 or 1 missing: nothing to batch or overlap; the caller's sequential
            # path fits the straggler.
            return
        # Materialise the shared calibration attributes before the threads start: the
        # lazy split must not race between the two fits.
        self.ŷ_calib_l1_  # noqa: B018
        if self.conformal_method == "smooth":
            quantiles_arr = np.asarray(quantiles)
            X_l1, y_abs = self._conformal_design("Δŷ")
            _, y_rel = self._conformal_design("Δŷ/ŷ")
            X_i = np.hstack([X_l1, np.ones((X_l1.shape[0], 1), dtype=X_l1.dtype)])
            beta, beta_full = coherent_linear_quantile_regression_batched(
                X_i,
                np.stack([y_abs, y_rel]),
                quantiles=quantiles_arr.astype(y_abs.dtype),
                sample_weight=self.sample_weight_calib_l1_,
                device=self.device_,
            )
            for t, (target_type, y_t) in enumerate((("Δŷ", y_abs), ("Δŷ/ŷ", y_rel))):
                cqr = CoherentLinearQuantileRegressor(
                    quantiles=quantiles_arr, method="smooth", device=self.device_
                )
                cqr.n_features_in_ = X_l1.shape[1]
                cqr.y_dtype_ = y_t.dtype
                cqr.β_, cqr.β_full_ = beta[t], beta_full[t]
                self.conformal_l1_[target_type][key] = cqr
                self.conformal_l2_[target_type][key] = self._conformal_level2_bias(
                    cqr, target_type, quantiles_arr, X_l1, y_t
                )
            return
        with ThreadPoolExecutor(max_workers=2) as pool:
            futures = [
                pool.submit(self._lazily_fit_conformal_predictor, t, quantiles) for t in missing
            ]
            for future in futures:
                future.result()

    def _lazily_fit_conformal_predictor(
        self, target_type: str, quantiles: npt.ArrayLike
    ) -> tuple[CoherentLinearQuantileRegressor, npt.NDArray]:
        """Fit-or-fetch the two conformal levels for a quantile tuple (ref ``:489-532``)."""
        quantiles = np.asarray(quantiles)
        key = tuple(quantiles)
        if self._conformal_fitted(target_type, key):
            return self.conformal_l1_[target_type][key], self.conformal_l2_[target_type][key]
        X_l1, y_l1 = self._conformal_design(target_type)
        cqr_l1 = CoherentLinearQuantileRegressor(
            quantiles=quantiles, method=self.conformal_method, device=self.device_
        )
        cqr_l1.fit(X_l1, y_l1, sample_weight=self.sample_weight_calib_l1_)
        self.conformal_l1_[target_type][key] = cqr_l1
        bias_l2 = self._conformal_level2_bias(cqr_l1, target_type, quantiles, X_l1, y_l1)
        self.conformal_l2_[target_type][key] = bias_l2
        return cqr_l1, bias_l2

    def _conformal_device_params(
        self, quantiles: npt.NDArray, priority: str
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """The fitted conformal planes on the model's device, staged once per
        (quantiles, priority, conformal_method).

        The level-1/level-2 fits are made lazily, once per quantile tuple (ref
        ``:489-532``); what serving needs from them is the (F+1)×Q coefficient planes and
        the Q biases, uploaded here and cached so that steady-state serving never touches
        the host. The method is part of the key: planes fitted under one method must not
        be served after the caller switches to the other.
        """
        key = ("conformal_dev", tuple(float(q) for q in quantiles), priority, self.conformal_method)
        cache = self.__dict__.setdefault("_device_cache", {})
        if key not in cache:
            self._fit_conformal_pair(quantiles)
            cqr_abs, bias_abs = self._lazily_fit_conformal_predictor("Δŷ", quantiles)
            cqr_rel, bias_rel = self._lazily_fit_conformal_predictor("Δŷ/ŷ", quantiles)
            bias_abs, bias_rel = _coverage_clamped_biases(bias_abs, bias_rel, quantiles, priority)
            dtype = self._compute_dtype()
            cache[key] = tuple(
                to_device(a, self.device_, dtype=dtype)
                for a in (cqr_abs.β_, bias_abs, cqr_rel.β_, bias_rel)
            )
        return cache[key]

    def _iso_thresholds_device(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The isotonic calibrator's thresholds on the model's device (once per fit), in
        float64 as the host calibrator holds them: a training set of a million rows leaves
        thresholds closer together than float32 tells apart."""
        cache = self.__dict__.setdefault("_device_cache", {})
        if "iso_thresholds" not in cache:
            calibrator = self.predict_proba_calibrator_
            cache["iso_thresholds"] = tuple(
                to_device(a, self.device_, dtype=np.float64)
                for a in (calibrator.X_thresholds_, calibrator.y_thresholds_)
            )
        return cache["iso_thresholds"]

    def predict_quantiles(
        self,
        X: "npt.NDArray | torch.Tensor | pd.DataFrame",
        *,
        quantiles: npt.ArrayLike = (0.025, 0.5, 0.975),
        priority: Literal["accuracy", "coverage"] = "accuracy",
    ) -> "npt.NDArray | torch.Tensor | pd.DataFrame":
        """Predict conformally calibrated quantiles (ref ``:554-624``).

        A regressor returns (n, |quantiles|), a single quantile included; a classifier
        the (n, |quantiles|, 2) tensor of calibrated class probabilities. A
        ``torch.Tensor`` on the model's device stays there: after the one-time conformal
        fit and upload of its planes, a call is one chunked pass for ŷ and σ (they share
        the feature or kernel block) plus the combine, and the result is a tensor on that
        device. NumPy and pandas input crosses once per chunk, runs the same programs,
        and comes back as NumPy or pandas.
        """
        check_is_fitted(self, ["γ_"])
        X_v = self._validated(X)
        quantiles = np.asarray(quantiles)
        beta_abs, bias_abs, beta_rel, bias_rel = self._conformal_device_params(quantiles, priority)
        both = self._decision_var_in_chunks(X_v, device_out=True)
        yhat = both[:, 0]
        std = torch.sqrt(torch.clamp(both[:, 1], min=0.0))
        is_regressor = self._estimator_type == "regressor"
        out = _conformal_quantiles(
            yhat, std, beta_abs, bias_abs, beta_rel, bias_rel, is_regressor=is_regressor
        )
        if not is_regressor:
            out = _isotonic_proba(out.to(torch.float64), *self._iso_thresholds_device())
        if is_tensor(X_v):
            return out.to(yhat.dtype)
        yhat_quantiles: npt.NDArray = out.cpu().numpy()
        if is_regressor and not np.issubdtype(self.y_dtype_, np.integer):
            yhat_quantiles = yhat_quantiles.astype(self.y_dtype_)
        if is_pandas(X):
            try:
                import pandas as pd
            except ImportError:
                return yhat_quantiles
            if is_regressor:
                frame = pd.DataFrame(yhat_quantiles, index=X.index, columns=quantiles)
            else:
                neg = pd.DataFrame(yhat_quantiles[:, :, 0], index=X.index, columns=quantiles)
                pos = pd.DataFrame(yhat_quantiles[:, :, 1], index=X.index, columns=quantiles)
                frame = pd.concat(
                    [neg, pos], axis=0, keys=self.classes_, names=["class", X.index.name]
                )
            frame.columns.name = "quantile"
            return frame
        return yhat_quantiles

    def predict_interval(
        self, X: "npt.NDArray | torch.Tensor | pd.DataFrame", *, coverage: float = 0.95
    ) -> "npt.NDArray | torch.Tensor | pd.DataFrame":
        """Predict conformally calibrated intervals (ref ``:636-645``)."""
        lb = (1 - coverage) / 2
        return self.predict_quantiles(X, quantiles=(lb, 1 - lb), priority="coverage")
