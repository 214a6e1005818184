"""The comparison that decides ``correct`` in a fit cell.

The program's fits are held to the plain reference (``reference/``), computed in float64
once the window has closed, from the rows, the seed of the estimator's ``random_state`` and
its parameters. Each number is a worst case:

- ``scale_err``: the normalizer's shift and scale, off the reference's, over |scale|;
- ``sep_err``: the separator's basis A against the reference's edges: each column as an
  eigenvector of its bin's edge Gram, in its rank, and scaled by λ
  (``separator.separator_error``; an eigenvector's sign, and its turn within a nearly
  repeated eigenvalue, are free). The reference draws the edge samples from the same seed
  and takes the nearest points by the distances of the rows standardised with the
  candidate's shift and scale, in the rows' own precision, so that a near tie is broken
  alike (``reference/separator.py``);
- ``fold_err``: the solver's operands M and b, off the fold of the candidate's A (held by
  ``sep_err``), the reference's own frequencies Z (each column's sign brought to the
  candidate's) and its own normalizer, over the largest entry;
- ``gram_err``: K1's augmented Gram, max |ΔG_ij|/√(G_ii·G_jj), the reference's from the
  program's M and b;
- ``eig_err``: K2's operands (the eigenbasis Qs, the resolvent columns r_all and k) as an
  eigendecomposition of the reference's Gram: the residual of the eigenpairs over the
  largest eigenvalue, the basis's departure from orthonormal, r_all off 1/(γ + λ)
  relative, and k off Qsᵀ·WᵀS²y over its largest entry;
- ``sweep_err``: K2's answer in every fit against the one worked out again in float64 from
  the rows and the operands K2 got in the window's last fit: the LOO error of each γ,
  relative, its worst over the grid; the γ-selection objective, its mean gap over the
  grid's mean (a classifier's objective counts the rows whose |LOO residual| reaches 1,
  so one row that rounding moves across 1 moves one value by 1/n); or, if larger, how far
  the chosen γ's objective lies above that objective's minimum;
- ``beta_err``: ‖Δβ‖/‖β‖ of every fit, against the reference's re-solve at the same γ;
- ``resid_err``: the last fit's training residuals W·Jβ − y, max |Δ|, over the target's sd;
- ``loo_err``: its LOO predictions y + e, max |Δ|, over the target's sd, against those
  worked out from its K2 operands.

So the reference follows the program at two points, each checked by itself: the solver's
M and b (against ``fold_err``'s fold, from the rows) and K2's operands (``eig_err``, against
the reference's Gram). A cell compares the numbers its ``workloads/<cell>.json`` gives
limits; the others are printed beside them. A control (:func:`control_outputs`) is the
reference itself in a lower precision, put in the program's place: it must fail at least
one number.
"""

from typing import Any

import numpy as np
import torch

from perfbench.reference import lssvm, normalizer, separator

# The precision below the one the configuration states, in which a control computes.
CONTROL_MODE = {"float32": "tf32", "float64": "f32"}
# The rows' own precision, in which the reference breaks the edge search's near ties.
ROWS_MODE = {"float32": "f32", "float64": "f64"}
# K2's operands, by their place in ``fused_loo_sweep(X, M, b, y, s, s2, Qs, r_all, k, …)``.
SWEEP_OPERANDS = ("Qs", "r_all", "k")


def setting(model: Any) -> dict:
    """The device pre-transform's parameters as the estimator was configured."""
    fm = model.primal_feature_map_
    if type(fm).__name__ != "OrthogonalRandomFourierFeatures":
        msg = f"the reference holds the orthogonal random Fourier map only, not {type(fm).__name__}"
        raise ValueError(msg)
    affine = fm.affine_feature_map
    return {
        "seed": int(model.random_state),
        "num_features": int(fm.num_features),
        "edge_sample_size": int(affine.edge_sample_size),
        "edge_search_multiplier": int(affine.edge_search_multiplier),
        "rank_threshold": float(affine.rank_threshold),
    }


def step_outputs(model: Any, swept: tuple) -> dict[str, Any]:
    """What one fit of the window answered: the grid index of its γ, its β, and K2's
    answer (the LOO error and the γ-selection objective of each γ), left where it lies (a
    tensor on the device is not waited for)."""
    return {
        "optimum": int(np.argmin(np.abs(np.asarray(model.γs_, np.float64) - model.γ_))),
        "beta": np.asarray(model.beta_emb_, np.float64),
        "loo_error": swept[0],
        "objective": swept[1],
    }


def pulled(step: dict) -> dict:
    """A step with K2's answer as NumPy float64."""
    return {**step, **{k: step[k].double().cpu().numpy() for k in ("loo_error", "objective")}}


def sweep_operands(args: dict) -> dict[str, np.ndarray]:
    """K2's operands as a probe kept them, as NumPy float64 (exact from float32)."""
    return {name: args[name].double().cpu().numpy() for name in SWEEP_OPERANDS}


def program_outputs(model: Any, gram: Any, operands: dict, steps: list[dict]) -> dict[str, Any]:
    """The candidate of the comparison from the window's last fit and every fit's step."""
    fm = model.primal_feature_map_
    affine = fm.affine_feature_map
    return {
        "shift": np.asarray(affine.shift_, np.float64).reshape(-1),
        "scale": np.asarray(affine.scale_, np.float64).reshape(-1),
        "A": np.asarray(fm.prefold_A_, np.float64),
        "Z": np.asarray(fm.Z_, np.float64),
        "M": np.asarray(model._M_map, np.float64),
        "b": np.asarray(model._b_map, np.float64).reshape(-1),
        "gram": np.asarray(gram, np.float64),
        "operands": operands,
        "steps": steps,
        "residuals": np.asarray(model.residuals_, np.float64),
        "loo_yhat": np.asarray(model.loo_ŷ_, np.float64),
    }


class _Rows:
    """The rows with the target as the solver fits it and its bins."""

    def __init__(self, X: np.ndarray, y: np.ndarray, is_classifier: bool, setting: dict, device: Any) -> None:
        self.X, self.is_classifier, self.setting, self.device = X, is_classifier, setting, device
        self.y_signed = lssvm.signed_target(y, is_classifier, np.float64)
        self.codes, self.num_bins = normalizer.target_codes(torch.from_numpy(self.y_signed).to(device), is_classifier)
        self.totals = torch.bincount(self.codes, minlength=self.num_bins)

    def separator(self, shift: np.ndarray, scale: np.ndarray, select: dict, mode: str) -> dict[str, np.ndarray]:
        return separator.separator(
            self.X, self.codes, self.totals, self.num_bins, self.setting,
            is_classifier=self.is_classifier, shift=shift, scale=scale, select=select, mode=mode,
        )


class Reference(_Rows):
    """The float64 reference of one fit: the pre-transform from the rows and the seed, and
    the LS-SVM from the rows and the program's operands M and b."""

    def __init__(
        self, X: np.ndarray, y: np.ndarray, is_classifier: bool, setting: dict, M: np.ndarray, b: np.ndarray,
        *, device: Any,
    ) -> None:
        super().__init__(X, y, is_classifier, setting, device)
        self.shift, self.scale = normalizer.normalizer(
            X, self.y_signed, is_classifier=is_classifier, mode="f64", device=device
        )
        self.fit = lssvm.Fit(
            X, self.y_signed, M, b, lssvm.gamma_grid(X.dtype), is_classifier=is_classifier, mode="f64", device=device
        )
        self._betas: dict[int, np.ndarray] = {}

    def beta(self, index: int) -> np.ndarray:
        if index not in self._betas:
            self._betas[index] = self.fit.beta(index)
        return self._betas[index]

    def pretransform_errors(self, candidate: dict) -> dict[str, float]:
        select = {"shift": candidate["shift"], "scale": candidate["scale"], "mode": ROWS_MODE[str(self.X.dtype)]}
        made = self.separator(self.shift, self.scale, select, "f64")
        sign_Z = separator.columns_up_to_sign(candidate["Z"], made["Z"])
        M, b = normalizer.fold(candidate["A"], made["Z"] * sign_Z, self.shift, self.scale, mode="f64", device=self.device)
        scale_r = np.abs(self.scale)
        return {
            "scale_err": float(max(np.max(np.abs(candidate["shift"] - self.shift) / scale_r),
                                   np.max(np.abs(candidate["scale"] - self.scale) / scale_r))),
            "sep_err": separator.separator_error(candidate["A"], made),
            "fold_err": float(max(np.max(np.abs(candidate["M"] - M)) / np.max(np.abs(M)),
                                  np.max(np.abs(candidate["b"] - b)) / np.max(np.abs(b)))),
        }

    def eig_err(self, operands: dict) -> float:
        """How far K2's operands are from an eigendecomposition of c₀⁻¹·B of the reference."""
        fit = self.fit
        Qs, r_all, k = (torch.from_numpy(operands[name]).to(fit.B.device) for name in SWEEP_OPERANDS)
        Q = fit.sign[:, None] * Qs
        lam = 1.0 / r_all[:, 0] - fit.gammas[0]
        top = lam.abs().max()
        residual = (fit.inv_c0 * fit.B) @ Q - Q * lam[None, :]
        eye = torch.eye(Q.shape[1], dtype=Q.dtype, device=Q.device)
        r_ref = 1.0 / (fit.gammas[None, :] + lam[:, None])
        k_ref = Qs.T @ fit.b_vec
        return float(max(
            residual.abs().max() / top,
            (Q.T @ Q - eye).abs().max(),
            ((r_all - r_ref).abs() / r_ref).max(),
            (k - k_ref).abs().max() / k_ref.abs().max(),
        ))


def control_outputs(
    X: np.ndarray, y: np.ndarray, is_classifier: bool, setting: dict, M: np.ndarray, b: np.ndarray,
    *, mode: str, device: Any,
) -> dict[str, Any]:
    """The reference in ``mode``'s lower precision, put in the program's place, as a
    candidate: its own pre-transform from the rows and the seed, and its own LS-SVM on the
    program's M and b."""
    rows = _Rows(X, y, is_classifier, setting, device)
    shift, scale = normalizer.normalizer(X, rows.y_signed, is_classifier=is_classifier, mode=mode, device=device)
    made = rows.separator(shift, scale, {"shift": shift, "scale": scale, "mode": mode}, mode)
    A, Z = made["A"], made["Z"]
    M_c, b_c = normalizer.fold(A, Z, shift, scale, mode=mode, device=device)
    fit = lssvm.Fit(X, rows.y_signed, M, b, lssvm.gamma_grid(X.dtype), is_classifier=is_classifier, mode=mode, device=device)
    operands = fit.operands()
    optimum = int(np.argmin(fit.sweep(operands)["objective"]))
    swept = fit.sweep(operands, optimum)
    return {
        "shift": shift, "scale": scale, "A": A, "Z": Z, "M": M_c, "b": b_c,
        "gram": fit.gram.double().cpu().numpy(),
        "operands": {name: v.double().cpu().numpy() for name, v in operands.items()},
        "steps": [{"optimum": optimum, "beta": fit.beta(optimum), "loo_error": swept["loo_error"],
                   "objective": swept["objective"]}],
        "residuals": swept["residuals"],
        "loo_yhat": swept["loo_yhat"],
    }


def numbers(candidate: dict, ref: Reference) -> dict[str, float]:
    """The numbers of a candidate against the float64 reference."""
    G_r = ref.fit.gram.double().cpu().numpy()
    diag = np.sqrt(np.abs(np.diag(G_r)))
    last = candidate["steps"][-1]["optimum"]
    swept = ref.fit.sweep(candidate["operands"], last)
    obj_r, err_r = swept["objective"], swept["loo_error"]
    i_r = int(np.argmin(obj_r))
    sweep, beta = 0.0, 0.0
    for step in candidate["steps"]:
        i_c = step["optimum"]
        sweep = max(
            sweep,
            float(np.max(np.abs(step["loo_error"] - err_r) / err_r)),
            float(np.mean(np.abs(step["objective"] - obj_r)) / np.mean(obj_r)),
            float((obj_r[i_c] - obj_r[i_r]) / obj_r[i_r]),
        )
        beta_r = ref.beta(i_c)
        beta = max(beta, float(np.linalg.norm(step["beta"] - beta_r) / np.linalg.norm(beta_r)))
    y_sd = float(np.std(ref.y_signed))
    return {
        **ref.pretransform_errors(candidate),
        "gram_err": float(np.max(np.abs(candidate["gram"] - G_r) / np.outer(diag, diag))),
        "eig_err": ref.eig_err(candidate["operands"]),
        "sweep_err": sweep,
        "beta_err": beta,
        "resid_err": float(np.max(np.abs(candidate["residuals"] - swept["residuals"]))) / y_sd,
        "loo_err": float(np.max(np.abs(candidate["loo_yhat"] - swept["loo_yhat"]))) / y_sd,
    }
