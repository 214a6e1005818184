"""Input validation and host-side helpers.

Re-implements the slice of scikit-learn's validation utilities the reference relies on
(``check_array``/``check_X_y``/``check_consistent_length``/``check_is_fitted``/
``check_random_state``; ref ``_neo_ls_svm.py:13-18``) plus the exact ``train_test_split``
shuffle semantics used for the conformal calibration split (ref ``_neo_ls_svm.py:423-430``),
without a scikit-learn dependency. Everything here is host-side NumPy: validation happens
once at the API boundary before data is staged onto the GPU.

A copy of ``neo_ls_svm_tpu.utils.validation`` without its JAX helper
(``is_device_array``); the port imports nothing of the JAX package.
"""

import warnings
from typing import Any

import numpy as np
import numpy.typing as npt


try:  # Inherit sklearn's exception/warning types when sklearn is installed, so user
    # code (and sklearn's own estimator checks) can catch them; otherwise standalone.
    from sklearn.exceptions import DataConversionWarning as _DataConversionWarningBase
    from sklearn.exceptions import NotFittedError as _NotFittedErrorBase
except ImportError:  # pragma: no cover - sklearn is present in dev environments.

    class _NotFittedErrorBase(ValueError, AttributeError):  # type: ignore[no-redef]
        pass

    class _DataConversionWarningBase(UserWarning):  # type: ignore[no-redef]
        pass


class NotFittedError(_NotFittedErrorBase):
    """Raised when a predict-family method is called before ``fit``."""


class DataConversionWarning(_DataConversionWarningBase):
    """Warned when the input data's shape or dtype is silently converted."""


def _check_n_features(estimator: Any, X: "npt.NDArray") -> "npt.NDArray":
    """Raise sklearn's message when X's width disagrees with the fitted width."""
    if X.shape[1] != estimator.n_features_in_:
        msg = (
            f"X has {X.shape[1]} features, but {type(estimator).__name__} is expecting "
            f"{estimator.n_features_in_} features as input."
        )
        raise ValueError(msg)
    return X


def is_pandas(obj: Any) -> bool:
    """True when ``obj`` quacks like a pandas DataFrame (the predicate every
    predict-family method uses to decide pandas-out)."""
    return hasattr(obj, "dtypes") and hasattr(obj, "index")


def check_random_state(seed: Any) -> np.random.RandomState:
    """Turn ``seed`` into a ``np.random.RandomState`` (sklearn-compatible semantics)."""
    if seed is None or seed is np.random:
        return np.random.mtrand._rand
    if isinstance(seed, (int, np.integer)):
        return np.random.RandomState(seed)
    if isinstance(seed, np.random.RandomState):
        return seed
    msg = f"{seed!r} cannot be used to seed a numpy.random.RandomState instance"
    raise ValueError(msg)


def check_consistent_length(*arrays: Any) -> None:
    """Raise when the given arrays have differing first dimensions."""
    lengths = [len(a) for a in arrays if a is not None]
    if len(set(lengths)) > 1:
        msg = f"Found input variables with inconsistent numbers of samples: {lengths}"
        raise ValueError(msg)


def check_is_fitted(estimator: Any, attributes: list[str] | None = None) -> None:
    """Raise ``NotFittedError`` unless the estimator has fitted attributes."""
    if attributes is None:
        fitted = [
            k for k in vars(estimator) if k.endswith("_") and not k.startswith("__")
        ]
    else:
        fitted = [a for a in attributes if hasattr(estimator, a)]
    if not fitted:
        msg = (
            f"This {type(estimator).__name__} instance is not fitted yet. Call 'fit' with "
            "appropriate arguments before using this estimator."
        )
        raise NotFittedError(msg)


def assert_all_finite(X: npt.NDArray[Any]) -> None:
    """Raise sklearn's ``ValueError`` when a floating array holds a NaN or an infinity."""
    if np.issubdtype(X.dtype, np.floating) and not np.all(np.isfinite(X)):
        msg = "Input contains NaN or infinity."
        raise ValueError(msg)


def check_array(
    X: Any,
    *,
    dtype: tuple[type, ...] | type | None = (np.float64, np.float32),
    ensure_2d: bool = True,
    ensure_min_samples: int = 1,
    ensure_all_finite: bool = True,
    allow_nd: bool = False,
) -> npt.NDArray[Any]:
    """Validate an array-like and return it as a NumPy array.

    Mirrors the behaviour of ``sklearn.utils.check_array`` for the argument subset the
    reference uses (ref ``_neo_ls_svm.py:335,462,564``).
    """
    if hasattr(X, "toarray"):  # Sparse matrices are not supported.
        msg = "Sparse input is not supported; densify the input first."
        raise TypeError(msg)
    if hasattr(X, "to_numpy") and hasattr(X, "dtypes"):  # pandas DataFrame
        X = X.to_numpy()
    elif hasattr(X, "to_numpy") and hasattr(X, "dtype"):  # pandas Series
        X = X.to_numpy()
    X = np.asarray(X)
    if X.dtype == object:
        # Propagate the conversion error untouched: its type and message ("could not
        # convert string to float", "float() argument must be a string...") are the
        # sklearn-compatible contract.
        X = X.astype(np.float64)
    if np.issubdtype(X.dtype, np.complexfloating):
        msg = "Complex data not supported."
        raise ValueError(msg)
    if ensure_2d:
        if X.ndim == 1:
            msg = (
                f"Expected 2D array, got 1D array instead:\narray={X!r}.\n"
                "Reshape your data either using array.reshape(-1, 1) if your data has a "
                "single feature or array.reshape(1, -1) if it contains a single sample."
            )
            raise ValueError(msg)
        if X.ndim == 0:
            msg = f"Expected 2D array, got scalar array instead:\narray={X!r}."
            raise ValueError(msg)
    if not allow_nd and X.ndim > 2:
        msg = f"Found array with dim {X.ndim}, expected <= 2."
        raise ValueError(msg)
    if dtype is not None:
        allowed = dtype if isinstance(dtype, tuple) else (dtype,)
        if X.dtype not in [np.dtype(d) for d in allowed]:
            X = X.astype(allowed[0])
    if ensure_all_finite:
        assert_all_finite(X)
    if X.shape[0] < ensure_min_samples:
        msg = (
            f"Found array with {X.shape[0]} sample(s) while a minimum of "
            f"{ensure_min_samples} is required."
        )
        raise ValueError(msg)
    if ensure_2d and X.shape[1] < 1:
        msg = f"Found array with 0 feature(s) (shape={X.shape}) while a minimum of 1 is required."
        raise ValueError(msg)
    return X


def check_X_y(
    X: Any,
    y: Any,
    *,
    dtype: tuple[type, ...] | type | None = (np.float64, np.float32),
    ensure_min_samples: int = 1,
    y_numeric: bool = False,
    ensure_all_finite: bool = True,
) -> tuple[npt.NDArray[Any], npt.NDArray[Any]]:
    """Validate a feature matrix and target vector together. ``ensure_all_finite`` applies
    to X alone: y is always scanned."""
    if y is None:
        msg = "This estimator requires y to be passed, but the target y is None."
        raise ValueError(msg)
    X = check_array(X, dtype=dtype, ensure_min_samples=ensure_min_samples, ensure_all_finite=ensure_all_finite)
    if hasattr(y, "to_numpy"):
        y = y.to_numpy()
    y = np.asarray(y)
    if y.ndim == 2 and y.shape[1] == 1:
        warnings.warn(
            "A column-vector y was passed when a 1d array was expected. Please change "
            "the shape of y to (n_samples,), for example using ravel().",
            DataConversionWarning,
            stacklevel=2,
        )
        y = np.ravel(y)
    if y.ndim != 1:
        msg = f"y should be a 1d array, got an array of shape {y.shape} instead."
        raise ValueError(msg)
    if y_numeric and not np.issubdtype(y.dtype, np.number):
        y = y.astype(np.float64)
    if np.issubdtype(y.dtype, np.floating) and not np.all(np.isfinite(y)):
        msg = "Input y contains NaN or infinity."
        raise ValueError(msg)
    check_consistent_length(X, y)
    return X, y


def check_sample_weight(
    sample_weight: Any, n_samples: int, dtype: npt.DTypeLike = np.float64
) -> npt.NDArray[np.floating]:
    """Validate a sample-weight vector: 1-D, length n, nonnegative, not all zero."""
    sample_weight = np.asarray(sample_weight, dtype=dtype)
    if sample_weight.ndim != 1:
        msg = f"Sample weights must be 1D array or scalar, got shape {sample_weight.shape}."
        raise ValueError(msg)
    if sample_weight.shape[0] != n_samples:
        msg = f"sample_weight.shape == {sample_weight.shape}, expected ({n_samples},)!"
        raise ValueError(msg)
    if np.any(sample_weight < 0):
        msg = "Sample weights must be nonnegative."
        raise ValueError(msg)
    if np.sum(sample_weight) <= 0:
        msg = "The sample weights are all zero; at least one weight must be positive."
        raise ValueError(msg)
    return sample_weight


def train_test_split(
    *arrays: Any,
    train_size: int | float | None = None,
    random_state: Any = None,
) -> list[Any]:
    """Split arrays into random train and test subsets.

    Replicates scikit-learn's ``ShuffleSplit`` index order exactly — one call to
    ``RandomState.permutation(n)``, test indices first, then train indices — so the
    conformal calibration split (ref ``_neo_ls_svm.py:423-430``) is bit-for-bit
    reproducible against the reference for a given ``random_state``.
    """
    if not arrays:
        msg = "At least one array required as input"
        raise ValueError(msg)
    n = len(arrays[0])
    check_consistent_length(*arrays)
    if isinstance(train_size, float):
        n_train = int(np.floor(train_size * n))
    elif train_size is None:
        n_train = int(np.floor(0.75 * n))
    else:
        n_train = int(train_size)
    n_test = n - n_train
    if n_train <= 0 or n_test <= 0:
        msg = f"train_size={train_size} leads to an empty train or test set for n={n}."
        raise ValueError(msg)
    rng = check_random_state(random_state)
    permutation = rng.permutation(n)
    ind_test = permutation[:n_test]
    ind_train = permutation[n_test : (n_test + n_train)]
    out: list[Any] = []
    for a in arrays:
        a_np = np.asarray(a)
        out.append(a_np[ind_train])
        out.append(a_np[ind_test])
    return out
