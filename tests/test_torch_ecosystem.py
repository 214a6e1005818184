"""sklearn interop of the port's estimator on ``device="cpu"``: Pipeline and
``cross_val_score``, ``GridSearchCV``, ``clone`` (sklearn's and the package's) keeping
``device``, and ``OneVsRestClassifier`` over the binary estimator, with the JAX package's
own gates (``tests/test_ecosystem.py``, ``tests/test_multiclass.py``)."""

import numpy as np
import torch
from sklearn.base import clone as sk_clone
from sklearn.model_selection import GridSearchCV, cross_val_score
from sklearn.multiclass import OneVsRestClassifier
from sklearn.pipeline import make_pipeline
from sklearn.preprocessing import StandardScaler

from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.utils.base import clone

from .conftest import make_classification_dataset, make_regression_dataset
from .test_multiclass import _make_multiclass

# The suite runs several worker processes on a few cores: more intra-op threads than that
# only contend (these shapes are small).
torch.set_num_threads(2)


def test_pipeline_and_cross_val() -> None:
    X, y = make_regression_dataset(n=1500, seed=101)
    pipe = make_pipeline(StandardScaler(), NeoLSSVM(device="cpu"))
    scores = cross_val_score(pipe, X, y, cv=3)
    assert scores.shape == (3,)
    assert np.all(scores > 0.3)


def test_grid_search() -> None:
    X, y = make_classification_dataset(n=900, seed=102)
    grid = GridSearchCV(NeoLSSVM(device="cpu"), param_grid={"dual": [True, "auto"]}, cv=2, n_jobs=1)
    grid.fit(X, y)
    assert grid.best_score_ > 0.6
    assert hasattr(grid.best_estimator_, "γ_")
    assert grid.best_estimator_.device == "cpu"


def test_clone_keeps_device_and_drops_the_fit() -> None:
    X, y = make_regression_dataset(n=300, seed=103)
    model = NeoLSSVM(device="cpu", precision="fast").fit(X, y)
    for copy in (sk_clone(model), clone(model)):
        assert copy.get_params() == model.get_params()
        assert copy.device == "cpu"
        assert not hasattr(copy, "γ_")
        np.testing.assert_array_equal(copy.fit(X, y).predict(X), model.predict(X))


def test_one_vs_rest_multiclass() -> None:
    X, y = _make_multiclass()
    split = 1500
    model = OneVsRestClassifier(NeoLSSVM(estimator_type="classifier", device="cpu"))
    model.fit(X[:split], y[:split])
    accuracy = np.mean(model.predict(X[split:]) == y[split:])
    assert accuracy > 0.75
    proba = model.predict_proba(X[split:])
    assert proba.shape == (len(X) - split, 3)
    assert np.all((proba >= 0) & (proba <= 1))
