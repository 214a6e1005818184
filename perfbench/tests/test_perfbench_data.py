"""The generators give the published widths and the same rows for the same seed."""

import numpy as np
import pytest
import torch

from perfbench import harness

CPU = torch.device("cpu")


def _rows(config_name: str, seed: int, n: int = 4000, n_test: int = 500) -> dict:
    config = {**harness.load_json(harness.BENCH / "configs" / f"{config_name}.json"), "n_train": n, "n_test": n_test}
    dataset = harness.load_module(harness.BENCH / "datasets" / f"{config['generator']}.py")
    return {k: v.numpy() for k, v in dataset.make(config, seed, CPU, ("train", "test")).items()}


@pytest.mark.parametrize("config_name", ["higgs", "msd"])
def test_same_seed_same_rows_other_seed_other_rows(config_name):
    large_seed = 2**31 + 12345  # the driver's seeds pass 32 signed bits
    a, b, c = _rows(config_name, large_seed), _rows(config_name, large_seed), _rows(config_name, large_seed + 1)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert not np.array_equal(a["X"], c["X"])


@pytest.mark.parametrize("config_name", ["higgs", "msd"])
def test_published_widths_and_dtypes(config_name):
    config = harness.load_json(harness.BENCH / "configs" / f"{config_name}.json")
    rows = _rows(config_name, 7)
    assert rows["X"].shape == (4000, config["d"]) and rows["X_test"].shape == (500, config["d"])
    assert rows["X"].dtype == np.dtype(config["dtype"]) and np.isfinite(rows["X"]).all()


def test_higgs_labels_and_columns():
    rows = _rows("higgs", 11, n=20000)
    assert set(np.unique(rows["y"])) == {0.0, 1.0}
    assert abs(rows["y"].mean() - 0.53) < 0.01
    btags = rows["X"][:, [8, 12, 16, 20]]
    levels = np.unique(btags)
    assert len(levels) == 3 and np.allclose(levels, [0.0, 1.0865, 2.173])
    momenta = rows["X"][:, [0, 3, 5, 9, 13, 17]]
    assert (momenta > 0).all() and np.median(momenta) < momenta.mean()  # skewed right


def test_msd_years_and_layout():
    rows = _rows("msd", 13, n=20000)
    years = rows["y"]
    assert years.min() >= 1922 and years.max() <= 2011 and (years == np.round(years)).all()
    assert np.median(years) > 2000  # skewed toward the 2000s
    variances = rows["X"][:, 12 + np.array([0, 12, 23, 33, 42, 50, 57, 63, 68, 72, 75, 77])]
    assert (variances > 0).all()  # the diagonal of each song's timbre covariance
