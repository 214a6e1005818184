"""Pytest settings of the benchmark's own tests (``python -m pytest perfbench/tests``).

``chip`` marks a test that needs a CUDA device; it skips without one, decided inside the
``cuda_device`` fixture and never while a module is imported. On the card, whose Python has no
scikit-learn for the repository's warning filters: ``python -m pytest -c /dev/null perfbench/tests -m chip``.
"""

import pytest


def pytest_configure(config: pytest.Config) -> None:
    config.addinivalue_line("markers", "chip: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with -m chip")
    return torch.device("cuda", 0)


@pytest.fixture
def small_streaming_fits(monkeypatch: pytest.MonkeyPatch) -> None:
    """Make a fit of a few thousand rows take the route of a deployment's fit: the device
    pre-transform and the streaming solver with its kernels' plain versions."""
    from neo_ls_svm_torch.models import estimator, routing  # noqa: PLC0415

    monkeypatch.setattr(estimator, "STREAMING_BYTES_THRESHOLD", 0)
    monkeypatch.setattr(estimator, "STREAMING_ROW_CHUNK", 1024)
    monkeypatch.setattr(routing, "AUTO_DEVICE_PT_MIN_BYTES", 0)
