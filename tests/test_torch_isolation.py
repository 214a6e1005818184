"""The port stands alone: neither ``neo_ls_svm_torch`` nor ``chip_smoke.py`` imports JAX
or the JAX package, at import time or anywhere in their source. The modules of the
calibration, persistence and multi-GPU layers, the package re-exports and the profiling
helpers import no scikit-learn either."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "neo_ls_svm_tpu")
SOURCES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "neo_ls_svm_torch").rglob("*.py")
) + ["chip_smoke.py"]


# The calibration, persistence and multi-GPU layers: no scikit-learn (the machine with
# the card promises none), beside no JAX.
NO_SKLEARN = [
    "neo_ls_svm_torch/native/__init__.py",
    "neo_ls_svm_torch/models/isotonic.py",
    "neo_ls_svm_torch/models/cqr.py",
    "neo_ls_svm_torch/models/conformal.py",
    "neo_ls_svm_torch/models/estimator.py",
    "neo_ls_svm_torch/utils/serialization.py",
    "neo_ls_svm_torch/utils/device.py",
    "neo_ls_svm_torch/parallel/collectives.py",
    "neo_ls_svm_torch/parallel/mesh.py",
    "neo_ls_svm_torch/parallel/distributed.py",
    "neo_ls_svm_torch/ops/__init__.py",
    "neo_ls_svm_torch/models/__init__.py",
    "neo_ls_svm_torch/utils/profiling.py",
    "chip_smoke.py",
]


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_of_jax(source: str) -> None:
    bad = [m for m in _imported_modules(REPO / source) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{source} imports {bad}"


@pytest.mark.parametrize("source", NO_SKLEARN)
def test_source_imports_no_sklearn(source: str) -> None:
    assert source in SOURCES
    bad = [m for m in _imported_modules(REPO / source) if m.split(".")[0] == "sklearn"]
    assert not bad, f"{source} imports {bad}"


def test_importing_the_port_loads_no_jax() -> None:
    modules = [
        "neo_ls_svm_torch",
        "neo_ls_svm_torch.models.primal",
        "neo_ls_svm_torch.models.dual",
        "neo_ls_svm_torch.models.routing",
        "neo_ls_svm_torch.ops.kernels",
        "neo_ls_svm_torch.ops.pretransform_device",
        "neo_ls_svm_torch.utils.transfer",
        "neo_ls_svm_torch.ops.cuda.gram",
        "neo_ls_svm_torch.ops.cuda.sweep",
        "neo_ls_svm_torch.utils.serialization",
        "neo_ls_svm_torch.utils.device",
        "neo_ls_svm_torch.native",
        "neo_ls_svm_torch.models.isotonic",
        "neo_ls_svm_torch.models.cqr",
        "neo_ls_svm_torch.models.conformal",
        "neo_ls_svm_torch.models.estimator",
        "neo_ls_svm_torch.parallel.collectives",
        "neo_ls_svm_torch.parallel.mesh",
        "neo_ls_svm_torch.parallel.distributed",
        "neo_ls_svm_torch.ops",
        "neo_ls_svm_torch.models",
        "neo_ls_svm_torch.utils.metrics",
        "neo_ls_svm_torch.utils.profiling",
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=True
    )
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
