"""No run holds JAX or the JAX package, and the reference holds nothing of the program:
top-level module names compared whole (the port's name begins with the JAX package's)."""

import subprocess
import sys

import pytest

from perfbench import harness

ROOT = str(harness.ROOT)


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.', 1)[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True, timeout=300,
    ).stdout.strip().splitlines()[-1]
    return set(eval(out))  # noqa: S307 - our own subprocess's printed list


def test_the_harness_and_a_cpu_run_load_no_jax():
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "import perfbench.run, perfbench.harness, perfbench.calibrate, perfbench.fitcheck, perfbench.readers, perfbench.faults\n"
        "from perfbench import harness\n"
        "for kind in ('fit',):\n    harness.load_module(harness.BENCH / 'drivers' / f'{kind}.py')\n"
        "import neo_ls_svm_torch, neo_ls_svm_torch.models.estimator\n"
    )
    loaded = _loaded(code)
    assert not loaded & harness.FORBIDDEN_MODULES
    assert "neo_ls_svm_torch" in loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded("import sys; sys.path.insert(0, '.')\nimport perfbench.reference.lssvm, perfbench.reference.normalizer, perfbench.reference.separator")
    assert not loaded & (harness.FORBIDDEN_MODULES | {"neo_ls_svm_torch"})


@pytest.mark.parametrize(
    ("modules", "found"),
    [({"jax.numpy": 1}, ["jax"]), ({"neo_ls_svm_tpu.ops": 1}, ["neo_ls_svm_tpu"]),
     ({"neo_ls_svm_torch.models": 1, "jaxtyping": 1, "flaxen": 1}, [])],
)
def test_forbidden_names_compare_whole(modules, found):
    assert harness.forbidden_loaded(modules) == found
