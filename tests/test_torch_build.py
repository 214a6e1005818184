"""Builds of the CUDA kernels' library that run at the same moment do not share objects.

The ranks of a multi-GPU fit make their first CUDA call together, and each may build the
library. ``_build._compile`` gives every build a directory of its own for its objects and
its link, and only the finished library replaces ``<out_dir>/<lib>``, atomically. There
is no ``nvcc`` here: a stub compiler stands in for it, logs every object path it is asked
to write, and "links" by concatenating the objects.
"""

import sys
import threading
from pathlib import Path

import pytest

from neo_ls_svm_torch.ops.cuda import _build

STUB = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[args.index("-c") + 1]
    with open({log!r}, "a") as log:
        log.write(out + "\\n")
    time.sleep(0.05)  # long enough for concurrent builds to overlap
    with open(out, "w") as obj:
        obj.write("object of " + src + "\\n")
else:
    objects = [a for a in args if a.endswith(".o")]
    with open(out, "w") as lib:
        lib.write("".join(open(o).read() for o in objects))
"""


@pytest.fixture
def stub(tmp_path: Path) -> tuple[str, Path, list[Path]]:
    log = tmp_path / "objects.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable, log=str(log)))
    nvcc.chmod(0o755)
    sources = []
    for name in ("gram.cu", "sweep.cu", "features.cu"):
        src = tmp_path / "csrc" / name
        src.parent.mkdir(exist_ok=True)
        src.write_text("// " + name)
        sources.append(src)
    return str(nvcc), log, sources


def _expected_library(sources: list[Path]) -> str:
    return "".join(f"object of {src}\n" for src in sources)


def test_two_builds_write_their_objects_to_different_paths(stub, tmp_path) -> None:
    nvcc, log, sources = stub
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    for _ in range(2):
        lib = _build._compile(nvcc, sources, out_dir)
    objects = log.read_text().split()
    assert len(objects) == 2 * len(sources)
    assert len(set(objects)) == len(objects)  # no object path is written twice
    assert all(Path(o).parent.parent == out_dir for o in objects)
    assert lib == out_dir / _build._LIB_NAME and lib.read_text() == _expected_library(sources)
    assert sorted(p.name for p in out_dir.iterdir()) == [_build._LIB_NAME]  # private dirs removed


def test_concurrent_builds_each_link_a_whole_library(stub, tmp_path) -> None:
    nvcc, log, sources = stub
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    libs, errors = [], []

    def build() -> None:
        try:
            libs.append(_build._compile(nvcc, sources, out_dir).read_text())
        except Exception as error:  # noqa: BLE001 - reported by the assertion below
            errors.append(error)

    threads = [threading.Thread(target=build) for _ in range(6)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=60)
        assert not thread.is_alive()
    assert not errors
    assert libs == [_expected_library(sources)] * 6
    objects = log.read_text().split()
    assert len(set(objects)) == len(objects) == 6 * len(sources)
    assert (out_dir / _build._LIB_NAME).read_text() == _expected_library(sources)
