"""The program's own spans (``neo_ls_svm_torch/utils/profiling.py``) on a fit that takes the
deployment's route at a small size on the CPU: the streaming solver with the device
pre-transform.

With no profiler a span records nothing and enters no ``record_function``. Under
``trace()`` each fit records one tree of 14 ``neo.*`` spans, the same ranges are in the
Chrome trace, the upload and the pull count their bytes, the buffer keeps its bound, and
the fit's attributes are bit-equal with the profiler on and off. The upload counts the
padding rows it writes on the device, and each route says who checked X for NaN and inf:
the device (``neo.fit.finite``) or the host (``neo.fit.validate``'s ``host_scanned_bytes``)."""

import collections
import json

import numpy as np
import pytest
import torch

from neo_ls_svm_torch import NeoLSSVM
from neo_ls_svm_torch.models import estimator, routing
from neo_ls_svm_torch.utils import profiling
from neo_ls_svm_torch.utils.transfer import upload_rows

from ._torch_compare import same

# Each span of a fit and the span open around it.
PARENT = {
    "neo.fit": None,
    "neo.fit.validate": "neo.fit",
    "neo.fit.target": "neo.fit",
    "neo.fit.stage": "neo.fit",
    "neo.upload": "neo.fit",
    "neo.fit.finite": "neo.fit",
    "neo.pretransform": "neo.fit",
    "neo.pretransform.normalizer": "neo.pretransform",
    "neo.solve": "neo.fit",
    "neo.solve.k1": "neo.solve",
    "neo.solve.eigh": "neo.solve",
    "neo.solve.k2": "neo.solve",
    "neo.solve.pass3": "neo.solve",
    "neo.fit.pull": "neo.fit",
}
ROWS, COLUMNS, CHUNK = 2500, 5, 1024


def _data() -> tuple[np.ndarray, np.ndarray]:
    gen = np.random.RandomState(3)
    X = gen.randn(ROWS, COLUMNS).astype(np.float32)
    return X, (X[:, 0] + 0.3 * gen.randn(ROWS) > 0).astype(np.int64)


def _streaming(mp: pytest.MonkeyPatch) -> None:
    """A fit of a few thousand rows takes the streaming route with the device pre-transform."""
    mp.setattr(estimator, "STREAMING_BYTES_THRESHOLD", 0)
    mp.setattr(estimator, "STREAMING_ROW_CHUNK", CHUNK)
    mp.setattr(routing, "AUTO_DEVICE_PT_MIN_BYTES", 0)


def _fit() -> NeoLSSVM:
    return NeoLSSVM(device="cpu", random_state=7).fit(*_data())


@pytest.fixture(scope="module")
def two_traced_fits(tmp_path_factory):
    """Two fits under ``trace()``: their span records, the Chrome trace's events, and the
    arrays each fit pulled from the device."""
    pulled = []
    original = NeoLSSVM._set_fit_attributes

    def keep(self, result):
        pulled.append(result)
        return original(self, result)

    log_dir = tmp_path_factory.mktemp("spans")
    with pytest.MonkeyPatch.context() as mp:
        _streaming(mp)
        mp.setattr(NeoLSSVM, "_set_fit_attributes", keep)
        _fit()  # warm, untraced
        pulled.clear()
        profiling.clear_spans()
        with profiling.trace(log_dir):
            models = [_fit(), _fit()]
    assert all(m.pre_transform_ == "device" for m in models)
    (path,) = log_dir.glob("trace-*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if str(e.get("name", "")).startswith("neo.")]
    return profiling.spans(), events, pulled


def _trees(records: list[dict]) -> dict[int, list[dict]]:
    trees = collections.defaultdict(list)
    for record in records:
        trees[record["root"]].append(record)
    return dict(trees)


def test_no_profiler_no_span(monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _streaming(monkeypatch)
    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    profiling.clear_spans()
    _fit()
    assert profiling.spans() == [] and entered == []


def test_each_fit_records_one_tree_of_the_program_spans(two_traced_fits):
    records, _, _ = two_traced_fits
    trees = _trees(records)
    assert len(trees) == 2
    for root, tree in trees.items():
        by_name = {r["name"]: r for r in tree}
        assert sorted(r["name"] for r in tree) == sorted(PARENT)
        assert by_name["neo.fit"]["id"] == root and by_name["neo.fit"]["parent"] is None
        for name, parent in PARENT.items():
            record = by_name[name]
            if parent is not None:
                assert record["parent"] == by_name[parent]["id"], name
                assert by_name[parent]["t0_ns"] <= record["t0_ns"] <= record["t1_ns"] <= by_name[parent]["t1_ns"]
            assert record["host_ms"] == pytest.approx((record["t1_ns"] - record["t0_ns"]) / 1e6)
            assert record["device_ms"] is None  # a CPU fit has no device clock
        prologue = [by_name[n] for n in ("neo.fit.validate", "neo.fit.target", "neo.fit.stage")]
        assert by_name["neo.fit"]["t0_ns"] <= prologue[0]["t0_ns"]
        staging = [*prologue, by_name["neo.upload"], by_name["neo.fit.finite"], by_name["neo.pretransform"]]
        for earlier, later in zip(staging, staging[1:]):
            assert earlier["t1_ns"] <= later["t0_ns"]


def test_the_chrome_trace_holds_every_span_nested_alike(two_traced_fits):
    records, events, _ = two_traced_fits
    assert {e["name"] for e in events} == set(PARENT)
    occurrences = collections.defaultdict(list)
    for event in sorted(events, key=lambda e: e["ts"]):
        occurrences[event["name"]].append(event)
    assert all(len(found) == 2 for found in occurrences.values())
    for fit in range(2):
        for name, parent in PARENT.items():
            if parent is None:
                continue
            child, outer = occurrences[name][fit], occurrences[parent][fit]
            assert outer["ts"] <= child["ts"] and child["ts"] + child["dur"] <= outer["ts"] + outer["dur"], name


def test_the_pull_counts_the_bytes_it_pulls(two_traced_fits):
    records, _, pulled = two_traced_fits
    counted = [r["attrs"]["bytes"] for r in records if r["name"] == "neo.fit.pull"]
    assert counted == [sum(a.nbytes for a in result.values()) for result in pulled]
    assert all(n > ROWS * 4 for n in counted)


@pytest.mark.parametrize(
    ("transfer", "dtype", "expected"),
    [
        ("float32", np.float32, ROWS * COLUMNS * 4),
        ("float32", np.float64, ROWS * COLUMNS * 8),
        ("bfloat16", np.float32, ROWS * COLUMNS * 2),
        ("int8", np.float32, ROWS * COLUMNS + COLUMNS * 4),
    ],
)
def test_the_upload_counts_the_bytes_that_cross(transfer, dtype, expected):
    X = _data()[0].astype(dtype)
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = upload_rows(X, transfer, torch.device("cpu"))
    (record,) = profiling.spans()
    assert record["name"] == "neo.upload" and record["attrs"] == {"bytes": expected, "pad_rows": 0}
    assert out.dtype == torch.from_numpy(X).dtype and out.shape == X.shape


def test_the_upload_counts_the_rows_it_pads_on_the_device(two_traced_fits):
    records, _, _ = two_traced_fits
    padded = [r["attrs"]["pad_rows"] for r in records if r["name"] == "neo.upload"]
    assert padded == [(-ROWS) % CHUNK] * 2 and padded[0] > 0


def test_the_device_check_reads_every_row_once_per_fit(two_traced_fits):
    records, _, _ = two_traced_fits
    for tree in _trees(records).values():
        (validate,) = [r for r in tree if r["name"] == "neo.fit.validate"]
        (finite,) = [r for r in tree if r["name"] == "neo.fit.finite"]
        assert validate["attrs"] == {"host_scanned_bytes": 0}
        assert finite["attrs"] == {"bytes": ROWS * COLUMNS * 4}


# Each route of a NumPy fit: its parameters, its row count, and whether the device checks X.
_LANES = {
    "streaming": ({}, ROWS, True),
    "inmemory": ({}, ROWS, True),
    "host_pre_transform": ({"pre_transform": "host"}, ROWS, False),
    "dual": ({}, 400, False),
    "bfloat16": ({"transfer": "bfloat16"}, ROWS, False),
    "int8": ({"transfer": "int8"}, ROWS, False),
}


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_each_route_says_who_checked_x_for_nan_and_inf(lane, monkeypatch):
    params, rows, on_device = _LANES[lane]
    _streaming(monkeypatch)
    if lane != "streaming":
        monkeypatch.setattr(estimator, "STREAMING_BYTES_THRESHOLD", 6 * 1024**3)
    X, y = (a[:rows] for a in _data())
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model = NeoLSSVM(device="cpu", random_state=7, **params).fit(X, y)
    records = profiling.spans()
    assert model.dual_ == (lane == "dual")
    (validate,) = [r for r in records if r["name"] == "neo.fit.validate"]
    finite = [r for r in records if r["name"] == "neo.fit.finite"]
    (upload,) = [r for r in records if r["name"] == "neo.upload"] or [None]
    assert validate["attrs"] == {"host_scanned_bytes": 0 if on_device else X.nbytes}
    assert [r["attrs"] for r in finite] == ([{"bytes": X.nbytes}] if on_device else [])
    if lane in ("streaming", "inmemory"):
        assert upload["attrs"]["pad_rows"] == ((-rows) % CHUNK if lane == "streaming" else 0)


def test_the_buffer_keeps_its_bound_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_finished", collections.deque(maxlen=5))
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(8):
            with profiling.span("neo.test", index=i):
                pass
    assert [r["attrs"]["index"] for r in profiling.spans()] == [3, 4, 5, 6, 7]
    assert profiling.dropped_spans() == 3
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.dropped_spans() == 0


def test_annotate_is_a_span_and_holds_a_fit_in_its_tree(monkeypatch):
    _streaming(monkeypatch)
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), profiling.annotate("caller"):
        _fit()
    records = profiling.spans()
    (caller,) = [r for r in records if r["name"] == "caller"]
    (fit,) = [r for r in records if r["name"] == "neo.fit"]
    assert profiling.annotate is profiling.span
    assert fit["parent"] == caller["id"] and {r["root"] for r in records} == {caller["id"]}


def test_a_fit_is_bit_equal_with_the_profiler_on(monkeypatch, tmp_path):
    _streaming(monkeypatch)
    plain = _fit()
    with profiling.trace(tmp_path):
        traced = _fit()
    assert vars(plain).keys() == vars(traced).keys()
    for name, value in vars(plain).items():
        assert same(value, vars(traced)[name]), name
