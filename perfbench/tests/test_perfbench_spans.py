"""The readers of the program's spans (``perfbench/spans.py``, ``metrics/fit.*``) on hand-made
span records: means over the fits, grouped by ``root``, and GB/s from bytes and device time.
A reader gives None where there are no spans or no device times, so that its metric is left
out of the result of a run on the CPU or of a program without spans."""

import sys

import pytest

from perfbench import harness, spans

MS = {  # reader → (span, clock)
    "fit.validate_ms": ("neo.fit.validate", "host"),
    "fit.target_ms": ("neo.fit.target", "host"),
    "fit.stage_ms": ("neo.fit.stage", "host"),
    "fit.normalizer_ms": ("neo.pretransform.normalizer", "device"),
    "fit.eigh_ms": ("neo.solve.eigh", "device"),
    "fit.pass3_ms": ("neo.solve.pass3", "device"),
    "fit.pull_ms": ("neo.fit.pull", "device"),
}
GBPS = {"fit.upload_gbps": "neo.upload", "fit.pull_gbps": "neo.fit.pull"}


def record(name: str, root: int, host_ms: float, device_ms: float | None, **attrs) -> dict:
    return {"name": name, "id": 0, "parent": root, "root": root, "host_ms": host_ms, "device_ms": device_ms, "attrs": attrs}


def reader(name: str):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def read_with(monkeypatch, name: str, found: list[dict]):
    monkeypatch.setattr(spans, "records", lambda: found)
    return reader(name).read(None)


@pytest.mark.parametrize("name", sorted(MS))
def test_a_time_is_the_mean_over_fits_of_each_fits_sum(monkeypatch, name):
    span, clock = MS[name]
    found = [
        # fit 1 holds the span twice (summed), fit 2 once; another span is not read
        record(span, 1, host_ms=1.0, device_ms=10.0),
        record(span, 1, host_ms=2.0, device_ms=20.0),
        record(span, 2, host_ms=5.0, device_ms=50.0),
        record("neo.other", 2, host_ms=100.0, device_ms=100.0),
    ]
    expected = {"host": (3.0 + 5.0) / 2, "device": (30.0 + 50.0) / 2}[clock]
    assert read_with(monkeypatch, name, found) == pytest.approx(expected)
    assert read_with(monkeypatch, name, found[3:]) is None
    if clock == "device":  # a run on the CPU has no device times
        assert read_with(monkeypatch, name, [record(span, 1, host_ms=1.0, device_ms=None)]) is None


@pytest.mark.parametrize("name", sorted(GBPS))
def test_a_rate_is_the_summed_bytes_over_the_summed_device_time(monkeypatch, name):
    span = GBPS[name]
    found = [
        record(span, 1, host_ms=9.0, device_ms=100.0, bytes=2 * 10**9),
        record(span, 2, host_ms=9.0, device_ms=300.0, bytes=6 * 10**9),
        record("neo.other", 2, host_ms=1.0, device_ms=1.0, bytes=10**12),
    ]
    assert read_with(monkeypatch, name, found) == pytest.approx(8e9 / 0.4 / 1e9)
    assert read_with(monkeypatch, name, found[2:]) is None
    assert read_with(monkeypatch, name, [record(span, 1, host_ms=9.0, device_ms=None, bytes=10)]) is None
    assert read_with(monkeypatch, name, [record(span, 1, host_ms=9.0, device_ms=5.0)]) is None


def test_a_program_without_spans_gives_no_records(monkeypatch):
    import neo_ls_svm_torch.utils.profiling  # noqa: PLC0415

    monkeypatch.delattr(neo_ls_svm_torch.utils.profiling, "spans")
    assert spans.records() == []
    monkeypatch.setitem(sys.modules, "neo_ls_svm_torch.utils.profiling", None)
    assert spans.records() == []
    for name in [*MS, *GBPS]:
        assert reader(name).PROBES == () and reader(name).read(None) is None


def test_a_traced_cpu_run_reads_the_host_spans_and_leaves_out_the_device_ones(small_streaming_fits):
    from neo_ls_svm_torch.utils import profiling  # noqa: PLC0415

    from perfbench.tests.test_perfbench_reference import CPU  # noqa: PLC0415

    profiling.clear_spans()
    cell = harness.load_cell("msd.fit")
    cell.config.update(n_train=3000, n_test=256)
    out = harness.run_cell(cell, 2**31 + 99, 0.5, True, CPU)
    host = {"fit.validate_ms", "fit.target_ms", "fit.stage_ms"}
    assert host <= set(out["metrics"]) and all(out["metrics"][m]["value"] > 0 for m in host)
    assert not (set(MS) - host | set(GBPS)) & set(out["metrics"])
    parts = sum(out["metrics"][m]["value"] for m in host)
    assert parts <= out["metrics"]["fit.host_prologue_ms"]["value"]
