"""Profiling helpers: a trace context, and the spans the program records inside it.

The port's counterpart of ``neo_ls_svm_tpu.utils.profiling``. :func:`trace` captures a
``torch.profiler`` trace around any region of user code and writes it into ``log_dir`` as
a Chrome trace (JSON), which ui.perfetto.dev and ``chrome://tracing`` open. It holds the
host's operators, and the device's kernels where CUDA is present.

:func:`span` names a region. While a ``torch.profiler`` records (:func:`trace`, or the
caller's own profiler), a span is a ``record_function`` range in that trace, on the clock
of the device's operations, and a record in a bounded in-memory buffer that
:func:`spans` reads: its host milliseconds and, for a span given a CUDA ``device``, its
milliseconds on that device's current stream. With no profiler running a span costs one
flag check and records nothing. ``NeoLSSVM.fit`` opens its own spans, all named
``neo.*`` (README, "Profiling a fit")::

    from neo_ls_svm_torch.utils.profiling import annotate, clear_spans, spans, trace
    clear_spans()
    with trace("neo_trace"):
        with annotate("my_fit"):
            model.fit(X, y)
    torch.cuda.synchronize()
    for record in spans():
        print(record["name"], record["host_ms"], record["device_ms"], record["attrs"])
"""

import collections
import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections.abc import Iterator
from pathlib import Path
from typing import Any

import torch
from torch.autograd import profiler as _autograd_profiler

# The buffer of finished spans: the newest SPAN_BUFFER_SIZE are kept, older ones dropped
# and counted. A fit records 14.
SPAN_BUFFER_SIZE = 16384
_finished: collections.deque = collections.deque(maxlen=SPAN_BUFFER_SIZE)
_dropped = 0
_lock = threading.Lock()  # the buffer's append and its count of drops, as one step
_ids = itertools.count(1)
# The innermost open span of this thread or task: each new span's parent.
_open: contextvars.ContextVar[dict | None] = contextvars.ContextVar("neo_open_span", default=None)


@contextlib.contextmanager
def trace(log_dir: "str | os.PathLike[str]") -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace (host, and device where CUDA is present) into
    ``log_dir`` as ``trace-<pid>-<ns>.json``. Yields the profiler, whose
    ``key_averages()`` sums the trace by operator and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    profiler = torch.profiler.profile(activities=activities)
    try:
        with profiler:
            yield profiler
    finally:
        profiler.export_chrome_trace(str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


def span(name: str, *, device: "torch.device | str | None" = None, **attrs: Any) -> Any:
    """``with span("phase", device=dev, key=value) as attrs: ...``: a named region.

    It records only while a ``torch.profiler`` records; otherwise it is an empty context.
    A recording span is a ``record_function(name)`` range in the profiler's trace, and on
    exit a record in the buffer that :func:`spans` reads: ``name``; ``id``; ``parent``, the
    id of the span open around it (None at the outermost); ``root``, the outermost one's
    id (a fit's ``neo.fit``); ``t0_ns`` and ``t1_ns`` (``time.perf_counter_ns``);
    ``host_ms``; ``attrs``. A CUDA ``device`` adds a pair of timing events on its current
    stream, with no synchronise, which :func:`spans` turns into ``device_ms``. The context
    yields ``attrs``: what is set in it inside the region is recorded too. A region that
    raises leaves no record.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return contextlib.nullcontext(attrs)
    return _recording(name, device, attrs)


annotate = span
"""A region of the caller's own: ``with annotate("phase"): ...`` is :func:`span` with no
device, so the caller's regions and the program's nest in one tree."""


@contextlib.contextmanager
def _recording(name: str, device: Any, attrs: dict) -> Iterator[dict]:
    global _dropped
    parent = _open.get()
    record: dict[str, Any] = {"name": name, "id": next(_ids)}
    record["parent"] = None if parent is None else parent["id"]
    record["root"] = record["id"] if parent is None else parent["root"]
    stream = events = None
    if device is not None and torch.device(device).type == "cuda":
        stream = torch.cuda.current_stream(torch.device(device))
        events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    token = _open.set(record)
    with torch.profiler.record_function(name):
        if events is not None:
            events[0].record(stream)
        record["t0_ns"] = time.perf_counter_ns()
        try:
            yield attrs
        finally:
            record["t1_ns"] = time.perf_counter_ns()
            if events is not None:
                events[1].record(stream)
            _open.reset(token)
    record["host_ms"] = (record["t1_ns"] - record["t0_ns"]) / 1e6
    record["attrs"] = attrs
    record["events"] = events
    with _lock:
        if len(_finished) == _finished.maxlen:
            _dropped += 1
        _finished.append(record)


def spans() -> list[dict[str, Any]]:
    """The finished spans in the buffer, oldest first, each with ``device_ms`` (None for a
    span with no CUDA device). Reading a span's device time waits for its end event: call
    this once the device has finished the regions."""
    out = []
    for record in list(_finished):
        events = record.pop("events", None)
        if events is not None:
            events[1].synchronize()
            record["device_ms"] = events[0].elapsed_time(events[1])
        record.setdefault("device_ms", None)
        out.append(dict(record))
    return out


def dropped_spans() -> int:
    """How many finished spans the full buffer has dropped since the last :func:`clear_spans`."""
    return _dropped


def clear_spans() -> None:
    """Empty the buffer of finished spans and reset the count of dropped ones."""
    global _dropped
    with _lock:
        _finished.clear()
        _dropped = 0
