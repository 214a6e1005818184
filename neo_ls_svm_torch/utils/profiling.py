"""Profiling helpers.

The port's counterpart of ``neo_ls_svm_tpu.utils.profiling``: a context that captures a
``torch.profiler`` trace around any region of user code, and an annotation for naming a
region inside it::

    from neo_ls_svm_torch.utils.profiling import annotate, trace
    with trace("neo_trace"):
        with annotate("fit"):
            model.fit(X, y)

On exit the trace is written into ``log_dir`` as a Chrome trace (JSON), which
ui.perfetto.dev and ``chrome://tracing`` open. It holds the host's operators, and the
device's kernels where CUDA is present.
"""

import contextlib
import os
import time
from collections.abc import Iterator
from pathlib import Path

import torch


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


annotate = torch.profiler.record_function
"""Host-side annotation context manager: ``with annotate("phase"): ...``."""
