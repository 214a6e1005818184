"""The traced window: ``torch.profiler`` over the window, read into a short summary.

Nothing of the trace is written to disk. The summary holds the device's busy seconds (the
union of the intervals in which a kernel, copy or fill ran, so two overlapping operations
count once), the window's length, the ten device operations that took the most time, and
the ten longest gaps between device operations, each named by what the host was doing at
its middle: the innermost ``bench.<probe>`` range and the innermost operation around it.
"""

import bisect
from typing import Any

import torch


def profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def _intervals(events: list, device: bool) -> list[tuple[int, int, str]]:
    out = []
    for e in events:
        on_device = e.device_type() != torch.autograd.DeviceType.CPU
        # A profiler range (``bench.<probe>``) is mirrored on the device's timeline as a
        # user annotation: it spans operations, it is none.
        if on_device and _is_annotation(e):
            continue
        if on_device == device and e.duration_ns() > 0:
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return sorted(out)


def _is_annotation(e: Any) -> bool:
    flag = getattr(e, "is_user_annotation", None)  # not in every PyTorch version
    return (flag is not None and flag()) or e.name().startswith("bench.")


def summarize(prof: torch.profiler.profile, window_s: float) -> dict[str, Any]:
    """busy_s, window_s, device_ops and idle_gaps of a finished profile."""
    events = prof.profiler.kineto_results.events()
    device = _intervals(events, device=True)
    host = _intervals(events, device=False)
    by_name: dict[str, float] = {}
    for start, end, name in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e9
    busy_ns, gaps = 0, []
    run_start = run_end = None
    for start, end, _ in device:
        if run_end is None or start > run_end:
            if run_end is not None:
                busy_ns += run_end - run_start
                gaps.append((start - run_end, run_end, start))
            run_start, run_end = start, end
        else:
            run_end = max(run_end, end)
    if run_end is not None:
        busy_ns += run_end - run_start
    gaps.sort(reverse=True)
    starts = [h[0] for h in host]
    named_gaps = []
    for length, g0, g1 in gaps[:10]:
        named_gaps.append([_host_at(host, starts, (g0 + g1) // 2), length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": window_s,
        "device_ops": [[name[:120], seconds] for name, seconds in ops],
        "idle_gaps": named_gaps,
    }


def _host_at(host: list[tuple[int, int, str]], starts: list[int], t: int) -> str:
    """'<innermost bench range> / <innermost host operation>' around time t."""
    covering = [h for h in host[: bisect.bisect_right(starts, t)] if h[1] >= t]
    if not covering:
        return "no host operation"
    spans = [h for h in covering if h[2].startswith("bench.")]
    ops = [h for h in covering if not h[2].startswith("bench.")]
    span = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "outside every probe"
    op = min(ops, key=lambda h: h[1] - h[0])[2] if ops else "python"
    return f"{span} / {op}"[:120]
