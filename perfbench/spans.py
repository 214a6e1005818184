"""The program's own spans (``neo_ls_svm_torch.utils.profiling.spans``), read by fit.

The spans of one fit share a ``root``: the id of its ``neo.fit`` span. A reader takes the
mean over the window's fits of one span's host or device milliseconds, or a copy rate from
a span's ``bytes`` attribute over its device time. A program that records no such span (one
without spans), or a run with no device time (on the CPU), gives None, and the metric is
left out of the result.
"""

import statistics
from typing import Any


def records() -> list[dict[str, Any]]:
    """The finished spans the program holds, or none where it has no spans."""
    try:
        from neo_ls_svm_torch.utils.profiling import spans  # noqa: PLC0415
    except ImportError:
        return []
    return spans()


def mean_ms(found: list[dict[str, Any]], name: str, clock: str) -> float | None:
    """The mean over the fits of the summed ``<clock>_ms`` (``host`` or ``device``) of the
    spans called ``name``."""
    per_fit: dict[int, float] = {}
    for record in found:
        if record["name"] != name:
            continue
        ms = record.get(f"{clock}_ms")
        if ms is None:
            return None
        per_fit[record["root"]] = per_fit.get(record["root"], 0.0) + ms
    return statistics.fmean(per_fit.values()) if per_fit else None


def gbps(found: list[dict[str, Any]], name: str) -> float | None:
    """GB/s over the spans called ``name``: their summed ``bytes`` over their summed device
    seconds."""
    named = [r for r in found if r["name"] == name]
    if not named or any(r.get("device_ms") is None or "bytes" not in r["attrs"] for r in named):
        return None
    seconds = sum(r["device_ms"] for r in named) / 1e3
    return sum(r["attrs"]["bytes"] for r in named) / seconds / 1e9 if seconds > 0 else None
