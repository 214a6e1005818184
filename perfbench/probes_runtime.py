"""Wrappers around the program's calls into its layers, put in place from outside.

A probe file ``probes/<name>.json`` names its target as ``module:attribute`` (an attribute
may be ``Class.method``): the name under which the caller looks the callee up, so that
the wrapper sits on the path the program takes. Each call appends a record: the probe,
the window's step (fit) it fell in, its host clock at entry and exit, its
tensors' shapes and its scalar keyword arguments, and, when the run traces, a pair of
CUDA events around it, recorded on the current stream with no added synchronise, and a
``torch.profiler`` range named ``bench.<probe>``. With ``"keep": true`` the output of the
latest call is kept for the comparison after the window, and with ``"keep_args"`` (names to
positions) the arguments at those positions, under ``<probe>.args``.
"""

import functools
import importlib
import time
from typing import Any


def _shape(value: Any) -> list[int] | None:
    shape = getattr(value, "shape", None)
    return None if shape is None else [int(s) for s in shape]


def wrap(ctx: Any, name: str, spec: dict) -> Any:
    """Put the probe ``name`` in place; return the function that takes it out."""
    module_name, attr_path = spec["target"].split(":")
    owner: Any = importlib.import_module(module_name)
    *parents, attr = attr_path.split(".")
    for part in parents:
        owner = getattr(owner, part)
    original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    keep, device_clock = bool(spec.get("keep", False)), spec.get("clock") == "device"
    keep_args = spec.get("keep_args", {})

    @functools.wraps(original)
    def probe(*args: Any, **kwargs: Any) -> Any:
        record = {"probe": name, "step": ctx.step}
        if ctx.trace:
            import torch  # noqa: PLC0415

            record["shapes"] = [_shape(a) for a in args]
            record["dtype"] = str(getattr(args[0], "dtype", "")) if args else ""
            record["kw"] = {k: v for k, v in kwargs.items() if isinstance(v, (bool, int, float, str))}
            scope = torch.profiler.record_function(f"bench.{name}")
            scope.__enter__()
            if device_clock and ctx.on_cuda:
                record["events"] = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                record["events"][0].record()
        record["t0"] = time.perf_counter()
        try:
            out = original(*args, **kwargs)
        finally:
            record["t1"] = time.perf_counter()
            if ctx.trace:
                if "events" in record:
                    record["events"][1].record()
                scope.__exit__(None, None, None)
        if ctx.step >= 0:
            ctx.records.append(record)
        if keep:
            ctx.kept[name] = out
        if keep_args:
            ctx.kept[f"{name}.args"] = {arg: args[i] for arg, i in keep_args.items()}
        return out

    setattr(owner, attr, probe)
    return lambda: setattr(owner, attr, original)


def resolve_times(records: list[dict]) -> None:
    """Give every record ``ms``: its events' device time where it has events, else its host
    time. Call once the device has finished."""
    for record in records:
        events = record.pop("events", None)
        record["host_ms"] = (record["t1"] - record["t0"]) * 1e3
        record["ms"] = events[0].elapsed_time(events[1]) if events is not None else record["host_ms"]


def by_step(records: list[dict], probe: str) -> dict[int, list[dict]]:
    """The records of one probe, grouped by the step they fell in."""
    out: dict[int, list[dict]] = {}
    for record in records:
        if record["probe"] == probe:
            out.setdefault(record["step"], []).append(record)
    return out
