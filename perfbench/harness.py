"""The benchmark's engine: it finds a cell's files by name and runs the cell once.

``BENCHMARK.json`` names each cell (a configuration under a traffic mix) and each metric.
Everything else is found by name under this folder:

- ``workloads/<cell>.json``: the limits of the numbers that decide ``correct``;
- ``configs/<config>.json``: the deployment's sizes, and the generator that makes its rows;
- ``datasets/<generator>.py``: ``make(config, seed, device, parts)``, rows from the seed;
- ``traffic/<traffic>.json``: the mix, whose ``kind`` names its driver;
- ``drivers/<kind>.py``: ``run(ctx)``, set-up, the measured window and the comparison;
- ``metrics/<metric>.py``: ``PROBES`` and ``read(run)``, one per-layer metric each;
- ``probes/<probe>.json``: a call into a layer of the program, timed from outside.

A later cell, mix, metric or probe is a new file; no file here needs an edit for it.
"""

import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that no run may hold once its window has closed: JAX and the
# JAX package, which the benchmark never measures.
FORBIDDEN_MODULES = frozenset({"jax", "jaxlib", "flax", "neo_ls_svm_tpu"})


def load_json(path: Path) -> Any:
    with path.open() as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """Import the Python file at ``path`` under a name of its own (file names may hold dots)."""
    name = "perfbench_file_" + "".join(c if c.isalnum() else "_" for c in str(path.relative_to(BENCH)))
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_loaded(modules: Any = None) -> list[str]:
    """The forbidden top-level names among the loaded modules, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN_MODULES)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _for_cell(metrics: list[dict], cell: str) -> list[dict]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = load_json(ROOT / "BENCHMARK.json") if spec is None else spec
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        msg = f"no workload {name!r} in BENCHMARK.json; there are {sorted(entries)}"
        raise KeyError(msg)
    entry = entries[name]
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config={"name": entry["config"], **config},
        traffic={"name": entry["traffic"], **traffic},
        limits=load_json(BENCH / "workloads" / f"{name}.json")["limits"],
        end_to_end=_for_cell(spec["end_to_end"], name),
        per_layer=_for_cell(spec["per_layer"], name),
    )


def process_age_s() -> float:
    """Seconds since this process started, from /proc (0 where there is none)."""
    try:
        stat = Path("/proc/self/stat").read_text()
        start_ticks = int(stat.rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclass
class Context:
    """What a driver gets: the cell, the seed, the window's length, whether to trace and the
    device; what it leaves: the window, its steps and records, its numbers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    step: int = -1  # the window's current fit; -1 in set-up
    records: list = field(default_factory=list)
    kept: dict = field(default_factory=dict)
    numbers: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    e2e: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    profile: dict | None = None

    @property
    def on_cuda(self) -> bool:
        return getattr(self.device, "type", str(self.device)).startswith("cuda")

    def sync(self) -> None:
        if self.on_cuda:
            import torch  # noqa: PLC0415

            torch.cuda.synchronize(self.device)


def install_probes(ctx: Context, names: set[str]) -> list:
    """Wrap each named probe's target; return what restores them."""
    from perfbench.probes_runtime import wrap  # noqa: PLC0415

    return [wrap(ctx, name, load_json(BENCH / "probes" / f"{name}.json")) for name in sorted(names)]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: Any) -> dict:
    """Run the cell once and return its result, the compared numbers last."""
    driver = load_module(BENCH / "drivers" / f"{cell.traffic['kind']}.py")
    readers = {m["name"]: load_module(BENCH / "metrics" / f"{m['name']}.py") for m in cell.per_layer} if trace else {}
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device)
    probes = set(getattr(driver, "PROBES", ()))
    for reader in readers.values():
        probes |= set(reader.PROBES)
    restore = install_probes(ctx, probes)
    try:
        driver.run(ctx)
    finally:
        for undo in restore:
            undo()
    return result(ctx, readers)


def verdict(numbers: dict, limits: dict, failed: int = 0) -> tuple[bool, dict]:
    """Whether a run is correct, and each number compared beside its limit: no step failed,
    and every number that the cell limits is there, finite and within its limit."""
    compared = {name: {"value": numbers[name], "limit": limits[name]} for name in limits if name in numbers}
    correct = (
        failed == 0
        and bool(compared)
        and set(compared) == set(limits)
        and all(
            c["limit"] is not None and isinstance(c["value"], float) and math.isfinite(c["value"])
            and c["value"] <= c["limit"]
            for c in compared.values()
        )
    )
    return correct, compared


def result(ctx: Context, readers: dict) -> dict:
    """The result line's object from what the driver left."""
    from perfbench.probes_runtime import resolve_times  # noqa: PLC0415

    limits = ctx.cell.limits
    correct, compared = verdict(ctx.numbers, limits, ctx.failed)
    if ctx.trace:
        resolve_times(ctx.records)
        metrics = {}
        for m in ctx.cell.per_layer:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx.e2e[m["name"]], "unit": m["unit"]} for m in ctx.cell.end_to_end if m["name"] in ctx.e2e}
    device = {
        "platform": "gpu" if ctx.on_cuda else "cpu",
        "kind": _device_kind(ctx),
        "count": ctx.cell.chips if ctx.on_cuda else 1,
        "memory_peak_bytes": ctx.memory_peak_bytes,
    }
    out = {"correct": correct, "attempted": ctx.attempted, "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.profile is not None:
        device["busy_s"] = ctx.profile["busy_s"]
        device["window_s"] = ctx.profile["window_s"]
        out["breakdown"] = {"device_ops": ctx.profile["device_ops"], "idle_gaps": ctx.profile["idle_gaps"]}
    out["also_read"] = {name: v for name, v in ctx.numbers.items() if name not in limits}
    out["compared"] = compared
    return out


def _device_kind(ctx: Context) -> str:
    if not ctx.on_cuda:
        return "cpu"
    import torch  # noqa: PLC0415

    return torch.cuda.get_device_name(ctx.device)
