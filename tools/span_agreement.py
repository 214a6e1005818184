"""A fit cell's in-program spans beside the benchmark's outside probes, from one traced run.

    python3 tools/span_agreement.py --workload higgs.fit --seed 2147484111 --seconds 51

Runs the cell once as ``perfbench/run.py --trace 1`` does, with every probe of the fit
path in place, and prints one JSON line: the run's result (its per-layer metrics,
breakdown and verdict) and, for each layer timed both ways, the mean per fit of the
program's span (``neo_ls_svm_torch.utils.profiling.spans``) beside the probe's time for
the same work, and their ratio: the prologue's three host spans against
``fit.host_prologue_ms``; ``neo.upload``, ``neo.pretransform``, ``neo.solve.k1`` and
``neo.solve.k2`` against the probes ``upload``, ``pretransform``, ``k1`` and ``k2`` on the
device clock; ``neo.solve.eigh`` plus ``neo.solve.pass3`` against ``fit.solver_self_ms``.
Needs one CUDA device; ends with the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness, readers, spans  # noqa: E402

# Each pair: the span names summed, their clock, and the outside reading of the same work.
PAIRS = {
    "prologue": (("neo.fit.validate", "neo.fit.target", "neo.fit.stage"), "host", "fit.host_prologue_ms"),
    "upload": (("neo.upload",), "device", "upload"),
    "pretransform": (("neo.pretransform",), "device", "pretransform"),
    "k1": (("neo.solve.k1",), "device", "k1"),
    "k2": (("neo.solve.k2",), "device", "k2"),
    "eigh + pass3": (("neo.solve.eigh", "neo.solve.pass3"), "device", "fit.solver_self_ms"),
}


def agreement(cell: harness.Cell, seed: int, seconds: float, device) -> dict:
    """One traced run of the cell: its result, and each pair of ``PAIRS`` with its ratio. The
    cell's metrics put every probe of ``PAIRS`` in place; the run's context is kept from the
    harness's ``result`` for the probes' own times."""
    kept = {}
    result = harness.result

    def keep_context(ctx, metric_readers):
        kept["ctx"] = ctx
        return result(ctx, metric_readers)

    harness.result = keep_context
    try:
        out = harness.run_cell(cell, seed, seconds, True, device)
    finally:
        harness.result = result
    out.pop("also_read", None)
    found = spans.records()
    pairs = {}
    for pair, (names, clock, outside) in PAIRS.items():
        inside = [spans.mean_ms(found, name, clock) for name in names]
        if outside.startswith("fit."):
            theirs = out["metrics"].get(outside, {}).get("value")
        else:
            theirs = readers.mean_ms(readers.per_step(kept["ctx"], outside))
        ours = None if None in inside else sum(inside)
        ratio = ours / theirs if ours is not None and theirs else None
        pairs[pair] = {"spans_ms": ours, "outside_ms": theirs, "ratio": ratio}
    return {"workload": cell.name, "seed": seed, "pairs": pairs, "result": out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    args = parser.parse_args()

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    out = agreement(harness.load_cell(args.workload), args.seed, args.seconds, torch.device("cuda", 0))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=False
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
