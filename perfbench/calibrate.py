"""The readings that a fit cell's limits are set from, on the chip at the cell's size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... [--controls 3] [--faults 3] [--rows N]

For each seed: the cell's rows, one fit of the program as the cell's traffic makes it, and
the float64 reference; the program's numbers (``fitcheck``). On the first ``--controls``
seeds also the control: the reference in the precision below the one the configuration
states (TF32 for float32 rows, IEEE float32 for float64 rows), put in the program's place,
and, where the program has a lower-precision path of its own (``precision="fast"`` for
float32 rows), the program on that path. On the first ``--faults`` seeds, the program with
each fault of ``faults.py`` planted. Each reading carries ``correct`` as the cell's own
comparison (``harness.verdict``) judges it. One JSON line per reading on stdout and in
``chiprun_out/calibrate.jsonl``. ``--rows`` cuts the training rows (the kept test's size);
the limits are set from full-size readings only.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import faults, fitcheck, harness  # noqa: E402

# The program's own path in the precision below the configuration's, where it has one.
PROGRAM_CONTROL = {"float32": {"precision": "fast"}}


def _fit(ctx: harness.Context, X, y, params: dict, fault: str | None) -> tuple:
    """One fit with its candidate; the fault, if any, planted under the probes, so that
    they keep what the broken entry answers."""
    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415

    with faults.planted(fault) if fault else contextlib.nullcontext():
        restore = harness.install_probes(ctx, {"k1", "k2"})
        try:
            t0 = time.perf_counter()
            model = NeoLSSVM(device=ctx.device, **params).fit(X, y)
            fit_s = time.perf_counter() - t0
        finally:
            for undo in restore:
                undo()
    step = fitcheck.pulled(fitcheck.step_outputs(model, ctx.kept["k2"]))
    operands = fitcheck.sweep_operands(ctx.kept["k2.args"])
    candidate = fitcheck.program_outputs(model, ctx.kept["k1"].double().cpu().numpy(), operands, [step])
    ctx.kept.clear()
    return model, candidate, fit_s


def readings(cell: harness.Cell, seed: int, device, controls: bool, plant: bool = False) -> list[dict]:
    """The program's numbers on one seed; with ``controls`` the controls' and with
    ``plant`` each fault's. Each reading holds ``correct`` by the cell's limits."""
    from perfbench.drivers.fit import make_rows  # noqa: PLC0415

    ctx = harness.Context(cell=cell, seed=seed, seconds=0, trace=False, device=device)
    rows = make_rows(ctx, ("train",))
    X, y = rows["X"], rows["y"]
    dtype = cell.config["dtype"]
    estimator = cell.traffic.get("estimator", {})
    runs = [("program", estimator, None)]
    if controls and dtype in PROGRAM_CONTROL:
        runs.append(("program_lower_path", {**estimator, **PROGRAM_CONTROL[dtype]}, None))
    if plant:
        runs += [(f"fault_{name}", estimator, name) for name in sorted(faults.FAULTS)]
    found, ref = [], None
    for name, params, fault in runs:
        model, candidate, fit_s = _fit(ctx, X, y, params, fault)
        if ref is None:  # every run draws the same pre-transform: one reference
            setting = fitcheck.setting(model)
            is_classifier = model._estimator_type == "classifier"
            M, b = candidate["M"], candidate["b"]
            ref = fitcheck.Reference(X, y, is_classifier, setting, M, b, device=device)
        del model
        found.append({"reading": name, "seed": seed, "fit_s": fit_s, **fitcheck.numbers(candidate, ref)})
    if controls:
        mode = fitcheck.CONTROL_MODE[dtype]
        control = fitcheck.control_outputs(X, y, is_classifier, setting, M, b, mode=mode, device=device)
        found.append({"reading": f"control_{mode}", "seed": seed, **fitcheck.numbers(control, ref)})
    for reading in found:
        reading["correct"] = harness.verdict(reading, cell.limits)[0]
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--rows", type=int, default=None)
    args = parser.parse_args()
    import torch  # noqa: PLC0415

    cell = harness.load_cell(args.workload)
    if args.rows is not None:
        cell.config["n_train"] = args.rows
    device = torch.device("cuda", 0)
    log = harness.ROOT / "chiprun_out" / "calibrate.jsonl"
    log.parent.mkdir(exist_ok=True)
    for i, seed in enumerate(args.seeds):
        for reading in readings(cell, seed, device, controls=i < args.controls, plant=i < args.faults):
            line = json.dumps({"workload": cell.name, "rows": cell.config["n_train"], **reading})
            print(line, flush=True)
            with log.open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
