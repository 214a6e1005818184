"""The readings that an in-memory fit cell's limits are set from, on the chip at the cell's size.

    python3 perfbench/calibrate_inmemory.py --workload msd32.fit --seeds 11 12 ... [--controls 3] [--faults 3] [--rows N]

``calibrate.py`` for a cell of kind ``fit_inmemory``: each reading is held to the float64
reference by that driver's comparison (``drivers/fit_inmemory.py``: the Gram as its real
embedding, the sweep's operands as the in-memory solver forms them). For each seed: the
cell's rows, one fit of the program as the cell's traffic makes it, and its numbers. On the
first ``--controls`` seeds also the controls: the reference in the precision below the one
the configuration states, put in the program's place, and the program on its own
lower-precision path (``precision="fast"`` for float32 rows: the in-memory sweep's two
contractions in one TF32 pass). For float32 rows a third control reads ``scale_err`` alone:
the reference normalizer on the rows rounded to TF32 (:func:`tf32_rows`), since the normalizer's
medians are found by comparing the rows' values, and a TF32 product touches none of that. On the
first ``--faults`` seeds, the program with each fault of ``faults_inmemory.py`` planted. Each reading carries ``correct`` as the cell's own
comparison (``harness.verdict``) judges it. One JSON line per reading on stdout and in
``chiprun_out/calibrate_inmemory.jsonl``. ``--rows`` cuts the training rows; the limits are
set from full-size readings only.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import faults_inmemory, fitcheck, harness  # noqa: E402
from perfbench.calibrate import PROGRAM_CONTROL  # noqa: E402
from perfbench.drivers import fit_inmemory  # noqa: E402
from perfbench.reference import lssvm, normalizer  # noqa: E402

# The control that reads the normalizer alone, and the number it reads.
ROWS_CONTROL, ROWS_CONTROL_NUMBER = "control_tf32_rows", "scale_err"


def tf32_rows(X: np.ndarray) -> np.ndarray:
    """float32 rows rounded to TF32's 10 stored mantissa bits, to the nearest and ties to even:
    the operands as a TF32 product reads them (float16's precision in float32's range)."""
    bits = np.ascontiguousarray(X, dtype=np.float32).view(np.uint32)
    odd = (bits >> np.uint32(13)) & np.uint32(1)
    return ((bits + np.uint32(0xFFF) + odd) & np.uint32(0xFFFFE000)).view(np.float32)


def rows_control(X: np.ndarray, ref: fitcheck.Reference, mode: str, device) -> dict[str, float]:
    """``scale_err`` of the reference normalizer in ``mode`` on the rows rounded to TF32,
    by ``fitcheck``'s definition: shift and scale off the float64 reference's, over |scale|."""
    shift, scale = normalizer.normalizer(
        tf32_rows(X), ref.y_signed, is_classifier=ref.is_classifier, mode=mode, device=device
    )
    scale_r = np.abs(ref.scale)
    return {ROWS_CONTROL_NUMBER: float(max(np.max(np.abs(shift - ref.shift) / scale_r),
                                           np.max(np.abs(scale - ref.scale) / scale_r)))}


def _fit(ctx: harness.Context, X, y, params: dict, fault: str | None) -> tuple:
    """One fit with its candidate; the fault, if any, planted under the probes, so that they
    keep what the broken entry answers."""
    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415

    with faults_inmemory.planted(fault) if fault else contextlib.nullcontext():
        restore = harness.install_probes(ctx, set(fit_inmemory.PROBES))
        try:
            t0 = time.perf_counter()
            model = NeoLSSVM(device=ctx.device, **params).fit(X, y)
            fit_s = time.perf_counter() - t0
        finally:
            for undo in restore:
                undo()
    route, swept = fit_inmemory.taken_answer(ctx.kept)
    step = fitcheck.pulled(fitcheck.step_outputs(model, swept))
    del swept
    gram, operands = fit_inmemory.last_fit_operands(route, ctx.kept)
    candidate = fitcheck.program_outputs(model, gram, operands, [step])
    ctx.kept.clear()
    return model, candidate, fit_s, route


def readings(cell: harness.Cell, seed: int, device, controls: bool, plant: bool = False) -> list[dict]:
    """The program's numbers on one seed; with ``controls`` the controls' and with ``plant``
    each fault's. Each reading holds ``correct`` by the cell's limits and the route its fit
    took."""
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
        runs += [(f"fault_{name}", estimator, name) for name in sorted(faults_inmemory.FAULTS)]
    found, ref = [], None
    for name, params, fault in runs:
        model, candidate, fit_s, route = _fit(ctx, X, y, params, fault)
        if ref is None:  # every run draws the same pre-transform: one reference
            setting = fitcheck.setting(model)
            is_classifier = model._estimator_type == "classifier"
            M, b = candidate["M"], candidate["b"]
            ref = fitcheck.Reference(X, y, is_classifier, setting, M, b, device=device)
        del model
        found.append({"reading": name, "seed": seed, "route": route, "fit_s": fit_s,
                      **fit_inmemory.numbers(candidate, ref)})
    if controls:
        mode = fitcheck.CONTROL_MODE[dtype]
        control = fitcheck.control_outputs(X, y, is_classifier, setting, M, b, mode=mode, device=device)
        with lssvm.arithmetic(mode) as control_dtype:  # the control's Gram, embedded in its own arithmetic
            control["gram"] = fit_inmemory.embedded(torch.from_numpy(control["gram"]).to(control_dtype))
        found.append({"reading": f"control_{mode}", "seed": seed, **fit_inmemory.numbers(control, ref)})
        if dtype == "float32":
            found.append({"reading": ROWS_CONTROL, "seed": seed, **rows_control(X, ref, mode, device)})
    for reading in found:
        limits = cell.limits
        if reading["reading"] == ROWS_CONTROL:  # judged on the one number it reads
            limits = {ROWS_CONTROL_NUMBER: limits[ROWS_CONTROL_NUMBER]}
        reading["correct"] = harness.verdict(reading, limits)[0]
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", type=int, default=0)
    parser.add_argument("--rows", type=int, default=None)
    args = parser.parse_args()
    cell = harness.load_cell(args.workload)
    if args.rows is not None:
        cell.config["n_train"] = args.rows
    device = torch.device("cuda", 0)
    log = harness.ROOT / "chiprun_out" / "calibrate_inmemory.jsonl"
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
