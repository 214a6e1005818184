"""The in-memory fit cell (``msd32.fit``, traffic of kind ``fit_inmemory``) on the CPU at a cut
size: a whole run is correct and every fit takes the in-memory solver; a fit that streams is
held to the same reference; each fault of ``faults_inmemory.py`` fails its number; and the
readers of the in-memory metrics read the program's spans and the solver's shapes, and nothing
where there is nothing to read."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfbench import faults_inmemory, harness, readers_inmemory, spans, yardstick
from perfbench.tests.test_perfbench_reference import CPU

CELL = "msd32.fit"
# Training rows of the cut run: the in-memory route and the device pre-transform, as the cell
# runs them at 463,715 rows; at 12,000 rows the sweep's chunks hold a few MB.
ROWS = 12000


@pytest.fixture
def small_inmemory_fits(monkeypatch: pytest.MonkeyPatch) -> None:
    """Make a fit of a few thousand rows take the cell's route: the device pre-transform (whose
    payload threshold the cut rows are under) and the in-memory solver."""
    from neo_ls_svm_torch.models import routing  # noqa: PLC0415

    monkeypatch.setattr(routing, "AUTO_DEVICE_PT_MIN_BYTES", 0)


def cut_run(capsys, seconds: float = 0.5) -> tuple[dict, str]:
    """A whole run of the cell on the CPU at ``ROWS`` training rows, and what it printed."""
    cell = harness.load_cell(CELL)
    cell.config.update(n_train=ROWS, n_test=256)
    out = harness.run_cell(cell, 2**31 + 99, seconds, False, CPU)
    return out, capsys.readouterr().err


def test_a_cut_cpu_run_is_correct_on_the_inmemory_route(small_inmemory_fits, capsys):
    out, printed = cut_run(capsys)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert f"fits in the window by route: {{'inmemory': {out['attempted']}}}" in printed
    assert "'k1.3xtf32-wgmma': 0" in printed and "'k2.3xtf32-wgmma': 0" in printed
    e2e = {m["name"] for m in harness.load_cell(CELL).end_to_end}
    assert set(out["metrics"]) == e2e == {"fit_s", "setup_s"}


def test_a_fit_that_streams_is_held_to_the_same_reference(small_streaming_fits, capsys):
    out, printed = cut_run(capsys)
    assert f"fits in the window by route: {{'streaming': {out['attempted']}}}" in printed
    assert out["correct"] is True and set(out["compared"]) == set(harness.load_cell(CELL).limits)


@pytest.mark.parametrize("fault", sorted(faults_inmemory.FAULTS))
def test_a_broken_inmemory_fit_is_not_correct(fault, small_inmemory_fits, capsys):
    with faults_inmemory.planted(fault) as number:
        out, _ = cut_run(capsys, seconds=0.0)
    assert out["correct"] is False
    assert out["compared"][number]["value"] > out["compared"][number]["limit"]


def test_tf32_rows_keep_ten_mantissa_bits_rounded_to_the_nearest():
    from perfbench.calibrate_inmemory import tf32_rows  # noqa: PLC0415

    ulp = 2.0**-10
    X = np.array([1 + ulp / 2, 1 + 3 * ulp / 2, 1 + ulp / 2 + 2.0**-20, -(1 + 3 * ulp / 4), 2000.0 + 0.9], np.float32)
    rounded = tf32_rows(X)
    # ties go to the even neighbour; 2000.9 lies 0.1 from the 1-wide grid of TF32 at 2^10..2^11
    assert rounded.tolist() == [1.0, 1 + 2 * ulp, 1 + ulp, -(1 + ulp), 2001.0]
    assert rounded.dtype == np.float32 and not (rounded.view(np.uint32) & 0x1FFF).any()


def test_the_normalizer_on_tf32_rows_reads_scale_err_above_its_limit():
    """The upper reading of ``scale_err``: the reference normalizer on the cell's rows rounded
    to TF32 lies more than three times the limit from the float64 normalizer (cut rows)."""
    from perfbench.calibrate_inmemory import rows_control  # noqa: PLC0415
    from perfbench.drivers.fit import make_rows  # noqa: PLC0415
    from perfbench.reference import lssvm, normalizer  # noqa: PLC0415

    cell = harness.load_cell(CELL)
    cell.config.update(n_train=ROWS, n_test=256)
    rows = make_rows(harness.Context(cell=cell, seed=2**31 + 99, seconds=0, trace=False, device=CPU), ("train",))
    y_signed = lssvm.signed_target(rows["y"], False, np.float64)
    shift, scale = normalizer.normalizer(rows["X"], y_signed, is_classifier=False, mode="f64", device=CPU)
    ref = SimpleNamespace(y_signed=y_signed, is_classifier=False, shift=shift, scale=scale)
    assert rows_control(rows["X"], ref, "tf32", CPU)["scale_err"] > 3 * cell.limits["scale_err"]


# A traced window's records as the harness leaves them: two in-memory fits of the cell's shapes.
SHAPES = {"n": 463715, "d": 90, "D": 512, "G": 1024}
PEAKS = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]


class Window:
    def __init__(self, dtype: str = "torch.float32", window_s: float = 0.6) -> None:
        call = {"probe": readers_inmemory.PROBE, "dtype": dtype, "kw": {"num_samples": SHAPES["n"]},
                "shapes": [[SHAPES["n"], SHAPES["d"]], [SHAPES["d"], SHAPES["D"]], [SHAPES["D"]], [SHAPES["n"]],
                           [SHAPES["n"]], [SHAPES["G"]], None]}
        self.records = [{**call, "step": 0}, {**call, "step": 1}, {"probe": "upload", "step": 0}]
        self.window_s = window_s


def span(name: str, root: int, device_ms: float | None) -> dict:
    return {"name": name, "id": 0, "parent": root, "root": root, "host_ms": 1.0, "device_ms": device_ms, "attrs": {}}


def reader(name: str):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


@pytest.mark.parametrize("step", ["gram", "sweep", "optimum"])
def test_a_step_time_is_the_mean_over_fits_of_its_span(monkeypatch, step):
    found = [span(f"neo.solve.{step}", 1, 10.0), span(f"neo.solve.{step}", 2, 30.0), span("neo.solve.eigh", 2, 99.0)]
    monkeypatch.setattr(spans, "records", lambda: found)
    assert reader(f"inmem.{step}_ms").read(None) == pytest.approx(20.0)
    monkeypatch.setattr(spans, "records", lambda: found[2:])
    assert reader(f"inmem.{step}_ms").read(None) is None


@pytest.mark.parametrize(
    ("name", "step", "work"),
    [
        ("inmem.gram.roofline.f32", "gram", lambda c: yardstick.k1_work(c["n"], c["d"], c["D"], 4)),
        ("inmem.sweep.roofline.f32", "sweep", lambda c: yardstick.k2_work(c["n"], c["d"], c["D"], c["G"], 4)),
    ],
)
def test_a_step_share_is_its_bound_over_its_mean_span_time(monkeypatch, name, step, work):
    found = [span(f"neo.solve.{step}", 1, 20.0), span(f"neo.solve.{step}", 2, 60.0)]
    monkeypatch.setattr(spans, "records", lambda: found)
    monkeypatch.setattr(readers_inmemory, "card", lambda ctx: PEAKS)
    bound = yardstick.bound_ms(*work(SHAPES), "float32", PEAKS)
    assert reader(name).read(Window()) == pytest.approx(100.0 * bound / 40.0)
    assert reader(name).read(Window("torch.float64")) is None  # a float32 share reads float32 fits only
    monkeypatch.setattr(spans, "records", lambda: [])  # a program without the span
    assert reader(name).read(Window()) is None
    monkeypatch.setattr(readers_inmemory, "card", lambda ctx: None)  # a run off the card
    monkeypatch.setattr(spans, "records", lambda: found)
    assert reader(name).read(Window()) is None


def test_the_whole_fit_share_counts_the_model_operations_over_the_time_per_fit(monkeypatch):
    monkeypatch.setattr(readers_inmemory, "card", lambda ctx: PEAKS)
    ops = yardstick.fit_flops(SHAPES["n"], SHAPES["d"], SHAPES["D"], SHAPES["G"])
    assert reader("inmem.mfu").read(Window()) == pytest.approx(100.0 * ops / (0.3 * 495e12))
    empty = Window()
    empty.records = empty.records[2:]  # no in-memory fit in the window
    assert reader("inmem.mfu").read(empty) is None


def test_the_answer_kept_from_a_fit_names_its_route_and_leaves_the_keeps():
    from perfbench.drivers import fit_inmemory  # noqa: PLC0415

    kept = {"sweep_inmemory": ("err", "objective", "Gu2", "Gu_k"), "k2": ("err", "objective")}
    assert fit_inmemory.taken_answer(kept) == ("inmemory", ("err", "objective", "Gu2", "Gu_k"))
    assert fit_inmemory.taken_answer(kept) == ("streaming", ("err", "objective"))
    assert kept == {}


def test_a_streaming_grams_embedding_is_the_solvers():
    from neo_ls_svm_torch.ops.cuda.gram import w_basis_from_augmented  # noqa: PLC0415
    from neo_ls_svm_torch.models.primal import embed_from_gram_blocks  # noqa: PLC0415

    from perfbench.drivers import fit_inmemory  # noqa: PLC0415

    Y = torch.randn(300, 2 * 6 + 2, dtype=torch.float32, generator=torch.Generator().manual_seed(1))
    G_aug = Y.T @ Y
    G, _ = w_basis_from_augmented(G_aug, 6)
    assert torch.equal(torch.from_numpy(fit_inmemory.embedded(G_aug)), embed_from_gram_blocks(G, 7).double())


@pytest.mark.chip
def test_on_the_card_the_controls_fail_and_the_program_passes_at_full_size(cuda_device):
    """``test_perfbench_control.py`` for this cell, at its 463,715 rows: the program correct
    on three seeds, the reference in TF32, its normalizer on TF32 rows and the program's one-pass
    sweep not."""
    from perfbench import calibrate_inmemory  # noqa: PLC0415

    cell = harness.load_cell(CELL)
    for seed in (2**31 + 511, 2**31 + 512, 2**31 + 513):
        found = {r["reading"]: r for r in calibrate_inmemory.readings(cell, seed, cuda_device, controls=True)}
        assert found["program"]["correct"] and found["program"]["route"] == "inmemory", (seed, found["program"])
        assert not found["control_tf32"]["correct"] and not found["program_lower_path"]["correct"], seed
        assert not found["control_tf32_rows"]["correct"], seed
