"""The port's kernels on the 1M-row fits' own tensors, for one checkout of the repo.

    python3 tools/kernel_times.py [--tree DIR]

``--tree`` names the checkout whose ``neo_ls_svm_torch`` is imported (default: the one that
holds this script); the ``chip_smoke.py`` beside this script drives it. Two JSON lines,
also kept in ``chiprun_out/kernel_times.jsonl``:

- ``kernels_f32``: the default ``NeoLSSVM()`` fit of bench's 1,048,576 × 32 float32 rows, and
  the same fit under ``precision="fast"``; K1 and K2 timed on the first fit's tensors and K2's
  one-pass path on the second's, each beside its plain version and bound, the one pass also
  beside its three products in cuBLAS TF32 and split into its Gu product, sweep product and
  feature build (``chip_smoke.gram_timings``, ``chip_smoke.sweep_timings``);
- ``fit_1m_f64``: ``chip_smoke.py``'s phase of that name, the same rows in float64: the fit's
  first and repeat seconds, one K1 and one K2 launch on the float64 path, each kernel held to
  its plain version on the fit's own tensors and timed there (K1 also against
  ``torch.matmul`` in float64), and the 262,144- and 261,632-row float64 fits either side of
  the streaming threshold.

To compare two checkouts, run the script for each in turns (A, B, B, A) on one card. Ends
with the card's name and power limit as ``nvidia-smi`` gives them.
"""

import argparse
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=ROOT)
    args = parser.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    # This checkout's chip_smoke.py, whichever package the tree holds (an older tree has
    # its own chip_smoke.py, without this phase).
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    package = Path(chip_smoke.gram_mod.__file__).resolve()
    if tree not in package.parents:
        print(f"kernel_times: imported {package}, not the package of {tree}", file=sys.stderr)
        return 1
    chip_smoke.RECORDS = ROOT / "chiprun_out" / "kernel_times.jsonl"
    torch.backends.cuda.matmul.fp32_precision = "tf32"  # as chip_smoke.py runs
    chip_smoke._build.load_library()
    dev = torch.device("cuda", 0)
    X, y = chip_smoke.make_dataset(1 << 20, chip_smoke.D_IN, seed=0)
    kernels = {}
    for precision in ("high", "fast"):
        with chip_smoke.recording_kernel_calls() as calls:
            chip_smoke.NeoLSSVM(device=dev, precision=precision).fit(X, y)
        if precision == "high":
            kernels["fused_augmented_gram"] = chip_smoke.gram_timings(list(calls["fused_augmented_gram"][0]))
        s_args, s_kw, _ = calls["fused_loo_sweep"]
        kw = {k: v for k, v in s_kw.items() if k != "precision"}
        name = "fused_loo_sweep" if precision == "high" else "fused_loo_sweep_one_pass"
        kernels[name] = chip_smoke.sweep_timings(list(s_args), kw, precision)
        del calls, s_args
    chip_smoke.emit({"phase": "kernels_f32", "kernels": kernels})
    del X, y
    torch.cuda.empty_cache()
    chip_smoke.phase_fit_1m_f64(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(f"tree={tree} f64_path={chip_smoke._build.PATH_FP64} card={smi.stdout.strip()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
