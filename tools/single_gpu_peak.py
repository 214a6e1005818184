"""Peak device memory and device pre-transform time of the single-GPU default fit, for one
checkout of the repo.

    python3 tools/single_gpu_peak.py [--tree DIR] [--rows N] [--fits F] [--reps K]

``--tree`` names the checkout whose ``neo_ls_svm_torch`` is imported (default: the one that
holds this script). To compare two checkouts, run the script for each in turns (A, B, B, A)
on one card in one session. Prints one JSON line:

- ``fit``: ``NeoLSSVM(device="cuda").fit`` on N × 32 float32 rows (the generator of
  ``chip_smoke.py``, seed 0), F times: the seconds of each, ``torch.cuda.max_memory_allocated``
  over the last, its LOO R² and γ;
- ``pretransform``: ``device_pre_transform`` alone on the same rows uploaded once (seed 42,
  the estimator's settings): its peak over the call above the uploaded rows, the median of
  its seconds over K calls, and a SHA-256 of M and of b, which tells two checkouts' bits apart;
- ``deviation_sums``: the normalizer's per-bin sums of absolute deviations from the bin
  medians, as one float32 product over all rows (IEEE) against float64 sums: the largest
  relative distance;
- the card's name and power limit as ``nvidia-smi`` gives them.
"""

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def make_dataset(n: int, d: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """The rows of ``chip_smoke.make_dataset`` in float32."""
    gen = np.random.RandomState(seed)
    X = gen.randn(n, d).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.25 * np.abs(X[:, 3]) + 0.1 * gen.randn(n)).astype(np.float32)
    return X, y


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--rows", type=int, default=1 << 22)
    parser.add_argument("--fits", type=int, default=3)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        print("single_gpu_peak: no CUDA device", file=sys.stderr)
        return 1
    from neo_ls_svm_torch import NeoLSSVM  # noqa: PLC0415
    from neo_ls_svm_torch.ops.affine import grouped_weighted_median  # noqa: PLC0415
    from neo_ls_svm_torch.ops.pretransform_device import (  # noqa: PLC0415
        DEVICE_PRETRANSFORM_BINS,
        _target_codes,
        device_pre_transform,
    )

    dev = torch.device("cuda", 0)
    X, y = make_dataset(args.rows, 32)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    fits = []
    for _ in range(args.fits):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds, model = timed(lambda: NeoLSSVM(device=dev).fit(X, y))
        fits.append(seconds)
    fit = {"seconds": fits, "peak_memory_bytes": torch.cuda.max_memory_allocated(), "loo_score": model.loo_score_,
           "gamma": model.γ_, "pre_transform": model.pre_transform_}
    del model
    torch.cuda.empty_cache()

    X_d, y_d = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    w_d = torch.ones_like(y_d)
    kw = {"num_bins": DEVICE_PRETRANSFORM_BINS, "num_features": 512, "edge_sample_size": 384,
          "edge_search_multiplier": 4, "rank_threshold": 2e-2, "is_classifier": False}

    def pretransform() -> dict:
        generator = torch.Generator(device=dev)
        generator.manual_seed(42)
        return device_pre_transform(X_d, y_d, w_d, generator, **kw)

    pretransform()  # first call: the libraries' own set-up
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, pt = timed(pretransform)
    peak = torch.cuda.max_memory_allocated() - base
    seconds = [timed(pretransform)[0] for _ in range(args.reps)]
    digest = {k: hashlib.sha256(pt[k].cpu().numpy().tobytes()).hexdigest()[:16] for k in ("M", "b")}
    del pt
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    bins = DEVICE_PRETRANSFORM_BINS
    codes, _ = _target_codes(y_d, w_d, num_bins=bins, is_classifier=False)
    med = grouped_weighted_median(X_d, w_d, codes, bins)
    onehot = (codes[:, None] == torch.arange(bins, dtype=codes.dtype, device=dev)[None, :]).to(torch.float32)
    deviations = (X_d - med[codes.clamp(0, bins - 1).long()]).abs()
    sums32 = (onehot.T @ deviations).double()
    sums64 = sum(onehot[r : r + (1 << 20)].double().T @ deviations[r : r + (1 << 20)].double()
                 for r in range(0, args.rows, 1 << 20))
    stray = float(((sums32 - sums64).abs() / sums64.abs()).max())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"tree": str(args.tree), "rows": args.rows, "card": smi, "fit": fit,
                      "pretransform": {"peak_above_inputs_bytes": peak, "seconds_median": statistics.median(seconds),
                                       "seconds": seconds, "sha256": digest},
                      "deviation_sums": {"f32_vs_f64_max_rel": stray}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
