"""Run one cell of the benchmark once and print its result as the last line of stdout.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device's busy seconds. Each number that decides ``correct`` is
printed beside its limit, last in the result and as the last lines of stderr. The run
needs as many CUDA devices as the cell asks for; it exits with a non-zero code and prints
no result without them, or when JAX or the JAX package has been loaded.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = harness.load_cell(args.workload)

    import torch  # noqa: PLC0415

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {count}", file=sys.stderr)
        return 2
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = harness.forbidden_loaded()
    if found:
        print(f"modules that the benchmark must not load were loaded: {found}", file=sys.stderr)
        return 3
    for name, value in out.pop("also_read").items():
        print(f"also read (not compared) {name} {value!r}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
