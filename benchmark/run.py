#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload int8_384.denoise --seed 7 --seconds 50 --trace 0

The last line of standard output is the result, one JSON object; the numbers
compared with the reference, each beside its limit, are the last lines of
standard error.  Without a CUDA card, with fewer cards than the cell asks
for, or with the JAX stack loaded, it prints no result and exits with 1.
See benchmark/README.md.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    harness.cache_dirs()
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                  STARTED)
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 1
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
