#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics read from a device trace of
the window. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with a
trace ``breakdown``, and ``checks`` last: each number compared with the
plain reference beside its limit); the checks are also the last lines of
standard error. Without a CUDA card the run fails and prints no result.

``--rate`` replaces a mix's arrival rate, for the sweep that finds the
rate a serving cell offers; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rate", type=float, default=None)
    args = p.parse_args(argv)
    # caches at fixed paths inside the checkout: only a checkout's first
    # run builds (the port's own kernels build into build/yolojax_torch)
    cache = ROOT / "build" / "benchmark"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    return harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), rate=args.rate)


if __name__ == "__main__":
    sys.exit(main())
