#!/usr/bin/env python3
"""The control of a cell's comparison: runs of the cell with the mix's
``control`` in the program's place (the reference in a lower precision,
or the program with a lower-precision path of its own), whose numbers
must fail the cell's limits. Each run is judged as the benchmark judges
one (``harness.judge``). Prints one JSON line a seed: ``correct``, then
every number the run compared.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 [--program | --fault unchanged|half | --reference bf16]

``--program`` runs the program itself the same way, for the readings
that the limits are set above (a dozen seeds in one process);
``--fault`` the train program with that fault planted; ``--reference``
the reference in that precision in the program's place (a witness).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402


def outcome(cell: harness.Cell, seed: int, seconds: float, device, *,
            program: bool = False, fault: str = "",
            reference: str = "") -> harness.Outcome:
    """One run of the control, or of the program (``program``), of the
    train program with a ``fault`` planted, or of the reference in the
    ``reference`` precision in the program's place."""
    driver = importlib.import_module(f"benchmark.drivers.{cell.mix['kind']}")
    ctx = harness.Context(cell, seed, seconds, False, device)
    kw = {"fault": fault} if fault else {}
    control = ({"reference": reference} if reference else
               None if program or fault else cell.mix["control"])
    return driver.run(ctx, control=control, **kw)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", default="")
    p.add_argument("--reference", default="")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = outcome(cell, seed, args.seconds, torch.device("cuda", 0),
                      program=args.program, fault=args.fault,
                      reference=args.reference)
        correct, _ = harness.judge(out, cell.limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program, "fault": args.fault,
                          "reference": args.reference, "correct": correct,
                          "failed": out.failed, **out.compared}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
