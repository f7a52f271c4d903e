#!/usr/bin/env python3
"""A/B of two checkouts of the port on one CUDA card, in turns.

Usage, on a machine with an H100 and ``nvcc``, from any directory:

    python3 chip_ab.py PARENT_ROOT CHANGE_ROOT [--out DIR]

Each root is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists).
Four processes run one after another, parent, change, change, parent;
each builds its checkout's kernels, writes seeded full-width Darknet-19
weights (``chip_smoke.random_weights``) and measures, on one seeded
device-resident b128@416 batch:

- the device ms of the bf16 serving program with ``detect.fuse_stem`` off
  and pallas (CUDA events, median of 5, three rounds, cuDNN autotuning
  on), and the peak device memory over each program's calls;
- the batch-1 latency of ``build_detector``'s ``infer`` (host clock, numpy
  in and out, median of 20);
- the unfused program's outputs, in a thread of its own with cuDNN's
  deterministic heuristics (autotuned plans may differ from process to
  process), saved to ``DIR/<turn>.npz``.

It prints one line a process, then whether each turn's outputs equal the
first turn's bit for bit.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

LATENCY_RUNS = 20


def one(root: str, out: str) -> None:
    """One turn: ``root``'s programs, timed, and their outputs saved."""
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from yolojax_torch.cli.detect import build_detector, build_serving

    dev = torch.device("cuda", 0)
    overrides = ["detect.threshold=0.005"]
    cfg = cs.load_config(["config.ini"], overrides)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "w.npz")
        cs.random_weights(cfg, npz)
        gen = torch.Generator(dev).manual_seed(cs.SEED)
        dim = cfg.model.dim
        canvases = torch.rand((cs.BATCH, dim, dim, 3), device=dev,
                              generator=gen)

        def outputs():
            torch.backends.cudnn.benchmark = False
            torch.backends.cudnn.deterministic = True
            _, _, fn, net, _ = build_serving(cfg, npz)
            return {k: v.cpu().numpy() for k, v in fn(net, canvases).items()}

        with ThreadPoolExecutor(1) as pool:
            np.savez(out, **pool.submit(outputs).result())
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.deterministic = False
        for fuse in ("off", "pallas"):
            c = cs.load_config(["config.ini"],
                               overrides + [f"detect.fuse_stem={fuse}"])
            _, _, fn, net, _ = build_serving(c, npz)
            fn(net, canvases)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = [statistics.median(cs.cuda_ms(lambda: fn(net, canvases), 5))
                  for _ in range(3)]
            res[fuse] = (ms, torch.cuda.max_memory_allocated() / 2**30)
            del fn, net
            torch.cuda.empty_cache()
        _, _, infer = build_detector(cfg, npz, device=dev)
        x = canvases[:1].cpu().numpy()
        infer(x)
        lat = []
        for _ in range(LATENCY_RUNS):
            t0 = time.perf_counter()
            infer(x)
            lat.append((time.perf_counter() - t0) * 1e3)
    print(f"{root}: " + "; ".join(
        f"b{cs.BATCH}@{dim} fuse_stem={f} {statistics.mean(ms):.3f} ms "
        f"(rounds {', '.join(f'{t:.3f}' for t in ms)}), peak {peak:.2f} GiB"
        for f, (ms, peak) in res.items())
        + f"; batch-1 p50 {statistics.median(lat):.3f} ms", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--out", default="chiprun_out/ab")
    ap.add_argument("--one", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(os.path.abspath(args.one[0]), os.path.abspath(args.one[1]))
        return 0
    import numpy as np

    os.makedirs(args.out, exist_ok=True)
    turns = [("parent1", args.parent), ("change1", args.change),
             ("change2", args.change), ("parent2", args.parent)]
    for name, root in turns:
        subprocess.run([sys.executable, os.path.abspath(__file__), "x", "x",
                        "--one", os.path.abspath(root),
                        os.path.join(os.path.abspath(args.out), name)],
                       check=True, timeout=900)
    first = np.load(os.path.join(args.out, "parent1.npz"))
    for name, _ in turns:
        got = np.load(os.path.join(args.out, f"{name}.npz"))
        same = all(np.array_equal(got[k].view(np.uint8), first[k].view(
            np.uint8)) for k in first)
        print(f"{name} outputs == parent1 bit for bit: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
