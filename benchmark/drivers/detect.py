"""Bulk detection: a closed loop of ``build_detector``'s ``infer``, one
batch in flight, host canvases in and host detections out.

Mix keys: ``batch`` (images a call), ``pool_batches`` (distinct batches,
letterboxed at set-up by the port's ``letterbox_host`` from images of the
mix's ``sizes``, in equal shares and a seeded order), ``sample_batches``
(timed batches kept for the comparison, a seeded reservoir sample),
``reference`` (``float32`` or ``int8``: what the plain reference runs),
``calib_images`` (int8: the pool's first canvases calibrate), ``control``
(the control of the comparison: ``{"reference": "fp8"}``, the reference
in float8 put in the program's place, or ``{"ini": {...}}``, the program
with a lower-precision path of its own switched on) and ``ini`` (the
port's settings).
"""

from __future__ import annotations

import gc
import random
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare
from benchmark.harness import Context, Outcome, busy_seconds, ini_overrides
from benchmark.inputs import make_images, make_weights, size_list
from benchmark.reference import detect as ref_detect
from benchmark.reference import int8 as ref_int8
from benchmark.reference import network as ref_net


class Reservoir:
    """k items of a stream of unknown length, each equally likely,
    chosen by a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def program_weights(cfg, weights: Dict[str, torch.Tensor], path: str) -> None:
    """The seeded weights written through the port's own ``.npz`` store,
    the file its entry points load."""
    from yolojax_torch.convert.interchange import network_from_state_dict
    from yolojax_torch.convert.store import save_network_npz

    model = cfg.build_model()
    sd = {k: v.detach().cpu() for k, v in weights.items()}
    save_network_npz(path, model, network_from_state_dict(model, sd))


def setup(ctx: Context, extra_ini: Optional[dict] = None):
    """The program's detector and the canvases the loop feeds it; the raw
    images stay on the host for the reference. ``extra_ini``: settings of
    the program alone (a control's); the returned config is the cell's."""
    from yolojax_torch.cli.detect import build_detector
    from yolojax_torch.config import load_config
    from yolojax_torch.data.augment import letterbox_host

    mix, dev = ctx.cell.mix, ctx.device
    cfg = load_config([], ini_overrides(ctx.cell))
    program_cfg = load_config([], ini_overrides(ctx.cell) + [
        f"{k}={v}" for k, v in (extra_ini or {}).items()])
    b, p = mix["batch"], mix["pool_batches"]
    dim = cfg.model.dim
    weights = make_weights(ctx.cell.config, ctx.seed, dev)
    images = make_images(size_list(mix["sizes"], b * p, ctx.seed), ctx.seed,
                         dev)
    canvases = torch.stack([letterbox_host(im, dim)[0] for im in images])
    pool = [np.ascontiguousarray(c) for c in
            canvases.reshape(p, b, dim, dim, 3).cpu().numpy()]
    raw = [im.cpu() for im in images]
    del images, canvases
    calib = (pool[0][:mix["calib_images"]] if program_cfg.detect.use_int8
             else None)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/weights.npz"
        program_weights(program_cfg, weights, path)
        _, _, infer = build_detector(program_cfg, path, calib, device=dev)
    for batch in pool:  # every shape and kernel the loop will use
        infer(batch)
    return cfg, weights, pool, raw, infer


def reference_decode(ctx: Context, cfg, weights, raw: List[torch.Tensor],
                     calib_raw: List[torch.Tensor], precision: str):
    """The reference's letterbox, forward and decode of ``raw`` images:
    (corners, scores) on the device."""
    config, dev, dim = ctx.cell.config, ctx.device, cfg.model.dim
    with torch.no_grad(), ref_net.float32_exact():
        folded = ref_net.fold(config, weights)
        canv = torch.stack([ref_detect.letterbox(im.to(dev), dim)
                            for im in raw])
        if precision == "int8":
            calib = torch.stack([ref_detect.letterbox(im.to(dev), dim)
                                 for im in calib_raw])
            q = ref_int8.quantize(config, folded, calib,
                                  cfg.detect.quant_bits)
            head = ref_int8.forward_blocks(config, folded, q, canv)
        else:
            head = ref_net.forward_blocks(
                config, folded, canv,
                round_operands=None if precision == "float32" else precision)
        return ref_detect.decode(head, config["anchors"])


def judge(ctx: Context, cfg, weights, raw, kept, control: Optional[str] = None
          ) -> Dict[str, float]:
    """The numbers of the kept (batch index, outputs) pairs against the
    reference; with ``control`` (a precision) the reference in that
    precision stands in for the program's outputs."""
    mix = ctx.cell.mix
    b, p = mix["batch"], mix["pool_batches"]
    calib_raw = raw[:mix.get("calib_images", 0)]
    worst: Dict[str, float] = {}
    by_pool = {}
    for n, out in kept:
        by_pool.setdefault(n % p, []).append(out)
    for k, outs in sorted(by_pool.items()):
        rows = raw[k * b:(k + 1) * b]
        corners, scores = reference_decode(ctx, cfg, weights, rows, calib_raw,
                                           mix["reference"])
        if control is not None:
            c, s = reference_decode(ctx, cfg, weights, rows, calib_raw,
                                    control)
            outs = [ref_detect.detections(
                c, s, top_k=cfg.detect.top_k,
                score_thresh=cfg.detect.threshold,
                iou_thresh=cfg.detect.nms_iou)]
        for out in outs:
            got = {key: torch.as_tensor(v).to(ctx.device)
                   for key, v in out.items()}
            nums = compare.compare_detect(
                got, corners, scores, score_thresh=cfg.detect.threshold,
                iou_thresh=cfg.detect.nms_iou, dim=cfg.model.dim)
            for key, v in nums.items():
                worst[key] = max(worst.get(key, 0.0), v)
        del corners, scores
    return worst


def run(ctx: Context, control: Optional[dict] = None) -> Outcome:
    """One run of the cell. ``control`` (the control test only): the
    mix's control in place of the program's answers."""
    mix, rec = ctx.cell.mix, ctx.recorder
    cfg, weights, pool, raw, infer = setup(
        ctx, (control or {}).get("ini"))
    b = mix["batch"]
    sample = Reservoir(mix["sample_batches"], ctx.seed)
    done = failed = 0
    with ctx.window():
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            with rec.span("infer"):
                try:
                    out = infer(pool[done % len(pool)])
                except RuntimeError:
                    failed += 1
                    out = None
            if out is not None:
                sample.offer((done, out))
            done += 1
        elapsed = time.perf_counter() - t0
    peak = ctx.peak_bytes()
    del infer
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rec.counters.update(batches=done, images=done * b, seconds=elapsed,
                        failed_images=failed * b)
    e2e = {"peak_mem_gib": peak / 2 ** 30}
    if ctx.trace is not None and done:
        # the device's time a batch: kernels only, the upload left out
        e2e["detect_batch_device_ms"] = 1e3 * busy_seconds(ctx.trace) / done
    ends = [t1 for name, _, t1 in rec.spans if name == "infer"]
    if ends:  # the rate in 10-second slices: does a run drift?
        t0_ns = ends[0]
        slices = np.bincount([int((t - t0_ns) // 10_000_000_000)
                              for t in ends]) * b / 10.0
        print(f"detect: img/s in 10 s slices {slices.round(1).tolist()}",
              file=sys.stderr)
    compared = judge(ctx, cfg, weights, raw, sample.items,
                     (control or {}).get("reference"))
    return Outcome(attempted=done * b, failed=failed * b,
                   e2e=e2e,
                   compared=compared, memory_peak_bytes=peak, recorder=rec,
                   trace=ctx.trace)
