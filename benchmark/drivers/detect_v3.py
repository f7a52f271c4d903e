"""Bulk detection with a YOLOv3 configuration: ``detect.py``'s closed loop
of ``build_detector``'s ``infer``, one batch in flight, host canvases in
and host detections out, with the plain reference of
``reference/yolo3.py`` making the weights, their BN statistics and the
decode the program is judged against.

Mix keys as ``detect.py``'s: ``batch``, ``pool_batches``, ``sizes``,
``sample_batches``, ``reference`` (``float32``), ``control``
(``{"reference": "fp8"}``) and ``ini``.
"""

from __future__ import annotations

import gc
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare
from benchmark.drivers.detect import Reservoir, program_weights
from benchmark.harness import Context, Outcome, busy_seconds, ini_overrides
from benchmark.inputs import make_images, size_list
from benchmark.reference import detect as ref_detect
from benchmark.reference import network as ref_net
from benchmark.reference import yolo3 as ref_v3


def setup(ctx: Context, extra_ini: Optional[dict] = None):
    """The program's detector and the canvases the loop feeds it; the raw
    images stay on the host for the reference. The model is built first,
    so that a program without it fails before any work."""
    from yolojax_torch.cli.detect import build_detector
    from yolojax_torch.config import load_config
    from yolojax_torch.data.augment import letterbox_host

    mix, dev = ctx.cell.mix, ctx.device
    cfg = load_config([], ini_overrides(ctx.cell))
    program_cfg = load_config([], ini_overrides(ctx.cell) + [
        f"{k}={v}" for k, v in (extra_ini or {}).items()])
    program_cfg.build_model()
    b, p = mix["batch"], mix["pool_batches"]
    dim = cfg.model.dim
    weights = ref_v3.make_weights(ctx.cell.config, ctx.seed, dev)
    images = make_images(size_list(mix["sizes"], b * p, ctx.seed), ctx.seed,
                         dev)
    canvases = torch.stack([letterbox_host(im, dim)[0] for im in images])
    pool = [np.ascontiguousarray(c) for c in
            canvases.reshape(p, b, dim, dim, 3).cpu().numpy()]
    raw = [im.cpu() for im in images]
    del images, canvases
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/weights.npz"
        program_weights(program_cfg, weights, path)
        _, _, infer = build_detector(program_cfg, path, device=dev)
    for batch in pool:  # every shape and kernel the loop will use
        infer(batch)
    return cfg, weights, pool, raw, infer


def reference_decode(ctx: Context, cfg, folded, raw: List[torch.Tensor],
                     precision: str):
    """The reference's letterbox, forward and decode of ``raw`` images
    with the BN-folded weights: (corners, scores) on the device."""
    config, dev, dim = ctx.cell.config, ctx.device, cfg.model.dim
    with torch.no_grad(), ref_net.float32_exact():
        canv = torch.stack([ref_detect.letterbox(im.to(dev), dim)
                            for im in raw])
        heads = ref_v3.forward_blocks(
            config, folded, canv,
            round_operands=None if precision == "float32" else precision)
        return ref_v3.decode(heads, config["anchors"], config["masks"], dim)


def judge(ctx: Context, cfg, weights, raw, kept, control: Optional[str] = None
          ) -> Dict[str, float]:
    """The numbers of the kept (batch index, outputs) pairs against the
    reference; with ``control`` (a precision) the reference in that
    precision stands in for the program's outputs."""
    mix = ctx.cell.mix
    b, p = mix["batch"], mix["pool_batches"]
    worst: Dict[str, float] = {}
    by_pool = {}
    for n, out in kept:
        by_pool.setdefault(n % p, []).append(out)
    folded = ref_net.fold(ctx.cell.config, weights)
    for k, outs in sorted(by_pool.items()):
        rows = raw[k * b:(k + 1) * b]
        corners, scores = reference_decode(ctx, cfg, folded, rows,
                                           mix["reference"])
        if control is not None:
            c, s = reference_decode(ctx, cfg, folded, rows, control)
            outs = [ref_detect.detections(
                c, s, top_k=cfg.detect.top_k,
                score_thresh=cfg.detect.threshold,
                iou_thresh=cfg.detect.nms_iou)]
            del c, s
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
        print(f"detect_v3: img/s in 10 s slices {slices.round(1).tolist()}",
              file=sys.stderr)
    compared = judge(ctx, cfg, weights, raw, sample.items,
                     (control or {}).get("reference"))
    return Outcome(attempted=done * b, failed=failed * b,
                   e2e=e2e,
                   compared=compared, memory_peak_bytes=peak, recorder=rec,
                   trace=ctx.trace)
