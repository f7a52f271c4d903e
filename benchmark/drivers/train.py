"""Training as ``cli/train.py::train`` runs it, host included: the
loader's ``epoch`` over a VOC-layout cache written at set-up, the upload
(``global_batch``), ``make_train_step``'s step, and the sync, in that
order, step after step. No checkpoint and no in-training eval.

Mix keys: ``images`` (PPM files of the cache, of ``sizes`` in equal
shares, with ``boxes`` = [least, most] objects each, counts in equal
shares), ``checked_steps`` (the first steps, run at set-up through the
window's own call and feed, that the reference follows), ``ini`` (the
port's ``[queue]``, ``[train]`` and ``[optimizer]`` settings) and
``control``. The train state is built from the benchmark's seeded
weights; every step's seed is the run's.

The comparison (``compare.compare_train``): each checked step's loss,
the first gradient as the optimizer got it (read back from its momentum
trace after the first step) and the parameters' change after the
checked steps, leaf by leaf, against the reference following the same
steps from the same weights on the same images. Then the same numbers
(``last_*``) of one more step through the same call once the window has
closed, against the reference following that step from the program's
own state (parameters, momentum trace, step count): the warm-up ramps
the learning rate from 0, so the checked steps barely move the
parameters, and a step that goes wrong only once the window runs shows
there.
"""

from __future__ import annotations

import gc
import itertools
import os
import tempfile
import time
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare
from benchmark.harness import Context, Outcome, ini_overrides
from benchmark.inputs import make_images, make_weights, seeded_order, size_list
from benchmark.reference import detect as ref_detect
from benchmark.reference import network as ref_net
from benchmark.reference import train as ref_train

VOC_NAMES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
             "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
             "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor")


def write_dataset(root: str, images: List[np.ndarray], seed: int,
                  boxes: List[int]) -> List[np.ndarray]:
    """A VOC devkit layout: each image a binary PPM (under the ``.jpg``
    name VOC uses; the loader reads PPM by its magic bytes), its
    annotation, the ``trainval`` set. Returns each image's objects as
    rows (class, xmin, ymin, xmax, ymax) in pixels."""
    rng = np.random.default_rng(int(seed) + 5)
    lo, hi = boxes
    counts = [lo + k % (hi - lo + 1) for k in range(len(images))]
    counts = [counts[k] for k in seeded_order(seed + 6, len(images))]
    for sub in ("Annotations", "JPEGImages", "ImageSets/Main"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    objects = []
    for k, (img, n) in enumerate(zip(images, counts)):
        h, w = img.shape[:2]
        name = f"{k:06d}"
        with open(os.path.join(root, "JPEGImages", name + ".jpg"), "wb") as f:
            f.write(ref_detect.encode_ppm(img))
        bw = rng.uniform(0.05, 0.6, n) * w
        bh = rng.uniform(0.05, 0.6, n) * h
        x0 = rng.uniform(0, 1, n) * (w - bw)
        y0 = rng.uniform(0, 1, n) * (h - bh)
        rows = np.stack([rng.integers(0, len(VOC_NAMES), n), np.round(x0),
                         np.round(y0), np.round(x0 + bw),
                         np.round(y0 + bh)], -1)
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        ET.SubElement(size, "width").text = str(w)
        ET.SubElement(size, "height").text = str(h)
        for c, a, b, x1, y1 in rows:
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = VOC_NAMES[int(c)]
            ET.SubElement(obj, "difficult").text = "0"
            bb = ET.SubElement(obj, "bndbox")
            for key, v in zip(("xmin", "ymin", "xmax", "ymax"),
                              (a, b, x1, y1)):
                ET.SubElement(bb, key).text = str(int(v))
        ET.ElementTree(ann).write(
            os.path.join(root, "Annotations", name + ".xml"))
        objects.append(rows)
    with open(os.path.join(root, "ImageSets", "Main", "trainval.txt"),
              "w") as f:
        f.write("\n".join(f"{k:06d}" for k in range(len(images))) + "\n")
    return objects


def reference_inputs(raw: List[np.ndarray], objects: List[np.ndarray],
                     canvas: int, max_boxes: int, device):
    """The reference's letterbox of every image and its objects in canvas
    (cx, cy, w, h), padded to ``max_boxes``."""
    canv, gts = [], []
    for img, rows in zip(raw, objects):
        h, w = img.shape[:2]
        canv.append(ref_detect.letterbox(torch.from_numpy(img).to(device),
                                         canvas))
        nw, nh, px, py = ref_detect.letterbox_geometry(w, h, canvas)
        gt = np.zeros((max_boxes, 6), np.float32)  # cls, cx, cy, w, h, valid
        for g, (c, x0, y0, x1, y1) in enumerate(rows[:max_boxes]):
            gt[g] = (c, ((x0 + x1) / 2 / w * nw + px) / canvas,
                     ((y0 + y1) / 2 / h * nh + py) / canvas,
                     (x1 - x0) / w * nw / canvas,
                     (y1 - y0) / h * nh / canvas, 1)
        gts.append(gt)
    return torch.stack(canv), np.stack(gts)


def match_rows(host_batch, gts: np.ndarray) -> List[int]:
    """Which image each row of a loader batch holds: the one whose padded
    objects the row's classes, valid flags and boxes match."""
    _, boxes, classes, valid = host_batch
    out = []
    for r in range(boxes.shape[0]):
        err = (np.abs(gts[:, :, 1:5] - boxes[r][None]).max((1, 2))
               + (gts[:, :, 0] != classes[r][None]).any(1)
               + (gts[:, :, 5].astype(bool) != valid[r][None]).any(1))
        out.append(int(np.argmin(err)))
    return out


def reference_steps(ctx: Context, cfg, weights: Dict[str, torch.Tensor],
                    rows: List[List[int]], canv: torch.Tensor,
                    gts: np.ndarray, precision: Optional[str] = None,
                    trace: Optional[Dict[str, torch.Tensor]] = None,
                    first_step: int = 0):
    """The reference's steps ``first_step``, ... from ``weights`` and the
    momentum ``trace`` (zero by default): (loss of each step, the first
    step's gradients, the parameters' change over the steps)."""
    config, mix, dev = ctx.cell.config, ctx.cell.mix, ctx.device
    aug = {"flip": cfg.augment.flip, "jitter": cfg.augment.jitter,
           "hue": cfg.augment.hue, "saturation": cfg.augment.saturation,
           "exposure": cfg.augment.exposure, "min_box": cfg.augment.min_box}
    opt = {"learning_rate": cfg.optimizer.learning_rate,
           "warmup_steps": cfg.optimizer.warmup_steps,
           "warmup_power": cfg.optimizer.warmup_power,
           "weight_decay": cfg.optimizer.weight_decay,
           "momentum": cfg.optimizer.momentum}
    params = {k: v.to(dev).float().clone() for k, v in weights.items()
              if not k.endswith((".mean", ".var"))}
    trace = ({k: torch.zeros_like(v) for k, v in params.items()}
             if trace is None else {k: trace[k].to(dev).float()
                                    for k in params})
    start = {k: v.clone() for k, v in params.items()}
    losses, first = [], None
    for s, idx in enumerate(rows, start=first_step):
        gen = torch.Generator(dev).manual_seed(
            ref_train.step_seed(ctx.seed, s))
        gt = torch.from_numpy(gts[idx]).to(dev)
        p = ref_train.draws(gen, len(idx), aug, dev)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        with ref_net.float32_exact():
            x, boxes, valid = ref_train.augment(
                canv[idx], gt[..., 1:5], gt[..., 5] > 0, mix["dim"], p, aug)
            head = ref_train.forward_train(config, leaves, x,
                                           round_operands=precision)
            terms = ref_train.region_loss(head, config["anchors"], boxes,
                                          gt[..., 0].long(), valid,
                                          config["region"])
            grads = dict(zip(leaves, torch.autograd.grad(
                terms["total"], list(leaves.values()))))
        losses.append(float(terms["total"].detach()))
        if first is None:
            first = {k: g.detach() for k, g in grads.items()}
        params, trace = ref_train.sgd_momentum(
            {k: v.detach() for k, v in leaves.items()}, grads, trace, opt, s)
        del head, terms, grads, leaves
    change = {k: params[k] - start[k] for k in params}
    return losses, first, change


def run(ctx: Context, control: Optional[dict] = None,
        fault: Optional[str] = None) -> Outcome:
    """One run of the cell. ``control``: the reference in the mix's
    control precision stands in for the program's checked steps.
    ``fault`` (tests only): ``unchanged`` (the step leaves the state as
    it was) or ``half`` (half of the batch left out of the step)."""
    from yolojax_torch.config import load_config
    from yolojax_torch.convert.interchange import network_from_state_dict
    from yolojax_torch.data.cache import build_cache
    from yolojax_torch.data.grain_loader import make_loader
    from yolojax_torch.parallel.distributed import global_batch
    from yolojax_torch.train.step import (TrainState, make_optimizer,
                                          make_train_step)

    mix, rec, dev = ctx.cell.mix, ctx.recorder, ctx.device
    cfg = load_config([], ini_overrides(ctx.cell))
    model = cfg.build_model()
    compute = (torch.bfloat16 if cfg.train.compute_dtype == "bfloat16"
               else torch.float32)
    tmp = tempfile.TemporaryDirectory()
    try:
        sizes = size_list(mix["sizes"], mix["images"], ctx.seed)
        raw = [im.cpu().numpy() for im in make_images(sizes, ctx.seed, dev)]
        voc = os.path.join(tmp.name, "voc")
        objects = write_dataset(voc, raw, ctx.seed, mix["boxes"])
        cache = build_cache(os.path.join(tmp.name, "cache"), "train",
                            [{"kind": "voc", "root": voc,
                              "image_set": "trainval"}], VOC_NAMES)
        loader = make_loader(cache, cfg.queue, cfg.queue.loader)
        weights = make_weights(ctx.cell.config, ctx.seed, dev)
        start = {k: v.detach().to("cpu", copy=True)
                 for k, v in weights.items()}
        net = network_from_state_dict(model, weights)
        tx = make_optimizer(cfg.optimizer)
        ts = TrainState(0, net, tx.init(dict(net.named_parameters())))
        step_fn = make_train_step(model, tx, loss_cfg=cfg.loss_config(),
                                  aug_cfg=cfg.augment, augment=True,
                                  compute_dtype=compute)
        batches = (b for epoch in itertools.count()
                   for b in loader.epoch(epoch))
        state = {"ts": ts}

        def one():
            """The window's call and feed: next batch, upload, step, sync."""
            with rec.span("loader.next"):
                host = next(batches)
            with rec.span("step"):
                batch = global_batch(host, dev)
                if fault == "half":
                    batch = tuple(t[:t.shape[0] // 2] for t in batch)
                before = ({k: v.detach().clone() for k, v in
                           state["ts"].net.state_dict().items()}
                          if fault == "unchanged" else None)
                state["ts"], m = step_fn(state["ts"], batch, ctx.seed,
                                         mix["dim"])
                if before is not None:
                    state["ts"].net.load_state_dict(before)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
            return host, m

        checked, losses, first = [], [], None
        for s in range(mix["checked_steps"]):
            host, m = one()
            checked.append(host)
            losses.append(float(m["total"]))
            if s == 0:
                first = first_gradients(state["ts"], start, cfg)
        params = dict(state["ts"].net.named_parameters())
        change = {k: params[k].detach().cpu() - start[k] for k in params}
        done = 0
        with ctx.window():
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < ctx.seconds:
                one()
                done += 1
            elapsed = time.perf_counter() - t0
        peak = ctx.peak_bytes()
        last = last_step(state, one, cfg)
        batches.close()
        del state, ts, net, weights, step_fn, params
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        b = cfg.queue.batch_size
        rec.counters.update(steps=done, images=done * b, seconds=elapsed)
        compared = judge(ctx, cfg, start, raw, objects, checked,
                         (losses, first, change),
                         (control or {}).get("reference"), last)
    finally:
        tmp.cleanup()
    return Outcome(attempted=done * b, failed=0,
                   e2e={"train_img_per_s": done * b / elapsed,
                        "peak_mem_gib": peak / 2 ** 30},
                   compared=compared, memory_peak_bytes=peak, recorder=rec,
                   trace=ctx.trace)


def first_gradients(ts, start: Dict[str, torch.Tensor], cfg
                    ) -> Dict[str, torch.Tensor]:
    """The first step's gradients as the optimizer got them: its momentum
    trace after one step from a zero trace is g + decay * p0 (decay on
    conv kernels only)."""
    trace = ts.opt_state["trace"]
    wd = cfg.optimizer.weight_decay
    return {k: t.detach().cpu() - (wd * start[k] if t.dim() > 1 else 0.0)
            for k, t in trace.items()}


def last_step(state: dict, one, cfg) -> dict:
    """One more step of the window's call and feed, once the window has
    closed, from the state the window left: its host batch, its step
    count, the parameters and momentum trace before it, and the
    program's (loss, gradient as the optimizer got it, change)."""
    ts = state["ts"]
    before = {k: v.detach().to("cpu", copy=True)
              for k, v in ts.net.named_parameters()}
    trace = {k: t.detach().to("cpu", copy=True)
             for k, t in ts.opt_state["trace"].items()}
    count = ts.step
    host, m = one()
    ts = state["ts"]
    mom, wd = cfg.optimizer.momentum, cfg.optimizer.weight_decay
    grad = {k: t.detach().cpu() - mom * trace[k]
            - (wd * before[k] if t.dim() > 1 else 0.0)
            for k, t in ts.opt_state["trace"].items()}
    change = {k: v.detach().cpu() - before[k]
              for k, v in ts.net.named_parameters()}
    return {"host": host, "count": count, "params": before, "trace": trace,
            "program": ([float(m["total"])], grad, change)}


def judge(ctx: Context, cfg, start, raw, objects, checked, program,
          control: Optional[str], last: dict) -> Dict[str, float]:
    """The checked steps from the seeded weights, and the step after the
    window from the program's own state (``last_*``), each against the
    reference; with ``control`` (a precision) the reference in that
    precision stands in for the program's steps."""
    canv, gts = reference_inputs(raw, objects, cfg.queue.canvas_dim,
                                 cfg.queue.max_boxes, ctx.device)
    rows = [match_rows(host, gts) for host in checked]
    ref = reference_steps(ctx, cfg, start, rows, canv, gts)
    if control is not None:
        program = reference_steps(ctx, cfg, start, rows, canv, gts, control)
    out = compare.compare_train(program, ref)
    after = dict(weights=last["params"], rows=[match_rows(last["host"], gts)],
                 canv=canv, gts=gts, trace=last["trace"],
                 first_step=last["count"])
    ref = reference_steps(ctx, cfg, **after)
    program = (last["program"] if control is None else
               reference_steps(ctx, cfg, precision=control, **after))
    out.update({f"last_{k}": v for k, v in
                compare.compare_train(program, ref).items()})
    return out
