#!/usr/bin/env python3
"""The training entry point: input pipeline + model + loss + optimizer,
resume from the latest checkpoint in the logdir, then the step loop with
summary, eval and checkpoint hooks. Port of ``cli/train.py`` for one
process on one device.

Usage:

  python -m yolojax_torch.cli.train -c config.ini [--device cpu] \\
      [--init-weights W.npz [--transfer conv_22,...]] [section.key=value ...]

Each step augments the host batch on the device, runs the train-mode
forward (BN batch statistics), the YOLO loss and its backward, and the
optimizer update. Writes ``<logdir>/<model>_<inference>/`` with
``metrics.jsonl``, ``ckpt/<step>/`` (the port's own checkpoint format;
``detect`` and ``eval`` take this directory as ``--weights``), and
``diverged/`` when a non-finite loss halts the run. The in-training eval
(``train.eval_steps``) runs the port's ``evaluate_model`` on the ``val``
cache, through the CUDA NMS kernel and, with ``detect.fuse_stem``, the
stem kernel. Not ported yet (they raise NotImplementedError):
``train.mesh_data``/``train.mesh_model`` > 1, ``train.zero``,
``train.coordinator``/``train.num_processes`` (multi-device),
``queue.loader=grain`` and ``train.profile_port`` (torch has no profiler
server; ``train.profile_steps`` writes a trace). ``train.tensorboard=1``
also writes the scalars and histograms as TensorBoard events in the
logdir.
"""

from __future__ import annotations

import itertools
import logging
import math
import os

import torch

from yolojax_torch.convert.interchange import tensors_from_jax
from yolojax_torch.convert.store import load_params_npz
from yolojax_torch.data.cache import load_cache
from yolojax_torch.data.loader import Loader
from yolojax_torch.eval.evaluator import evaluate_model
from yolojax_torch.train.checkpoint import Checkpointer
from yolojax_torch.train.step import (
    MultiScaleSchedule,
    init_train_state,
    make_optimizer,
    make_train_step,
)
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.device import resolve_device
from yolojax_torch.utils.metrics import MetricsLogger
from yolojax_torch.utils.profiling import (
    StepTimer,
    enable_debug_nans,
    profile_trace,
)

log = logging.getLogger("train")

_MULTI_DEVICE = "(ROADMAP queue 1, multi-device)"


def _check_ported(cfg) -> None:
    t = cfg.train
    for on, what in (
        (t.mesh_data > 1, f"train.mesh_data > 1 {_MULTI_DEVICE}"),
        (t.mesh_model > 1, f"train.mesh_model > 1 {_MULTI_DEVICE}"),
        (t.zero, f"train.zero (ZeRO-1) {_MULTI_DEVICE}"),
        (bool(t.coordinator), f"train.coordinator {_MULTI_DEVICE}"),
        (t.num_processes > 1, f"train.num_processes > 1 {_MULTI_DEVICE}"),
        (bool(t.eval_steps) and cfg.eval.data_parallel_flag() is True,
         f"eval.data_parallel=on for the in-training eval {_MULTI_DEVICE}"),
        (cfg.queue.loader == "grain",
         "queue.loader=grain (ROADMAP queue 1, checkpoint and host data)"),
    ):
        if on:
            raise NotImplementedError(f"{what} is not ported yet")
    if t.profile_port:
        raise NotImplementedError(
            "train.profile_port: torch has no live profiler server; use "
            "train.profile_steps for a trace of one step")


def _load_init_weights(ts, model, path: str, transfer: str) -> None:
    """Copy an ``.npz``'s params and BN state into ``ts``, leaving the
    layers named in ``transfer`` at their fresh initialisation."""
    params, bn_state = load_params_npz(path)
    drop = set(filter(None, transfer.split(",")))
    sd = tensors_from_jax(model, {k: v for k, v in params.items()
                                  if k not in drop})
    sd.update({f"{k}.{key}": torch.from_numpy(v)
               for k, st in bn_state.items() if k not in drop
               for key, v in st.items()})
    unexpected = ts.net.load_state_dict(sd, strict=False).unexpected_keys
    if unexpected:
        raise ValueError(f"{path}: tensors the model does not have: "
                         f"{unexpected}")
    log.info("initialized from %s (re-init: %s)", path, sorted(drop) or "none")


def train(cfg, *, device=None, init_weights: str = "", transfer: str = ""):
    """Run ``cfg``'s training; returns the final train state."""
    _check_ported(cfg)
    device = resolve_device(device)
    tcfg = cfg.train
    if tcfg.debug_nans:
        enable_debug_nans(True)

    model = cfg.build_model()
    logdir = os.path.join(tcfg.logdir,
                          f"{cfg.model.model}_{cfg.model.inference}")
    os.makedirs(logdir, exist_ok=True)

    cache = load_cache(cfg.cache.basedir, "train")
    loader = Loader(cache, cfg.queue)
    if len(loader) == 0:
        raise SystemExit(
            f"cache has {len(cache)} images < batch_size "
            f"{cfg.queue.batch_size}; no full batch per epoch")
    log.info("train cache: %d images, %d classes, device %s", len(cache),
             model.num_classes, device)

    tx = make_optimizer(cfg.optimizer)
    ts = init_train_state(model, tx, torch.Generator().manual_seed(tcfg.seed),
                          cfg.model.dim, device)
    if init_weights:
        _load_init_weights(ts, model, init_weights, transfer)
        # the optimizer state (the EMA's starting copy) follows the weights
        ts.opt_state = tx.init(ts.params())

    ckpt = Checkpointer(os.path.join(logdir, "ckpt"),
                        max_to_keep=tcfg.keep_checkpoints,
                        save_interval_steps=tcfg.save_steps)
    start_step, ts = ckpt.restore_latest(ts)
    if start_step is not None:
        log.info("resumed from step %d", start_step)

    compute_dtype = (torch.bfloat16 if tcfg.compute_dtype == "bfloat16"
                     else torch.float32)
    step_fn = make_train_step(
        model, tx, loss_cfg=cfg.loss_config(), aug_cfg=cfg.augment,
        augment=True, compute_dtype=compute_dtype, remat=tcfg.remat)
    msched = (
        MultiScaleSchedule(
            dims=tuple(range(tcfg.multi_scale_min, tcfg.multi_scale_max + 1,
                             model.downsample)),
            every=tcfg.multi_scale_every, seed=tcfg.seed)
        if tcfg.multi_scale and model.kind == "v2" else None)
    metrics_log = MetricsLogger(logdir, tensorboard=tcfg.tensorboard)
    timer = StepTimer()

    def batches():
        for epoch in itertools.count():
            yield from loader.epoch(epoch)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    batch_iter = batches()
    step0 = ts.step
    log.info("training from step %d to %d", step0, tcfg.steps)
    interrupted = False
    try:
        for step_i in range(step0, tcfg.steps):
            host_batch = next(batch_iter)
            batch = tuple(torch.from_numpy(a).to(device) for a in host_batch)
            dim = msched.dim_at(step_i) if msched else cfg.model.dim
            want_grads = bool(tcfg.histogram_steps) and (
                (step_i + 1) % tcfg.histogram_steps == 0)
            trace_dir = (os.path.join(logdir, "profile")
                         if tcfg.profile_steps
                         and step_i == tcfg.profile_steps else None)
            with profile_trace(trace_dir), timer:
                ts, m = step_fn(ts, batch, tcfg.seed + 1, dim,
                                with_grads=want_grads)
                sync()  # the timer reads the device's step time
            grads = m.pop("grads", None)
            summary = (step_i + 1) % tcfg.summary_steps == 0
            if summary:
                m_host = {k: float(v) for k, v in m.items()}
                imgs_per_sec = cfg.queue.batch_size / timer.last
                m_host["images_per_sec"] = imgs_per_sec
                m_host["dim"] = dim
                metrics_log.log(step_i + 1, m_host)
                log.info(
                    "step %d dim %d loss %.4f (coord %.3f obj %.3f noobj "
                    "%.3f cls %.3f) %.1f img/s", step_i + 1, dim,
                    m_host["total"], m_host["coord"], m_host["object"],
                    m_host["noobject"], m_host["class"], imgs_per_sec)
                # a non-finite loss makes every later step garbage: halt,
                # with the state saved apart from the restart chain
                if tcfg.halt_on_nonfinite and not math.isfinite(
                        m_host["total"]):
                    log.error("non-finite loss %s at step %d; saving "
                              "diverged state for forensics and halting "
                              "(latest good checkpoint: step %s)",
                              m_host["total"], step_i + 1, ckpt.latest_step())
                    Checkpointer(os.path.join(logdir, "diverged"),
                                 max_to_keep=1).save(step_i + 1, ts,
                                                     force=True)
                    raise SystemExit(3)
            if want_grads:
                metrics_log.log_histograms(step_i + 1, ts.params())
                metrics_log.log_histograms(step_i + 1, grads,
                                           prefix="hist/grad/")
            if tcfg.eval_steps and (step_i + 1) % tcfg.eval_steps == 0:
                try:
                    val_cache = load_cache(cfg.cache.basedir, "val")
                except FileNotFoundError:
                    val_cache = None
                if val_cache is not None:
                    em = evaluate_model(
                        model, ts.net, val_cache,
                        input_dim=cfg.model.dim,
                        batch_size=cfg.eval.batch_size,
                        nms_iou=cfg.detect.nms_iou,
                        top_k=cfg.detect.top_k,
                        map_iou=cfg.eval.map_iou,
                        use_pallas=cfg.detect.use_pallas,
                        candidates=cfg.detect.candidates,
                        fuse_stem_impl=cfg.detect.fuse_stem,
                        compute_dtype=compute_dtype,
                        max_detections=cfg.eval.max_detections,
                        data_parallel=cfg.eval.data_parallel_flag(),
                        device=device,
                    )
                    metrics_log.log(step_i + 1, {"map": em["map"]},
                                    prefix="val_")
                    log.info("step %d val mAP@%.2f: %.4f", step_i + 1,
                             cfg.eval.map_iou, em["map"])
            if tcfg.image_summary_steps and (
                    (step_i + 1) % tcfg.image_summary_steps == 0):
                imgs, boxes, _, valid = host_batch
                metrics_log.log_image_with_boxes(step_i + 1, imgs[0],
                                                 boxes[0], valid[0])
            if ckpt.should_save(step_i + 1):
                ckpt.save(step_i + 1, ts)
    except KeyboardInterrupt:  # save before exiting (same restart contract)
        interrupted = True
        log.warning("interrupted at step %d; checkpointing", ts.step)
    finally:
        metrics_log.close()
    if ckpt.latest_step() != ts.step:
        ckpt.save(ts.step, ts, force=True)
    if interrupted:
        raise SystemExit(130)
    mean = timer.last if math.isnan(timer.mean) else timer.mean
    log.info("done: %d steps, mean %.3fs/step", tcfg.steps - step0, mean)
    return ts


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--init-weights", default="",
                        help="npz params to start from")
    parser.add_argument("--transfer", default="",
                        help="comma list of layer names to re-init (e.g. "
                             "the head conv, across class counts)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)
    return train(cfg, device=args.device, init_weights=args.init_weights,
                 transfer=args.transfer)


if __name__ == "__main__":
    main()
