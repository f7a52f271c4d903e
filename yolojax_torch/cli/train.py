#!/usr/bin/env python3
"""The training entry point: input pipeline + model + loss + optimizer,
resume from the latest checkpoint in the logdir, then the step loop with
summary, eval and checkpoint hooks. Port of ``cli/train.py``.

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
stem kernel. ``train.tensorboard=1`` also writes the scalars and
histograms as TensorBoard events in the logdir; ``queue.loader=grain``
reads through ``data/grain_loader.py`` and saves its stream state beside
each checkpoint.

Multi-device: one process per device, joined by ``train.coordinator`` /
``train.num_processes`` / ``train.process_id`` (``parallel/distributed.py``;
``nccl`` on the card, ``gloo`` on the CPU):

  python -m yolojax_torch.cli.train -c config.ini --device cpu \\
      train.coordinator=127.0.0.1:29500 train.num_processes=2 \\
      train.process_id=K                  # K = 0 and 1, one per process

The processes form a ``(train.mesh_data, train.mesh_model)`` mesh
(``mesh_data=0``: the processes left after ``mesh_model``). Each data rank
loads a disjoint shard at ``queue.batch_size / mesh_data`` a step; the
step is the one-device step on the global batch (``train/step.py``).
``train.mesh_model`` > 1 splits the output channels of the convs 1024 wide
and more over the model ranks, ``train.zero=1`` the optimizer buffers over
the data ranks (ZeRO-1). Only the primary logs, writes metrics and writes
checkpoints (in the one-device layout: any mesh resumes any logdir); the
in-training eval runs on the primary, or on every process with
``eval.distributed=1``. Not ported: ``train.profile_port`` (torch has no
profiler server; ``train.profile_steps`` writes a trace).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import math
import os

import numpy as np
import torch

from yolojax_torch.convert.interchange import (
    network_from_state_dict,
    tensors_from_jax,
)
from yolojax_torch.convert.store import load_params_npz
from yolojax_torch.data.cache import load_cache
from yolojax_torch.data.grain_loader import GrainLoader, make_loader
from yolojax_torch.eval.evaluator import evaluate_model
from yolojax_torch.parallel.distributed import (
    all_gather_numpy,
    global_batch,
    maybe_initialize,
    process_index,
    sync_done,
)
from yolojax_torch.parallel.mesh import make_mesh
from yolojax_torch.parallel.sharding import Plan
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

def _check_ported(cfg) -> None:
    if cfg.train.profile_port:
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


def _loader_state(logdir: str, rank: int, keep: int):
    """(save(step), restore(step)) of a grain stream's state, one file per
    process, ``loader_state/<step>.p<rank>.bin`` (each process streams its
    own shard), pruned with the checkpoints; the primary also takes, and
    then removes, the older one-file layout ``<step>.bin``."""
    state_dir = os.path.join(logdir, "loader_state")
    suffix = f".p{rank}.bin"

    def path(step):
        return os.path.join(state_dir, f"{int(step)}{suffix}")

    def save(stream, step):
        os.makedirs(state_dir, exist_ok=True)
        with open(path(step), "wb") as f:
            f.write(stream.get_state())
        kept = sorted((int(p[: -len(suffix)]) for p in os.listdir(state_dir)
                       if p.endswith(suffix)), reverse=True)
        for old in kept[max(keep, 1):]:
            os.unlink(path(old))
        if rank == 0:
            for p in os.listdir(state_dir):
                if p.endswith(".bin") and p[:-4].isdigit():
                    os.unlink(os.path.join(state_dir, p))

    def restore(stream, step):
        state_file = path(step)
        if not os.path.exists(state_file) and rank == 0:
            legacy = os.path.join(state_dir, f"{int(step)}.bin")
            if os.path.exists(legacy):
                state_file = legacy
        if os.path.exists(state_file):
            with open(state_file, "rb") as f:
                stream.set_state(f.read())
            log.info("restored grain loader state for step %d", step)
        else:
            log.warning("no loader state for step %d; grain stream "
                        "restarts from its seed", step)

    return save, restore


def train(cfg, *, device=None, init_weights: str = "", transfer: str = ""):
    """Run ``cfg``'s training; returns this process's final train state."""
    _check_ported(cfg)
    tcfg = cfg.train
    multi_process = maybe_initialize(
        tcfg.coordinator, tcfg.num_processes, tcfg.process_id, device=device)
    device = resolve_device(device)
    if tcfg.debug_nans:
        enable_debug_nans(True)
    mesh = make_mesh(data=tcfg.mesh_data or None, model=tcfg.mesh_model)
    rank = process_index()
    is_primary = rank == 0

    model = cfg.build_model()
    logdir = os.path.join(tcfg.logdir,
                          f"{cfg.model.model}_{cfg.model.inference}")
    os.makedirs(logdir, exist_ok=True)

    cache = load_cache(cfg.cache.basedir, "train")
    queue_cfg = cfg.queue
    if mesh.data > 1:
        # each data rank loads a disjoint shard: its share of the batch
        if queue_cfg.batch_size % mesh.data:
            raise ValueError(f"queue.batch_size {queue_cfg.batch_size} does "
                             f"not split over data={mesh.data}")
        queue_cfg = dataclasses.replace(
            queue_cfg, batch_size=queue_cfg.batch_size // mesh.data,
            shard_index=mesh.data_index, shard_count=mesh.data)
    loader = make_loader(cache, queue_cfg, queue_cfg.loader)
    if len(loader) == 0:
        raise SystemExit(
            f"cache has {len(cache)} images < batch_size "
            f"{cfg.queue.batch_size}; no full batch per epoch")
    log.info("train cache: %d images, %d classes, device %s", len(cache),
             model.num_classes, device)
    log.info("mesh: %s over %d processes", mesh.shape, mesh.size)

    tx = make_optimizer(cfg.optimizer)
    ts = init_train_state(model, tx, torch.Generator().manual_seed(tcfg.seed),
                          cfg.model.dim, device)
    if init_weights:
        _load_init_weights(ts, model, init_weights, transfer)
        # the optimizer state (the EMA's starting copy) follows the weights
        ts.opt_state = tx.init(ts.params())
    if mesh.size > 1:
        # every rank made the same full state from the seed: keep its pieces
        # (the wide convs' channels over model ranks; with train.zero the
        # optimizer buffers over data ranks)
        plan = Plan(mesh, zero=tcfg.zero)
        plan.shard(ts)
        if plan.zero:
            log.info("ZeRO-1: optimizer state sharded over data=%d",
                     mesh.data)

    ckpt = Checkpointer(os.path.join(logdir, "ckpt"),
                        max_to_keep=tcfg.keep_checkpoints,
                        save_interval_steps=tcfg.save_steps,
                        primary=is_primary if multi_process else None)
    start_step, ts = ckpt.restore_latest(ts)
    if start_step is not None:
        log.info("resumed from step %d", start_step)
    sync_done()  # every rank has read the logdir before the primary writes
    # the weights split over model ranks are gathered for histograms and
    # the eval: a collective that every process enters together
    gather_weights = mesh.model > 1
    eval_dist = cfg.eval.distributed and multi_process

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
    metrics_log = (MetricsLogger(logdir, tensorboard=tcfg.tensorboard)
                   if is_primary else None)
    timer = StepTimer()

    def batches():
        for epoch in itertools.count():
            yield from loader.epoch(epoch)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # grain: the checkpointable endless stream, its state saved beside
    # every checkpoint, so a resume continues mid-epoch exactly
    grain_stream = loader.stream() if isinstance(loader, GrainLoader) \
        else None
    batch_iter = grain_stream if grain_stream is not None else batches()
    save_stream, restore_stream = _loader_state(logdir, rank,
                                                tcfg.keep_checkpoints)
    if grain_stream is not None and start_step is not None:
        restore_stream(grain_stream, start_step)

    def save(step, state, force=False):
        if ckpt.save(step, state, force=force) and grain_stream is not None:
            save_stream(grain_stream, step)

    step0 = ts.step
    log.info("training from step %d to %d", step0, tcfg.steps)
    interrupted = False
    try:
        for step_i in range(step0, tcfg.steps):
            host_batch = next(batch_iter)
            batch = global_batch(host_batch, device)
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
            if (step_i + 1) % tcfg.summary_steps == 0:
                # the metrics are the global batch's on every rank
                m_host = {k: float(v) for k, v in m.items()}
                imgs_per_sec = cfg.queue.batch_size / timer.last
                m_host["images_per_sec"] = imgs_per_sec
                m_host["dim"] = dim
                if is_primary:
                    metrics_log.log(step_i + 1, m_host)
                    log.info(
                        "step %d dim %d loss %.4f (coord %.3f obj %.3f "
                        "noobj %.3f cls %.3f) %.1f img/s", step_i + 1, dim,
                        m_host["total"], m_host["coord"], m_host["object"],
                        m_host["noobject"], m_host["class"], imgs_per_sec)
                # a non-finite loss makes every later step garbage: halt
                # (every rank alike), with the state saved apart from the
                # restart chain
                if tcfg.halt_on_nonfinite and not math.isfinite(
                        m_host["total"]):
                    log.error("non-finite loss %s at step %d; saving "
                              "diverged state for forensics and halting "
                              "(latest good checkpoint: step %s)",
                              m_host["total"], step_i + 1, ckpt.latest_step())
                    Checkpointer(os.path.join(logdir, "diverged"),
                                 max_to_keep=1, primary=ckpt.primary).save(
                        step_i + 1, ts, force=True)
                    raise SystemExit(3)
            if want_grads and (is_primary or gather_weights):
                params = ts.params()
                if gather_weights:
                    params = ts.plan.full_tree(params)
                    grads = ts.plan.full_tree(grads)
                if is_primary:
                    metrics_log.log_histograms(step_i + 1, params)
                    metrics_log.log_histograms(step_i + 1, grads,
                                               prefix="hist/grad/")
            if (tcfg.eval_steps and (step_i + 1) % tcfg.eval_steps == 0
                    and (is_primary or eval_dist or gather_weights)):
                _in_training_eval(cfg, model, ts, step_i + 1, device,
                                  compute_dtype, metrics_log,
                                  collective=eval_dist or (
                                      multi_process and gather_weights),
                                  distributed=eval_dist, gather=gather_weights)
            if is_primary and tcfg.image_summary_steps and (
                    (step_i + 1) % tcfg.image_summary_steps == 0):
                imgs, boxes, _, valid = host_batch
                metrics_log.log_image_with_boxes(step_i + 1, imgs[0],
                                                 boxes[0], valid[0])
            if ckpt.should_save(step_i + 1):
                save(step_i + 1, ts)
    except KeyboardInterrupt:  # save before exiting (same restart contract)
        interrupted = True
        log.warning("interrupted at step %d; checkpointing", ts.step)
    finally:
        if metrics_log is not None:
            metrics_log.close()
    if ckpt.latest_step() != ts.step:
        save(ts.step, ts, force=True)
    sync_done()  # no process leaves while another still writes
    if interrupted:
        raise SystemExit(130)
    mean = timer.last if math.isnan(timer.mean) else timer.mean
    log.info("done: %d steps, mean %.3fs/step", tcfg.steps - step0, mean)
    return ts


def _in_training_eval(cfg, model, ts, step: int, device, compute_dtype,
                      metrics_log, *, collective: bool, distributed: bool,
                      gather: bool) -> None:
    """val-phase mAP of the current weights. Default: the primary alone
    evaluates (the others go on to the next step's collectives). With
    ``distributed`` every process evaluates its shard and the rows are
    all-gathered. ``collective``: every process is here, so they first
    agree on whether the val cache exists (a partly synced filesystem would
    otherwise leave some in a collective the others skip)."""
    try:
        val_cache = load_cache(cfg.cache.basedir, "val")
    except FileNotFoundError:
        val_cache = None
    if collective:
        have = all_gather_numpy(np.asarray([val_cache is not None],
                                           np.int64))
        if not have.all():
            if val_cache is not None:
                log.warning("val cache visible on this process but missing "
                            "on others; skipping eval at step %d", step)
            val_cache = None
    if val_cache is None:
        return
    net = ts.net
    if gather:  # the full weights, on every process
        net = network_from_state_dict(
            model, ts.plan.full_state_dict(ts)).to(device)
    if process_index() != 0 and not distributed:
        return
    em = evaluate_model(
        model, net, val_cache,
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
        distributed=distributed,
        device=device,
    )
    if metrics_log is not None:
        metrics_log.log(step, {"map": em["map"]}, prefix="val_")
        log.info("step %d val mAP@%.2f: %.4f", step, cfg.eval.map_iou,
                 em["map"])


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
