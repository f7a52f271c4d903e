#!/usr/bin/env python3
"""Batched validation: device inference + NMS on the device -> VOC mAP
(and COCO metrics with ``--coco``) over a cached phase. Port of
``cli/eval.py``.

Usage:

  python -m yolojax_torch.cli.eval -c config.ini --weights W.npz \\
      [--phase test] [--coco] [--dump out.json] [--max-batches N] \\
      [--device cpu] [section.key=value ...]
  ... --artifact m.yjts   # score an exported artifact (cli/export.py)

``--weights`` takes an ``.npz`` store, a Darknet ``.weights`` file, a TF1
checkpoint prefix or a training logdir / checkpoint directory
(``detect.use_ema=1``: its EMA weights).
``detect.fuse_stem=pallas`` (or ``auto``) runs conv0 + pool 1 as the CUDA
stem kernel. Convs run in f32 on the CPU and in bf16 on the card.
``detect.use_int8=1`` runs the int8 trunk, calibrated on the phase's first
``detect.calib_images`` images (``detect.calib_percentile``,
``detect.quant_bits``). ``--artifact`` scores the baked program of an
exported artifact (its thresholds, top-K, NMS and precision; ``detect.*``
settings do not apply), exactly as a deployment host runs it.
``eval.data_parallel`` (auto | on | off) splits each batch over the
process's CUDA devices. Several processes (``train.coordinator`` /
``train.num_processes`` / ``train.process_id``, as ``cli.train`` takes
them): with ``eval.distributed=1`` each evaluates its strided shard of the
cache and the detections are all-gathered; otherwise the primary alone
evaluates while the others wait. The primary prints.
"""

from __future__ import annotations

import json
import logging
import math

from yolojax_torch.cli.detect import load_artifact_detector, sync_artifact_cfg
from yolojax_torch.data.cache import load_cache
from yolojax_torch.eval.evaluator import EVAL_SCORE_THRESH, evaluate_model
from yolojax_torch.parallel.distributed import (
    maybe_initialize,
    process_index,
    sync_done,
)
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.restore import load_weights


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help=".npz param store or training logdir")
    parser.add_argument("--artifact", default="",
                        help="score a serving artifact (cli/export.py) "
                             "instead of live weights: its baked program is "
                             "what gets mAP'd")
    parser.add_argument("--phase", default="test")
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--coco", action="store_true",
                        help="also report COCO-style AP@[.50:.95], AP75, "
                             "size-binned APs and ARs")
    parser.add_argument("--dump", default="",
                        help="write the eval set + detections as one "
                             "COCO-format JSON ({'gt': ..., 'detections': "
                             "...})")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)
    if bool(args.weights) == bool(args.artifact):
        parser.error("exactly one of --weights or --artifact is required")
    multi_process = maybe_initialize(
        cfg.train.coordinator, cfg.train.num_processes, cfg.train.process_id,
        device=args.device)
    eval_dist = cfg.eval.distributed and multi_process and not args.artifact
    if multi_process and not eval_dist and process_index() != 0:
        sync_done()  # the primary evaluates alone; wait for it
        return None
    try:
        metrics, names = _evaluate(cfg, args, eval_dist)
    finally:
        if multi_process and not eval_dist:
            # release the waiting processes even when the primary fails
            sync_done()
    if multi_process and process_index() != 0:
        return metrics  # the same global metrics; the primary prints
    _print_metrics(cfg, args, names, metrics)
    return metrics


def _evaluate(cfg, args, distributed: bool):
    cache = load_cache(cfg.cache.basedir, args.phase)
    # shared verbatim by both branches: a drift between them would skew
    # the live-vs-artifact metric parity the artifact mode exists to show
    shared = dict(
        map_iou=cfg.eval.map_iou,
        max_batches=args.max_batches or None,
        max_detections=cfg.eval.max_detections,
        coco=args.coco,
        dump_path=args.dump or None,
    )
    if args.artifact:  # the artifact owns its device: no eval.data_parallel
        (names, dim, infer_art, fixed_batch), meta = load_artifact_detector(
            args.artifact, args.device)
        cfg = sync_artifact_cfg(cfg, meta)
        baked = float(meta.get("threshold", EVAL_SCORE_THRESH))
        if baked > EVAL_SCORE_THRESH:
            # PR curves need the low-confidence tail: say why the mAP is
            # not comparable to a --weights eval
            logging.getLogger("eval").warning(
                "artifact bakes detect.threshold=%g > the eval protocol's "
                "%g: mAP/AR will undercount the PR tail; export with "
                "detect.threshold=%g for metrics comparable to --weights "
                "eval", baked, EVAL_SCORE_THRESH, EVAL_SCORE_THRESH)
        metrics = evaluate_model(
            None, None, cache, input_dim=dim, batch_size=fixed_batch,
            stretch=cfg.detect.stretch, class_names=names,
            infer_override=infer_art, fixed_batch=fixed_batch,
            num_classes=len(names), **shared)
    else:
        model = cfg.build_model()
        names = cfg.names()
        metrics = evaluate_model(
            model,
            load_weights(args.weights, model, cfg.model.dim,
                         use_ema=cfg.detect.use_ema),
            cache,
            input_dim=cfg.model.dim,
            batch_size=cfg.eval.batch_size,
            nms_iou=cfg.detect.nms_iou,
            top_k=cfg.detect.top_k,
            use_pallas=cfg.detect.use_pallas,
            candidates=cfg.detect.candidates,
            stretch=cfg.detect.stretch,
            fuse_stem_impl=cfg.detect.fuse_stem,
            class_names=names,
            device=args.device,
            int8=cfg.detect.use_int8,
            calib_images=cfg.detect.calib_images,
            calib_percentile=cfg.detect.calib_percentile,
            quant_bits=cfg.detect.quant_bits,
            data_parallel=cfg.eval.data_parallel_flag(),
            distributed=distributed,
            **shared,
        )
    return metrics, names


def _print_metrics(cfg, args, names, metrics) -> None:
    for c, name in enumerate(names):
        if f"ap_{c}" in metrics:
            print(f"AP {name:>16s}: {metrics[f'ap_{c}']:.4f}")
    print(f"mAP@{cfg.eval.map_iou}: {metrics['map']:.4f} "
          f"({metrics['num_images']} images)")
    if args.coco:
        print(f"COCO AP@[.50:.95]: {metrics['coco_map']:.4f}  "
              f"AP50: {metrics.get('ap50', float('nan')):.4f}  "
              f"AP75: {metrics.get('ap75', float('nan')):.4f}  "
              f"S/M/L: {metrics.get('ap_small', float('nan')):.3f}/"
              f"{metrics.get('ap_medium', float('nan')):.3f}/"
              f"{metrics.get('ap_large', float('nan')):.3f}")
        print(f"COCO AR@1/10/100: {metrics.get('ar_1', float('nan')):.4f}/"
              f"{metrics.get('ar_10', float('nan')):.4f}/"
              f"{metrics.get('ar_100', float('nan')):.4f}  "
              f"AR S/M/L: {metrics.get('ar_small', float('nan')):.3f}/"
              f"{metrics.get('ar_medium', float('nan')):.3f}/"
              f"{metrics.get('ar_large', float('nan')):.3f}")
    # strict JSON: NaN (empty size bin) -> null
    print(json.dumps({
        k: (None if isinstance(v, float) and math.isnan(v) else v)
        for k, v in metrics.items()
    }))


if __name__ == "__main__":
    main()
