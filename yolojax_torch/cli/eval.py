#!/usr/bin/env python3
"""Batched validation: device inference + NMS on the device -> VOC mAP
(and COCO metrics with ``--coco``) over a cached phase. Port of
``cli/eval.py`` for one process on one device.

Usage:

  python -m yolojax_torch.cli.eval -c config.ini --weights W.npz \\
      [--phase test] [--coco] [--dump out.json] [--max-batches N] \\
      [--device cpu] [section.key=value ...]

``--weights`` takes an ``.npz`` store or a training logdir / checkpoint
directory (``detect.use_ema=1``: its EMA weights).
``detect.fuse_stem=pallas`` (or ``auto``) runs conv0 + pool 1 as the CUDA
stem kernel. Convs run in f32 on the CPU and in bf16 on the card.
``detect.use_int8=1`` runs the int8 trunk, calibrated on the phase's first
``detect.calib_images`` images (``detect.calib_percentile``,
``detect.quant_bits``). Not ported yet (they raise NotImplementedError):
``--artifact``, ``eval.data_parallel=on`` and ``eval.distributed=1``.
"""

from __future__ import annotations

import json
import math

from yolojax_torch.data.cache import load_cache
from yolojax_torch.eval.evaluator import evaluate_model
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.restore import load_weights


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help=".npz param store or training logdir")
    parser.add_argument("--artifact", default="", help="not ported yet")
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
    if args.artifact:
        raise NotImplementedError("--artifact is not ported yet (ROADMAP "
                                  "queue 1, serving daemon and export)")
    if not args.weights:
        parser.error("--weights is required")

    model = cfg.build_model()
    names = cfg.names()
    cache = load_cache(cfg.cache.basedir, args.phase)
    metrics = evaluate_model(
        model, load_weights(args.weights, model, use_ema=cfg.detect.use_ema),
        cache,
        input_dim=cfg.model.dim,
        batch_size=cfg.eval.batch_size,
        nms_iou=cfg.detect.nms_iou,
        top_k=cfg.detect.top_k,
        map_iou=cfg.eval.map_iou,
        use_pallas=cfg.detect.use_pallas,
        candidates=cfg.detect.candidates,
        max_batches=args.max_batches or None,
        stretch=cfg.detect.stretch,
        fuse_stem_impl=cfg.detect.fuse_stem,
        bn_eps=cfg.model.bn_eps,
        max_detections=cfg.eval.max_detections,
        coco=args.coco,
        dump_path=args.dump or None,
        class_names=names,
        device=args.device,
        int8=cfg.detect.use_int8,
        calib_images=cfg.detect.calib_images,
        calib_percentile=cfg.detect.calib_percentile,
        quant_bits=cfg.detect.quant_bits,
        data_parallel=cfg.eval.data_parallel_flag(),
        distributed=cfg.eval.distributed,
    )
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
    return metrics


if __name__ == "__main__":
    main()
