#!/usr/bin/env python3
"""Export a serving artifact: the serving program frozen into one file.

Port of ``cli/export.py``. Builds the exact serving program that
``cli/detect.py`` serves (weight load, BN fold, ``detect.fuse_stem`` or the
int8 trunk, forward + decode + top-K + NMS) and writes it with
``torch.export`` (``yolojax_torch/serve``): weights inside, class names,
input dim and thresholds in the header, the three hand kernels as custom
operators in the graph. The artifact then serves through
``cli.detect --artifact``, ``cli.eval --artifact`` and ``cli.serve
--artifact`` on a host of the same platform: no config ``[model]``
section, no weight file, no model code.

``--format savedmodel`` (a TF SavedModel directory for TF Serving hosts)
and ``--format tflite`` (one flatbuffer for the TFLite interpreter) write
the portable program (f32, the plain NMS sweep, no fused bf16 stem) as a
TensorFlow graph from the folded weights (``serve/tf_graph.py``); they need
``tensorflow`` and run on the CPU. ``--device`` is where the weights load
and int8 calibrates. An int8 program exports as a SavedModel only.

Usage: python -m yolojax_torch.cli.export -c config.ini --weights W \\
           --out model.yjts [--device cpu]
       [--batch N]                 fixed serving batch (default 1)
       [--calib-image IMG ...]     int8 calibration inputs (with
                                   detect.use_int8=1)
       [--format savedmodel|tflite [--tflite-mode graph]]
"""

from __future__ import annotations

import logging

from yolojax_torch.cli.detect import _read_rgb, build_serving
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.serve import save_artifact
from yolojax_torch.serve.tf_graph import export_spec
from yolojax_torch.serve.tflite import check_exportable
from yolojax_torch.utils.cli import make_parser, setup

log = logging.getLogger("export")


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", required=True,
                        help=".npz param store or training logdir")
    parser.add_argument("--out", required=True,
                        help="artifact output path (suggest .yjts; a "
                             "directory for --format savedmodel)")
    parser.add_argument("--format", choices=("artifact", "savedmodel",
                                             "tflite"),
                        default="artifact",
                        help="'artifact': a torch.export program for the "
                             "export's device (default). 'savedmodel': a TF "
                             "SavedModel directory (portable CPU graph) for "
                             "TF Serving hosts. 'tflite': one .tflite "
                             "flatbuffer of TFLite builtins for edge hosts; "
                             "both need tensorflow")
    parser.add_argument("--tflite-mode", choices=("graph", "stablehlo"),
                        default="graph",
                        help="tflite lowering: 'graph' = TF ops -> TFLite "
                             "builtins (default); 'stablehlo' is yolojax's "
                             "and is refused here")
    parser.add_argument("--batch", type=int, default=1,
                        help="fixed serving batch baked into the artifact "
                             "(default 1; --stdin serving needs 1)")
    parser.add_argument("--calib-image", action="append", default=[],
                        help="calibration image for the int8 trunk "
                             "(repeatable; every listed image is used, "
                             "with detect.use_int8=1)")
    parser.add_argument("--allow-synthetic-calib", action="store_true",
                        help="permit int8 export without --calib-image "
                             "(activation scales calibrated on noise: "
                             "degraded accuracy baked into the artifact)")
    parser.add_argument("--device", default=None,
                        help="torch device to export for (default: the "
                             "CUDA card); the artifact runs only there")
    args = parser.parse_args()
    cfg = setup(args)
    if args.batch < 1:
        parser.error("--batch must be >= 1")
    if (cfg.detect.use_int8 and not args.calib_image
            and not args.allow_synthetic_calib):
        # unlike the live detect CLI (a per-run fallback), export freezes
        # the calibration into the shipped artifact
        parser.error(
            "int8 export requires --calib-image (repeatable) so the baked "
            "activation scales come from real data; pass "
            "--allow-synthetic-calib to override")
    portable = args.format in ("savedmodel", "tflite")
    if args.format == "tflite":
        check_exportable(args.tflite_mode, bool(cfg.detect.use_int8))
    if portable:
        try:
            import tensorflow  # noqa: F401
        except ImportError as e:
            raise SystemExit(
                f"--format {args.format} needs tensorflow, which does not "
                f"import here ({e}); nothing was written")

    calib = None
    if cfg.detect.use_int8 and args.calib_image:
        # the explicit --calib-image list wins over detect.calib_images:
        # truncating it would bake other scales into the artifact
        calib = [letterbox_host(_read_rgb(p), cfg.model.dim,
                                stretch=cfg.detect.stretch)[0]
                 for p in args.calib_image]
    names, dim, infer_fn, net, device = build_serving(
        cfg, args.weights, calib, device=args.device, portable=portable)
    header = {
        "names": list(names),
        "model": f"{cfg.model.model}/{cfg.model.inference}",
        "threshold": cfg.detect.threshold,
        "nms_iou": cfg.detect.nms_iou,
        "top_k": cfg.detect.top_k,
        "stretch": bool(cfg.detect.stretch),
        "int8": bool(cfg.detect.use_int8),
    }
    if portable:
        return _export_tf(args, cfg, export_spec(infer_fn.model, net,
                                                 infer_fn.qm), dim, header)
    meta = save_artifact(args.out, infer_fn, net, batch=args.batch, dim=dim,
                         meta=header, device=device)
    log.info("exported %s: %s dim %d batch %d platforms %s (%.1f MB)",
             args.out, meta["model"], meta["dim"], meta["batch"],
             meta["platforms"], meta["payload_bytes"] / 1e6)
    print(f"{args.out}: {meta['model']} dim={meta['dim']} "
          f"batch={meta['batch']} platforms={','.join(meta['platforms'])} "
          f"{meta['payload_bytes'] / 1e6:.1f} MB")
    return meta


def _export_tf(args, cfg, spec, dim: int, header: dict) -> dict:
    """Write ``spec`` as a SavedModel or a TFLite file; print yolojax's
    line."""
    kw = dict(batch=args.batch, dim=dim, meta=header,
              score_thresh=cfg.detect.threshold,
              iou_thresh=cfg.detect.nms_iou, top_k=cfg.detect.top_k)
    if args.format == "savedmodel":
        from yolojax_torch.serve.savedmodel import save_savedmodel

        meta = save_savedmodel(args.out, spec, **kw)
        log.info("exported SavedModel %s: %s dim %d batch %d", args.out,
                 meta["model"], meta["dim"], meta["batch"])
        print(f"{args.out}: {meta['model']} dim={meta['dim']} "
              f"batch={meta['batch']} format=savedmodel platforms=cpu")
        return meta
    from yolojax_torch.serve.tflite import save_tflite

    meta = save_tflite(args.out, spec, mode=args.tflite_mode, **kw)
    log.info("exported TFLite %s: %s dim %d batch %d mode %s (%.1f MB)",
             args.out, meta["model"], meta["dim"], meta["batch"],
             meta["conversion"], meta["payload_bytes"] / 1e6)
    print(f"{args.out}: {meta['model']} dim={meta['dim']} "
          f"batch={meta['batch']} format=tflite "
          f"conversion={meta['conversion']} "
          f"{meta['payload_bytes'] / 1e6:.1f} MB")
    return meta


if __name__ == "__main__":
    main()
