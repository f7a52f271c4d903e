#!/usr/bin/env python3
"""Image detection on the port: load weights, fold BN, then one batched
forward + decode + top-K + greedy NMS on the device (the CUDA NMS kernel on
the card); only the outputs return to the host.

Port of ``cli/detect.py``. Usage:

  python -m yolojax_torch.cli.detect -c config.ini --weights W.npz \
      --image IMG [--image IMG2 ...] [--out OUT] [--device cpu]

``--weights`` takes an ``.npz`` store or a training logdir / checkpoint
directory (``detect.use_ema=1``: its EMA weights). ``detect.fuse_stem`` =
``pallas`` or ``auto`` runs conv0 + pool 1 as the CUDA stem kernel (its
plain version on the CPU), ``xla`` as the packed conv in PyTorch. Not
ported yet (they raise NotImplementedError): ``--artifact``, ``--stdin``,
``--data-parallel`` and ``detect.use_int8`` (with or without the fused
stem).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.loader import decode_image
from yolojax_torch.eval.evaluator import make_infer_fn, serving_weights
from yolojax_torch.nn.stem import fuse_stem
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.device import resolve_device
from yolojax_torch.utils.restore import load_weights

log = logging.getLogger("detect")


def _check_ported(cfg) -> None:
    if cfg.detect.use_int8:
        raise NotImplementedError("detect.use_int8: the int8 trunk is not "
                                  "ported yet (ROADMAP queue 1, int8)")


def build_serving(cfg, weights_path: str, *, device=None):
    """Load weights, fold BN, fuse the stem (``detect.fuse_stem``) and bind
    the serving program. Returns
    (names, dim, infer_fn(net, images), net, device): bf16 convs on the
    card, f32 on the CPU."""
    _check_ported(cfg)
    device = resolve_device(device)
    model = cfg.build_model()
    names = cfg.names()
    dim = cfg.model.dim
    net = load_weights(weights_path, model, use_ema=cfg.detect.use_ema)
    model, net = fold_bn(model, net, eps=cfg.model.bn_eps)
    model, net = fuse_stem(model, net, impl=cfg.detect.fuse_stem)
    compute = torch.float32 if device.type == "cpu" else torch.bfloat16
    net = serving_weights(net, device, compute)
    infer_fn = make_infer_fn(
        model, score_thresh=cfg.detect.threshold,
        iou_thresh=cfg.detect.nms_iou, top_k=cfg.detect.top_k,
        use_pallas=cfg.detect.use_pallas, candidates=cfg.detect.candidates,
        compute_dtype=compute,
    )
    return names, dim, infer_fn, net, device


def build_detector(cfg, weights_path: str, device=None):
    """Load weights and bind the serving program once. Returns
    (names, dim, infer(canvases) -> dict of numpy arrays). ``canvases``
    is an (N, dim, dim, 3) float batch, numpy or a tensor on any device."""
    names, dim, infer_fn, net, device = build_serving(cfg, weights_path,
                                                      device=device)

    def infer(canvases):
        x = torch.as_tensor(canvases).to(device, torch.float32).contiguous()
        out = infer_fn(net, x)
        return {k: v.cpu().numpy() for k, v in out.items()}

    return names, dim, infer


def _read_rgb(path: str) -> np.ndarray:
    try:
        return decode_image(path)
    except FileNotFoundError:
        raise SystemExit(f"unreadable image: {path}")


def _extract(out, k, tf, raw_shape, names):
    """Un-letterbox image k's kept boxes to original coords."""
    sx, sy, px, py = tf
    dets = []
    for d in np.where(out["keep"][k])[0]:
        y0, x0, y1, x1 = out["boxes"][k, d]
        x0 = (x0 - px) / sx * raw_shape[1]
        x1 = (x1 - px) / sx * raw_shape[1]
        y0 = (y0 - py) / sy * raw_shape[0]
        y1 = (y1 - py) / sy * raw_shape[0]
        cls = int(out["classes"][k, d])
        score = float(out["scores"][k, d])
        dets.append((names[cls], cls, score, (x0, y0, x1, y1)))
    return dets


def _annotate(raw_rgb, dets):
    import cv2

    from yolojax_torch.utils.draw import draw_detection

    img = cv2.cvtColor(np.ascontiguousarray(raw_rgb), cv2.COLOR_RGB2BGR)
    for name, cls, score, (x0, y0, x1, y1) in dets:
        draw_detection(img, int(x0), int(y0), int(x1), int(y1),
                       f"{name} {score:.2f}", cls)
    return img


def run_detect(cfg, weights_path: str,
               images: Sequence[Union[str, np.ndarray]],
               out_path: Optional[str] = None, show: bool = False,
               device=None, detector=None):
    """Detect on ``images``: file paths (binary PPM read with numpy, other
    formats with cv2) or decoded HWC RGB arrays. Prints one
    ``label: name score [x0, y0, x1, y1]`` line per detection and returns
    [(label, raw, dets)]. ``detector`` reuses a :func:`build_detector`
    result."""
    names, dim, infer = detector or build_detector(cfg, weights_path,
                                                   device=device)
    # one compiled batch shape in yolojax; here a fixed batch keeps the
    # cuDNN plans warm across groups
    batch = 1 if len(images) == 1 else min(max(cfg.eval.batch_size, 1), 32)
    results = []
    for start in range(0, len(images), batch):
        group = images[start: start + batch]
        raws, labels, canvases, tfs = [], [], [], []
        for j, image in enumerate(group):
            if isinstance(image, str):
                raw, label = _read_rgb(image), os.path.basename(image)
            else:
                raw, label = np.asarray(image), f"image{start + j}"
            canvas, tf = letterbox_host(raw, dim, stretch=cfg.detect.stretch)
            raws.append(raw)
            labels.append(label)
            canvases.append(canvas)
            tfs.append(tf)
        while len(canvases) < batch:  # pad to the fixed batch size
            canvases.append(torch.full((dim, dim, 3), 0.5))
        t0 = time.perf_counter()
        out = infer(torch.stack(canvases))
        dt = time.perf_counter() - t0
        for k, label in enumerate(labels):
            dets = _extract(out, k, tfs[k], raws[k].shape, names)
            for name, _, score, (x0, y0, x1, y1) in dets:
                print(f"{label}: {name} "
                      f"{score:.3f} [{x0:.0f}, {y0:.0f}, {x1:.0f}, {y1:.0f}]")
            log.info("%s: %d detections (batch of %d in %.1f ms)",
                     label, len(dets), len(group), dt * 1e3)
            results.append((label, raws[k], dets))

    if out_path and len(images) > 1:
        os.makedirs(out_path, exist_ok=True)
    for label, raw, dets in results:
        if out_path or show:
            import cv2

            img = _annotate(raw, dets)
            if out_path:
                fname = label if os.path.splitext(label)[1] else f"{label}.png"
                dst = out_path if len(images) == 1 else os.path.join(
                    out_path, fname)
                if cv2.imwrite(dst, img):
                    log.info("wrote %s", dst)
                else:
                    log.error("failed to write %s", dst)
            if show:  # pragma: no cover
                cv2.imshow("detect", img)
                cv2.waitKey(0)
    return results


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help=".npz param store or training logdir")
    parser.add_argument("--image", action="append", default=[],
                        help="image path (repeatable)")
    parser.add_argument("--out", default="", help="annotated output path/dir")
    parser.add_argument("--show", action="store_true",
                        help="display the annotated image")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--artifact", default="", help="not ported yet")
    parser.add_argument("--stdin", action="store_true", help="not ported yet")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported yet")
    args = parser.parse_args()
    cfg = setup(args)
    for flag, on in (("--artifact", args.artifact), ("--stdin", args.stdin),
                     ("--data-parallel", args.data_parallel)):
        if on:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP queue 1, config and CLIs)")
    if not args.weights:
        parser.error("--weights is required")
    if not args.image:
        parser.error("--image is required")
    run_detect(cfg, args.weights, args.image, args.out or None, args.show,
               device=args.device)


if __name__ == "__main__":
    main()
