#!/usr/bin/env python3
"""Image detection on the port: load weights, fold BN, then one batched
forward + decode + top-K + greedy NMS on the device (the CUDA NMS kernel on
the card); only the outputs return to the host.

Port of ``cli/detect.py``. Usage:

  python -m yolojax_torch.cli.detect -c config.ini --weights W.npz \
      --image IMG [--image IMG2 ...] [--out OUT] [--device cpu]
  ... --weights W.npz --stdin [--out DIR]   # serve: one image path per
                                            # line, weights loaded once
  ... --artifact m.yjts --image IMG          # an exported serving artifact
                                            # (cli/export.py), also --stdin

``--weights`` takes an ``.npz`` store, a Darknet ``.weights`` file, a TF1
checkpoint prefix or a training logdir / checkpoint directory
(``detect.use_ema=1``: its EMA weights). ``detect.fuse_stem`` =
``pallas`` or ``auto`` runs conv0 + pool 1 as the CUDA stem kernel (its
plain version on the CPU), ``xla`` as the packed conv in PyTorch.
``detect.use_int8=1`` runs the int8 trunk (``quantize/ptq.py``), calibrated
on the first ``detect.calib_images`` inputs; with ``detect.fuse_stem`` not
off its conv0 + pool 1 is the packed int8 stem. ``--artifact`` serves an
exported artifact instead (names, dim, thresholds and the letterbox style
come from its header; ``--stdin`` needs one exported with batch 1).
``--data-parallel`` (several ``--image``s with ``--weights``) splits each
batch over the process's CUDA devices, a replica of the program on each;
with one device it warns and serves on that one.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.loader import decode_image
from yolojax_torch.eval.evaluator import (
    check_servable,
    data_parallel_infer,
    local_devices,
    make_infer_fn,
    replicate,
    serving_weights,
)
from yolojax_torch.nn.stem import fuse_stem
from yolojax_torch.quantize.ptq import fuse_stem_int8, quantize_model
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.device import resolve_device
from yolojax_torch.utils.profiling import span
from yolojax_torch.utils.restore import load_weights

log = logging.getLogger("detect")


# the int8 fallback calibration batch when no input canvases are given
SYNTHETIC_CALIB_SEED, SYNTHETIC_CALIB_IMAGES = 9, 8


def build_serving(cfg, weights_path: str, calib_canvases=None, *,
                  device=None, portable: bool = False):
    """Load weights, fold BN, then either fuse the stem
    (``detect.fuse_stem``) or, with ``detect.use_int8``, quantize the trunk
    on ``calib_canvases`` (letterboxed input canvases; a seeded synthetic
    batch, with a warning, when there are none) and fuse the int8 stem when
    ``detect.fuse_stem`` is not off. Bind the serving program. Returns
    (names, dim, infer_fn(net, images), net, device): bf16 convs on the
    card, f32 on the CPU; the int8 program reads no ``net``;
    ``infer_fn.model`` is the model it runs.

    ``portable``: the program the TF exports write (``serve/tf_graph.py``),
    as yolojax's portable build: f32 convs on any device, the plain NMS
    sweep, exact top-K, and no fused bf16 stem (the int8 stem stays, as in
    yolojax)."""
    device = resolve_device(device)
    model = cfg.build_model()
    check_servable(model, int8=cfg.detect.use_int8,
                   fuse_stem=cfg.detect.fuse_stem, portable=portable)
    names = cfg.names()
    dim = cfg.model.dim
    net = load_weights(weights_path, model, dim, use_ema=cfg.detect.use_ema)
    # BN folds at the forward's 1e-5, as yolojax's detect does: it never
    # reads [model] bn_eps
    model, net = fold_bn(model, net)
    compute = (torch.float32 if portable or device.type == "cpu"
               else torch.bfloat16)
    qm = None
    if cfg.detect.use_int8:
        if calib_canvases is not None and len(calib_canvases):
            calib = torch.stack([torch.as_tensor(c) for c in calib_canvases])
            log.info("int8 conv trunk enabled (calibrated on %d input images, "
                     "percentile %.4g)", len(calib_canvases),
                     cfg.detect.calib_percentile)
        else:
            calib = torch.rand(
                (SYNTHETIC_CALIB_IMAGES, dim, dim, 3),
                generator=torch.Generator().manual_seed(SYNTHETIC_CALIB_SEED))
            log.warning("int8 calibration falling back to synthetic inputs")
        net = net.to(device).requires_grad_(False).eval()
        qm = quantize_model(model, net,
                            calib.to(device, torch.float32).contiguous(),
                            percentile=cfg.detect.calib_percentile,
                            bits=cfg.detect.quant_bits)
        if cfg.detect.fuse_stem != "off":
            # bit-exact phase-packed conv0 + pool, opt-in like the bf16 stem
            qm = fuse_stem_int8(qm)
    else:
        stem_impl = cfg.detect.fuse_stem
        if portable and stem_impl != "off":
            log.warning("portable export: detect.fuse_stem=%s disabled "
                        "(fused stems are TPU-layout-specific)", stem_impl)
            stem_impl = "off"
        model, net = fuse_stem(model, net, impl=stem_impl)
        net = serving_weights(net, device, compute)
    use_pallas, candidates = (("never", "exact") if portable else
                              (cfg.detect.use_pallas, cfg.detect.candidates))
    infer_fn = make_infer_fn(
        model, score_thresh=cfg.detect.threshold,
        iou_thresh=cfg.detect.nms_iou, top_k=cfg.detect.top_k,
        use_pallas=use_pallas, candidates=candidates,
        compute_dtype=compute, qm=qm,
    )
    return names, dim, infer_fn, net, device


def data_parallel_devices(device, data_parallel: bool) -> list:
    """The devices a ``--data-parallel`` program splits a batch over: every
    local CUDA device, or (with a warning when it was asked for) the one."""
    device = resolve_device(device)
    if not data_parallel:
        return [device]
    devices = local_devices(device)
    if len(devices) > 1:
        log.info("detector: data-parallel over %d local devices",
                 len(devices))
        return devices
    log.warning("data_parallel requested but only 1 local device; serving "
                "single-device")
    return [device]


def build_detector(cfg, weights_path: str, calib_canvases=None, device=None,
                   data_parallel: bool = False):
    """Load weights and bind the serving program once. Returns
    (names, dim, infer(canvases) -> dict of numpy arrays). ``canvases``
    is an (N, dim, dim, 3) float batch, numpy or a tensor on any device.
    ``calib_canvases``: int8 calibration canvases (see
    :func:`build_serving`). ``data_parallel``: split each batch over the
    local CUDA devices (the batch must split evenly; the int8 constants
    are replicated too)."""
    devices = data_parallel_devices(device, data_parallel)
    names, dim, infer_fn, net, device = build_serving(
        cfg, weights_path, calib_canvases, device=device)
    if len(devices) > 1:
        qm = infer_fn.qm
        return names, dim, data_parallel_infer(
            infer_fn, replicate(None if qm is not None else net, qm, devices))

    calls = itertools.count()

    def infer(canvases):
        call = next(calls)
        src = torch.as_tensor(canvases)
        moved = src.numel() * 4 if src.device.type == "cpu" else 0
        with span("detect.upload", call, moved):
            x = src.to(device, torch.float32).contiguous()
        with span("detect.dispatch", call):
            out = infer_fn(net, x)
        with span("detect.readback", call):
            return {k: v.cpu().numpy() for k, v in out.items()}

    return names, dim, infer


def load_artifact_detector(artifact_path: str, device=None):
    """Serve from an exported artifact (``cli/export.py``): names, dim and
    thresholds come from its header, the program from its payload; no
    config ``[model]`` section or weight file is read. Returns
    ((names, dim, infer(canvases) -> dict of numpy arrays, fixed_batch),
    meta)."""
    from yolojax_torch.serve import load_artifact

    art = load_artifact(artifact_path, device=device)
    log.info("serving artifact: dim %d batch %d platforms %s (%d classes)",
             art.meta["dim"], art.meta["batch"], art.meta["platforms"],
             len(art.meta["names"]))

    def infer(canvases):
        x = torch.as_tensor(canvases).to(art.device, torch.float32)
        return {k: v.cpu().numpy() for k, v in art(x.contiguous()).items()}

    return (tuple(art.meta["names"]), int(art.meta["dim"]), infer,
            int(art.meta["batch"])), art.meta


def sync_artifact_cfg(cfg, meta):
    """The config with the letterbox style the artifact was exported for:
    host preprocessing must agree with the baked program."""
    import dataclasses

    return dataclasses.replace(cfg, detect=dataclasses.replace(
        cfg.detect, stretch=bool(meta.get("stretch", cfg.detect.stretch))))


class LazyDetector:
    """Deferred detector build for the stream (``--stdin``): buffers the
    first ``detect.calib_images`` readable frames so int8 activation scales
    calibrate on real inputs, then builds once and drains the queue in
    arrival order. Frameless responses (unreadable-path errors) queue
    behind buffered frames so output order always matches input order;
    they emit at once when nothing is buffered.

    ``process(item)`` is the per-frame callback; it reads ``self.infer``
    and ``self.names`` (bound by :meth:`flush`, or :meth:`bind` for an
    exported artifact, where nothing is buffered)."""

    def __init__(self, cfg, weights_path: str, process, device=None):
        self._cfg = cfg
        self._weights = weights_path
        self._process = process
        self._device = device
        self._pending = []  # ("frame", canvas, item) | ("call", fn)
        self.calib_target = (max(cfg.detect.calib_images, 1)
                             if cfg.detect.use_int8 else 1)
        self.names = None
        self.dim = cfg.model.dim
        self.infer = None

    @property
    def ready(self) -> bool:
        return self.infer is not None

    @property
    def pending_frames(self) -> int:
        return sum(e[0] == "frame" for e in self._pending)

    def bind(self, names, dim, infer) -> None:
        """Serve an already-built program (an artifact): no lazy build."""
        self.names, self.dim, self.infer = names, dim, infer

    def add_frame(self, canvas, item) -> None:
        if self.infer is None:
            self._pending.append(("frame", canvas, item))
            if self.pending_frames >= self.calib_target:
                self.flush()
        else:
            self._process(item)

    def defer(self, fn) -> None:
        if self.infer is None and self.pending_frames:
            self._pending.append(("call", fn))
        else:
            fn()

    def flush(self) -> None:
        """Build on whatever frames arrived (short streams calibrate on
        fewer than calib_target) and drain the queue in order."""
        if not self._pending:
            return
        if self.infer is None:
            canvases = [e[1] for e in self._pending if e[0] == "frame"]
            self.names, self.dim, self.infer = build_detector(
                self._cfg, self._weights,
                canvases if self._cfg.detect.use_int8 else None,
                device=self._device)
        for entry in self._pending:
            if entry[0] == "frame":
                self._process(entry[2])
            else:
                entry[1]()
        self._pending.clear()


def _decode(path: str) -> Optional[np.ndarray]:
    """RGB uint8 HWC, or None when the file cannot be opened or decoded."""
    try:
        return decode_image(path)
    except OSError:
        return None


def _read_rgb(path: str) -> np.ndarray:
    raw = _decode(path)
    if raw is None:
        raise SystemExit(f"unreadable image: {path}")
    return raw


def _raw_and_label(image: Union[str, np.ndarray], index: int):
    if isinstance(image, str):
        return _read_rgb(image), os.path.basename(image)
    return np.asarray(image), f"image{index}"


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
               device=None, detector=None, data_parallel: bool = False):
    """Detect on ``images``: file paths (binary PPM read with numpy, other
    formats with cv2) or decoded HWC RGB arrays. Prints one
    ``label: name score [x0, y0, x1, y1]`` line per detection and returns
    [(label, raw, dets)]. ``detector`` reuses a :func:`build_detector`
    result, or is the (names, dim, infer, fixed_batch) of
    :func:`load_artifact_detector`. With ``detect.use_int8`` a new detector
    calibrates on the first ``detect.calib_images`` inputs, letterboxed as
    the forward sees them. ``data_parallel``: split each batch over the
    local CUDA devices (several images; the batch rounds up to a multiple
    of the device count)."""
    data_parallel = data_parallel and len(images) > 1
    if detector is None:
        calib = None
        if cfg.detect.use_int8:
            calib = [letterbox_host(_raw_and_label(image, j)[0],
                                    cfg.model.dim,
                                    stretch=cfg.detect.stretch)[0]
                     for j, image in enumerate(
                         images[:max(cfg.detect.calib_images, 1)])]
        detector = build_detector(cfg, weights_path, calib, device=device,
                                  data_parallel=data_parallel)
    names, dim, infer, *fixed = detector
    n_dev = getattr(infer, "devices", 1)
    # an artifact takes exactly its baked batch; a live program a fixed
    # batch too, which keeps the cuDNN plans warm across groups
    batch = fixed[0] if fixed else (
        1 if len(images) == 1 else min(max(cfg.eval.batch_size, 1), 32))
    batch += (-batch) % n_dev  # data-parallel: a whole device multiple
    results = []
    for start in range(0, len(images), batch):
        group = images[start: start + batch]
        raws, labels, canvases, tfs = [], [], [], []
        for j, image in enumerate(group):
            raw, label = _raw_and_label(image, start + j)
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


def run_stream(cfg, weights_path: str, out_dir: Optional[str] = None,
               lines=None, device=None, detector=None) -> int:
    """Serve detections over a stream of image paths (one per line, from
    ``lines`` or stdin). Weights load and the program is bound once; each
    image then pays only its decode, letterbox and device time. Prints the
    ``name: label score [x0, y0, x1, y1]`` lines of each image followed by
    a blank line, and ``name: ERROR unreadable`` (and a blank line) for a
    path that does not decode, in input order; with ``out_dir``, writes
    each annotated image there. ``detector``: the (names, dim, infer,
    fixed_batch) of :func:`load_artifact_detector`, which must have batch
    1. Returns the count of images served."""
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    if lines is None:
        lines = sys.stdin
    n = 0

    def process(item):
        nonlocal n
        image_path, raw, canvas, tf = item
        out = det.infer(canvas[None])
        dets = _extract(out, 0, tf, raw.shape, det.names)
        for name, _, score, (x0, y0, x1, y1) in dets:
            print(f"{os.path.basename(image_path)}: {name} "
                  f"{score:.3f} [{x0:.0f}, {y0:.0f}, {x1:.0f}, {y1:.0f}]")
        print(flush=True)  # blank line = end of this image's block
        if out_dir:
            import cv2

            # index prefix: inputs sharing a basename must not overwrite
            stem = os.path.splitext(os.path.basename(image_path))[0]
            dst = os.path.join(out_dir, f"{n:06d}_{stem}.png")
            if not cv2.imwrite(dst, _annotate(raw, dets)):
                log.error("failed to write %s", dst)
        n += 1

    def emit_error(image_path):
        print(f"{os.path.basename(image_path)}: ERROR unreadable")
        print(flush=True)

    det = LazyDetector(cfg, weights_path, process, device=device)
    if detector is not None:  # an artifact: program and names bound
        names, dim, infer, art_batch = detector
        if art_batch != 1:
            raise SystemExit(
                f"--stdin serves one image at a time; the artifact was "
                f"exported with batch {art_batch} (re-export with --batch 1)")
        det.bind(names, dim, infer)
    if det.calib_target > 1 and not det.ready:
        # nothing prints until N paths arrive (or the stream closes): a
        # request/response client that waits for each block would hang
        log.warning(
            "int8 serving buffers the first %d frames for activation "
            "calibration before responding; set detect.calib_images=1 "
            "for interactive one-request-at-a-time clients",
            det.calib_target)
    for line in lines:
        image_path = line.strip()
        if not image_path:
            continue
        raw = _decode(image_path)
        if raw is None:
            # queued behind any buffered frames: response order must
            # match input order even while calibration is buffering
            det.defer(lambda p=image_path: emit_error(p))
            continue
        canvas, tf = letterbox_host(raw, det.dim, stretch=cfg.detect.stretch)
        det.add_frame(canvas, (image_path, raw, canvas, tf))
    det.flush()  # short stream: calibrate on what arrived
    log.info("stream done: %d images", n)
    return n


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help=".npz param store, Darknet .weights, TF1 "
                             "checkpoint prefix or training logdir")
    parser.add_argument("--artifact", default="",
                        help="serving artifact from cli/export.py (replaces "
                             "--weights and the [model] section: program, "
                             "weights, names and thresholds are baked in)")
    parser.add_argument("--image", action="append", default=[],
                        help="image path (repeatable)")
    parser.add_argument("--out", default="", help="annotated output path/dir")
    parser.add_argument("--show", action="store_true",
                        help="display the annotated image")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--stdin", action="store_true",
                        help="serve: read image paths from stdin, one per "
                             "line; weights are loaded once")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split the detect batch over all local "
                             "devices (several --image with --weights)")
    args = parser.parse_args()
    cfg = setup(args)
    if args.stdin and (args.image or args.show):
        parser.error("--stdin is exclusive with --image/--show")
    if args.data_parallel and (args.stdin or args.artifact):
        parser.error("--data-parallel applies to batched --image mode "
                     "with --weights (artifacts own their placement; "
                     "--stdin serves one image at a time)")
    if bool(args.weights) == bool(args.artifact):
        parser.error("exactly one of --weights or --artifact is required")
    detector = None
    if args.artifact:
        detector, meta = load_artifact_detector(args.artifact, args.device)
        cfg = sync_artifact_cfg(cfg, meta)
    if args.stdin:
        run_stream(cfg, args.weights, args.out or None, device=args.device,
                   detector=detector)
    elif args.image:
        run_detect(cfg, args.weights, args.image, args.out or None,
                   args.show, device=args.device, detector=detector,
                   data_parallel=args.data_parallel)
    else:
        parser.error("one of --image or --stdin is required")


if __name__ == "__main__":
    main()
