#!/usr/bin/env python3
"""Camera detection loop (port of ``cli/detect_camera.py``): the detect
path of ``cli/detect.py`` over frames from an OpenCV capture, a camera or a
video file, drawn and shown, or written as PNGs with ``--out-dir``.

:func:`camera_loop` is the loop itself, over any iterable of RGB frames
and a sink for each frame's detections; it needs no cv2. ``main`` wraps
``cv2.VideoCapture``, the drawing, ``imwrite`` and ``imshow`` around it.
With ``detect.use_int8=1`` the first ``detect.calib_images`` frames are
buffered to calibrate on, as ``cli.detect --stdin`` buffers them.

Usage: python -m yolojax_torch.cli.detect_camera -c config.ini --weights W
       [--camera 0 | --video clip.avi] [--out-dir DIR] [--max-frames N]
       ... --artifact m.yjts   # an exported batch-1 artifact (cli/export.py)
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable

import numpy as np

from yolojax_torch.cli.detect import (
    LazyDetector,
    _extract,
    load_artifact_detector,
    sync_artifact_cfg,
)
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.utils.cli import make_parser, setup


def camera_loop(cfg, weights_path: str, frames: Iterable[np.ndarray],
                sink: Callable, *, detector=None, max_frames: int = 0,
                device=None) -> int:
    """Detect on each RGB uint8 (H, W, 3) frame of ``frames``, one at a
    time, and call ``sink(n, frame, dets)`` for the n-th frame served
    (from 1, in order), with ``dets`` as :func:`cli.detect._extract` gives
    them in the frame's pixels; a true return stops the capture. Stops
    after ``max_frames`` frames when it is not 0, counting frames still
    buffered for int8 calibration. ``detector`` is the (names, dim, infer,
    batch) of :func:`load_artifact_detector`, which must have batch 1.
    Returns the count of frames served."""
    served = 0
    stop = False

    def process(item):
        nonlocal served, stop
        frame, canvas, tf = item
        out = det.infer(canvas[None])
        served += 1
        if sink(served, frame,
                _extract(out, 0, tf, frame.shape, det.names)):
            stop = True

    # the detect path of cli/detect.py (fold, stem fusion or the int8
    # trunk); int8 buffers the first calib_images frames to calibrate on
    det = LazyDetector(cfg, weights_path, process, device=device)
    if detector is not None:
        names, dim, infer, art_batch = detector
        if art_batch != 1:
            raise SystemExit(
                f"camera serving is frame-at-a-time; the artifact was "
                f"exported with batch {art_batch} (re-export with "
                f"--batch 1)")
        det.bind(names, dim, infer)
    for frame in frames:
        canvas, tf = letterbox_host(frame, det.dim,
                                    stretch=cfg.detect.stretch)
        det.add_frame(canvas, (frame, canvas, tf))
        if stop or (max_frames
                    and served + det.pending_frames >= max_frames):
            break
    det.flush()  # a short capture: calibrate on what arrived
    return served


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="")
    parser.add_argument("--artifact", default="",
                        help="serving artifact from cli/export.py "
                             "(replaces --weights; batch-1 export)")
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=0,
                        help="stop after N frames (0 = until q pressed)")
    parser.add_argument("--video", default="",
                        help="read from a video file instead of a camera")
    parser.add_argument("--out-dir", default="",
                        help="write annotated frames here instead of "
                             "displaying (headless mode)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)
    if bool(args.weights) == bool(args.artifact):
        parser.error("exactly one of --weights or --artifact is required")

    import cv2

    from yolojax_torch.utils.draw import draw_detection

    detector = None
    if args.artifact:  # program and names bound before the capture opens
        detector, meta = load_artifact_detector(args.artifact, args.device)
        cfg = sync_artifact_cfg(cfg, meta)
    src = args.video if args.video else args.camera
    t0 = time.perf_counter()

    def frames():
        cap = cv2.VideoCapture(src)
        if not cap.isOpened():
            raise SystemExit(f"cannot open capture source {src!r}")
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
        try:
            while True:
                ok, bgr = cap.read()
                if not ok:
                    break
                yield cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        finally:
            cap.release()

    def sink(n, rgb, dets) -> bool:
        frame = cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR)
        for name, cls, score, (x0, y0, x1, y1) in dets:
            draw_detection(frame, int(x0), int(y0), int(x1), int(y1),
                           f"{name} {score:.2f}", cls)
        fps = n / (time.perf_counter() - t0)
        cv2.putText(frame, f"{fps:.1f} fps", (8, 20),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 255), 2)
        if args.out_dir:
            cv2.imwrite(os.path.join(args.out_dir, f"frame_{n:06d}.png"),
                        frame)
            return False
        cv2.imshow("yolojax", frame)  # pragma: no cover (needs a display)
        return cv2.waitKey(1) & 0xFF == ord("q")

    try:
        camera_loop(cfg, args.weights, frames(), sink, detector=detector,
                    max_frames=args.max_frames, device=args.device)
    finally:
        if not args.out_dir:  # pragma: no cover
            cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
