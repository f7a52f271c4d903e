#!/usr/bin/env python3
"""Detection serving daemon: HTTP endpoint + dynamic request batching.

Port of ``cli/serve.py``. Loads the weights and binds the serving program
once (or loads an exported artifact), runs one warm-up batch, then gathers
requests that arrive together into fixed-batch dispatches
(``yolojax_torch/serve/batching.py``). Clients POST one image per request
and get detections in original-pixel coordinates back as JSON.

API:
  GET  /healthz  -> {status, dim, batch, window_ms, backend, devices,
                     pipeline_depth, names, stats}
  GET  /stats    -> batching stats {images, batches, mean_fill, errors,
                    rejected, queued, devices}
  POST /detect   <- raw image bytes (8-bit binary PPM without cv2; any
                    cv2-decodable format where cv2 is installed)
                 -> {"detections": [{"name", "class", "score",
                     "box": [x0, y0, x1, y1]}],
                     "image": {"width", "height"}, "batch_fill": N}

Usage: python -m yolojax_torch.cli.serve -c config.ini --weights W --port 8628
       ... --artifact model.yjts --port 8628    # an exported artifact
       ... --batch 16 --window-ms 4             # batching knobs
       ... --device cpu                         # default: the CUDA card

Prints ``READY http://host:port`` once it accepts requests; SIGTERM (or
Ctrl-C) drains the queue and exits 0 with the final stats in the log.
``--data-parallel`` splits each dispatched batch over the process's CUDA
devices (the batch rounds up to a device multiple; ``devices`` in
``/healthz`` and ``/stats`` says how many); with one device it warns and
serves on that one.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import signal
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from yolojax_torch.cli.detect import (
    _extract,
    build_detector,
    load_artifact_detector,
    sync_artifact_cfg,
)
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.loader import decode_image, decode_image_bytes
from yolojax_torch.serve.batching import DynamicBatcher, QueueFull
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.device import resolve_device

MAX_BODY_BYTES = 32 << 20  # reject absurd uploads before reading them

log = logging.getLogger("serve")


def _load_calib(cfg, calib_dir: str) -> list:
    """Letterboxed canvases from a directory of images, for int8 activation
    calibration at start (a daemon has no 'first N inputs' to calibrate
    on): the first ``detect.calib_images`` files that decode, in name
    order. Files that do not decode are skipped with a warning."""
    canvases = []
    want = max(cfg.detect.calib_images, 1)
    for p in sorted(glob.glob(os.path.join(calib_dir, "*"))):
        if not os.path.isfile(p) or len(canvases) >= want:
            continue
        try:
            raw = decode_image(p)
        except (OSError, RuntimeError, ValueError):
            log.warning("calib-dir: skipping undecodable %s", p)
            continue
        canvases.append(letterbox_host(raw, cfg.model.dim,
                                       stretch=cfg.detect.stretch)[0])
    if not canvases:
        raise SystemExit(f"--calib-dir {calib_dir}: no image files")
    return canvases


def build_server(cfg, host: str, port: int, weights: str = "",
                 artifact: str = "", batch: int = 0, window_ms: float = 5.0,
                 calib_dir: str = "", max_queue: int = 0,
                 data_parallel: bool = False, pipeline_depth: int = 1,
                 device=None):
    """Build detector + batcher + HTTP server (not yet serving).

    Returns (httpd, batcher); ``httpd.serve_forever()`` runs it,
    ``httpd.server_address`` carries the bound port (port 0: an ephemeral
    one). One warm-up batch runs here (the kernels build, cuDNN picks its
    plans), so the first request does not pay for it. ``data_parallel``:
    split each dispatched batch over the local CUDA devices (the batch is
    rounded up to a device multiple)."""
    devices = 1
    if artifact:
        if data_parallel:
            raise SystemExit("--data-parallel needs --weights (an exported "
                             "artifact owns its device placement)")
        (names, dim, infer, art_batch), meta = load_artifact_detector(
            artifact, device)
        cfg = sync_artifact_cfg(cfg, meta)
        if batch and batch != art_batch:
            raise SystemExit(
                f"--batch {batch} conflicts with the artifact's baked batch "
                f"{art_batch} (re-export with --batch {batch})")
        batch = art_batch
        backend = meta["platforms"][0]
    else:
        calib = _load_calib(cfg, calib_dir) if (
            calib_dir and cfg.detect.use_int8) else None
        backend = resolve_device(device).type
        names, dim, infer = build_detector(cfg, weights, calib, device=device,
                                           data_parallel=data_parallel)
        batch = batch or min(max(cfg.eval.batch_size, 1), 32)
        devices = getattr(infer, "devices", 1)
        if batch % devices:
            dp_batch = batch + (-batch) % devices
            log.info("data-parallel: batch %d -> %d (%d local devices)",
                     batch, dp_batch, devices)
            batch = dp_batch

    filler = np.full((dim, dim, 3), 0.5, np.float32)
    log.info("warm-up: one batch of %d at dim %d", batch, dim)
    infer(np.stack([filler] * batch))
    # infer returns numpy arrays: each dispatch thread copies its group's
    # results out of the card, which waits for them
    batcher = DynamicBatcher(infer, batch, filler, window_ms=window_ms,
                             max_queue=max_queue,
                             pipeline_depth=pipeline_depth)
    stretch = cfg.detect.stretch

    def health():
        return {
            "status": "ok",
            "dim": dim,
            "batch": batch,
            "window_ms": window_ms,
            "backend": backend,
            "devices": devices,
            "pipeline_depth": pipeline_depth,
            "names": list(names),
            "stats": batcher.stats(),
        }

    class Handler(BaseHTTPRequestHandler):
        server_version = "yolojax-torch-serve/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging, quiet
            log.debug("%s %s", self.address_string(), fmt % args)

        def _json(self, code, payload):
            blob = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, health())
            elif self.path == "/stats":
                self._json(200, {**batcher.stats(), "devices": devices})
            else:
                self._json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/detect":
                return self._json(404, {"error": f"unknown path {self.path}"})
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = 0
            if length <= 0:
                return self._json(400, {"error": "empty body: POST raw "
                                                 "image bytes to /detect"})
            if length > MAX_BODY_BYTES:
                return self._json(413, {"error": f"body too large "
                                                 f"({length} bytes)"})
            body = self.rfile.read(length)
            try:
                raw = decode_image_bytes(body)
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            canvas, tf = letterbox_host(raw, dim, stretch=stretch)
            try:
                res, fill = batcher.submit(canvas.numpy())
            except QueueFull as e:  # backpressure: shed, don't stack
                return self._json(429, {"error": str(e)})
            except RuntimeError as e:  # closed mid-shutdown
                return self._json(503, {"error": str(e)})
            out = {k: v[None] for k, v in res.items()}
            dets = _extract(out, 0, tf, raw.shape, names)
            self._json(200, {
                "detections": [
                    {"name": name, "class": cls, "score": round(score, 5),
                     "box": [round(float(v), 2) for v in (x0, y0, x1, y1)]}
                    for name, cls, score, (x0, y0, x1, y1) in dets
                ],
                "image": {"width": raw.shape[1], "height": raw.shape[0]},
                "batch_fill": fill,
            })

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    return httpd, batcher


def serve_forever(httpd, batcher) -> None:
    """Serve until SIGTERM or Ctrl-C, then drain the queue and close."""

    def _graceful(signum, frame):  # SIGTERM = orchestrated shutdown
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _graceful)
    log.info("serving on http://%s:%d (POST /detect)",
             *httpd.server_address[:2])
    print(f"READY http://{httpd.server_address[0]}:"
          f"{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        log.info("shutting down")
    finally:
        httpd.server_close()
        batcher.close()  # drains queued requests before the join
        log.info("final stats: %s", batcher.stats())


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help=".npz param store or training logdir")
    parser.add_argument("--artifact", default="",
                        help="serving artifact from cli/export.py")
    parser.add_argument("--host", default="127.0.0.1",
                        help="bind address (default loopback; put a real "
                             "frontend in front for external traffic)")
    parser.add_argument("--port", type=int, default=8628)
    parser.add_argument("--batch", type=int, default=0,
                        help="device batch size (default: eval.batch_size; "
                             "artifact mode: the baked batch)")
    parser.add_argument("--window-ms", type=float, default=5.0,
                        help="max wait for a batch to fill before "
                             "dispatching a partial one")
    parser.add_argument("--max-queue", type=int, default=0,
                        help="requests allowed to wait beyond the batch "
                             "being assembled before new ones get 429 "
                             "(0 = 8x batch); with --pipeline-depth D "
                             "another D*batch can be in flight")
    parser.add_argument("--calib-dir", default="",
                        help="directory of images for int8 activation "
                             "calibration (detect.use_int8=1)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split each batch over all local devices "
                             "(the batch rounds up to a device multiple)")
    parser.add_argument("--pipeline-depth", type=int, default=1,
                        help="batches allowed in flight at once (2 "
                             "overlaps host result scatter with device "
                             "compute of the next batch; 1 = serialize)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)
    if bool(args.weights) == bool(args.artifact):
        parser.error("exactly one of --weights or --artifact is required")
    httpd, batcher = build_server(
        cfg, args.host, args.port, weights=args.weights,
        artifact=args.artifact, batch=args.batch,
        window_ms=args.window_ms, calib_dir=args.calib_dir,
        max_queue=args.max_queue, data_parallel=args.data_parallel,
        pipeline_depth=args.pipeline_depth, device=args.device)
    serve_forever(httpd, batcher)


if __name__ == "__main__":
    main()
