"""Structured training metrics: one JSON row per line in
``<logdir>/metrics.jsonl`` (port of ``yolojax/utils/metrics.py``).

Scalars, histogram summaries (percentiles of each tensor) and box-drawn
image dumps as PNGs next to the jsonl. The images are drawn and written
with numpy and zlib (``utils/draw.py``): the card's machine has no cv2.
With ``tensorboard=True`` the scalars and histograms also go to a
``torch.utils.tensorboard.SummaryWriter`` in the logdir, under yolojax's
tags; when no writer loads (the ``tensorboard`` package is missing) a
warning is logged and the jsonl stays the record.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from yolojax_torch.utils.draw import draw_rectangle, write_png

log = logging.getLogger(__name__)


class MetricsLogger:
    def __init__(self, logdir: str, *, tensorboard: bool = False):
        os.makedirs(logdir, exist_ok=True)
        self.logdir = logdir
        self._f = open(os.path.join(logdir, "metrics.jsonl"), "a",
                       buffering=1)
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(logdir)
            except (ImportError, OSError) as e:
                log.warning("tensorboard writer unavailable: %s", e)

    def log(self, step: int, values: Dict[str, float], *, prefix: str = ""):
        rec = {"step": int(step), "time": time.time()}
        rec.update({prefix + k: float(v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(prefix + k, float(v), int(step))

    def log_histograms(self, step: int, tensors: Dict[str, torch.Tensor], *,
                       prefix: str = "hist/"):
        """Percentiles, mean and std of each tensor, keyed
        ``prefix + layer/key`` as yolojax names its pytree paths."""
        rec = {"step": int(step), "time": time.time()}
        for name, t in tensors.items():
            v = t.detach().float().cpu().numpy()
            if v.size == 0:
                continue
            tag = prefix + name.replace(".", "/")
            if self._tb is not None:
                self._tb.add_histogram(tag, v, int(step))
            q = np.percentile(v, [0, 25, 50, 75, 100])
            rec[tag] = {
                "min": float(q[0]), "p25": float(q[1]), "p50": float(q[2]),
                "p75": float(q[3]), "max": float(q[4]),
                "mean": float(v.mean()), "std": float(v.std()),
            }
        self._f.write(json.dumps(rec) + "\n")

    def log_image_with_boxes(
        self,
        step: int,
        image: np.ndarray,  # (H, W, 3) float [0,1]
        boxes: np.ndarray,  # (G, 4) normalized xywh
        valid: Optional[np.ndarray] = None,
        name: str = "sample",
    ) -> str:
        """Draw GT boxes on an image and save a PNG; returns its path."""
        img = (np.clip(np.asarray(image), 0, 1) * 255).astype(np.uint8).copy()
        h, w = img.shape[:2]
        for i, (cx, cy, bw, bh) in enumerate(np.asarray(boxes)):
            if valid is not None and not valid[i]:
                continue
            draw_rectangle(img, int((cx - bw / 2) * w), int((cy - bh / 2) * h),
                           int((cx + bw / 2) * w), int((cy + bh / 2) * h),
                           (0, 255, 0))
        path = os.path.join(self.logdir, f"{name}_{int(step):08d}.png")
        write_png(path, img)
        return path

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
