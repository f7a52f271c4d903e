"""Anchor estimation: IoU k-means over a cached dataset's box shapes (a
copy of ``yolojax/data/anchors.py``).

Darknet's ``calc_anchors`` clusters the GT box shapes with d = 1 - IoU of
co-centered boxes (arXiv:1612.08242, "Dimension Clusters");
``cli/kmeans_anchors.py`` runs it on a cached phase and prints an
``anchors =`` line in the INI dialect. Pure numpy, so the results are
yolojax's bit for bit (the same ``RandomState`` draws, the same medians).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _iou_wh(wh: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """IoU of co-centered boxes: wh (N, 2) vs centroids (K, 2) -> (N, K)."""
    inter = (np.minimum(wh[:, None, 0], centroids[None, :, 0])
             * np.minimum(wh[:, None, 1], centroids[None, :, 1]))
    union = (wh[:, 0] * wh[:, 1])[:, None] + (
        centroids[:, 0] * centroids[:, 1])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def kmeans_anchors(
    wh: np.ndarray, k: int, *, iters: int = 100, seed: int = 0,
) -> Tuple[np.ndarray, float]:
    """Cluster box shapes (N, 2) into k anchors with the 1-IoU metric.

    Returns (anchors sorted by area ascending (k, 2), mean best-IoU of
    every box against its nearest anchor — Darknet's "avg IoU" figure).
    Deterministic for a given seed (k-means++ style farthest-point init
    on the IoU distance, then Lloyd iterations with median updates —
    medians are robust to the long tail of box sizes).
    """
    wh = np.asarray(wh, np.float64)
    if wh.ndim != 2 or wh.shape[1] != 2:
        raise ValueError(f"wh must be (N, 2), got {wh.shape}")
    wh = wh[(wh > 0).all(axis=1)]
    n = len(wh)
    if n < k:
        raise ValueError(f"need at least k={k} positive boxes, have {n}")
    rng = np.random.RandomState(seed)

    # k-means++ on 1-IoU: first centroid random, next ones sampled
    # proportionally to their distance from the chosen set
    centroids = wh[rng.randint(n)][None]
    while len(centroids) < k:
        d = 1.0 - _iou_wh(wh, centroids).max(axis=1)
        total = d.sum()
        if total <= 0:  # all boxes coincide with a centroid already
            pick = rng.randint(n)
        else:
            pick = rng.choice(n, p=d / total)
        centroids = np.concatenate([centroids, wh[pick][None]])

    assign = np.full(n, -1)
    for _ in range(iters):
        new_assign = _iou_wh(wh, centroids).argmax(axis=1)
        if (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = wh[assign == j]
            if len(members):
                centroids[j] = np.median(members, axis=0)
    mean_iou = float(_iou_wh(wh, centroids).max(axis=1).mean())
    order = np.argsort(centroids[:, 0] * centroids[:, 1])
    return centroids[order], mean_iou


def cache_box_shapes(
    cache, dim: int, *, stretch: bool = False,
) -> np.ndarray:
    """GT box shapes in grid-cell units at training dim (stride 32) —
    the units the v2 ``anchors =`` config key uses.

    ``stretch=False`` (default) applies each image's letterbox scale
    (min(dim/w, dim/h)) so the shapes match what the loss sees with the
    aspect-preserving pipeline; ``stretch=True`` reproduces Darknet's
    plain-resize convention (normalized wh x grid)."""
    grid = dim // 32
    sizes = np.asarray(cache.sizes, np.float64)  # (M, 2) original (w, h)
    out = []
    for i in range(len(cache)):
        lo, hi = cache.offsets[i], cache.offsets[i + 1]
        keep = ~cache.difficult[lo:hi]  # cluster what training sees
        wh_norm = np.asarray(cache.boxes[lo:hi][keep, 2:4], np.float64)
        if not len(wh_norm):
            continue
        if stretch:
            out.append(wh_norm * grid)
        else:
            w, h = sizes[i]
            scale = min(dim / w, dim / h)
            wh_px = wh_norm * np.array([w, h]) * scale
            out.append(wh_px / 32.0)
    if not out:
        return np.zeros((0, 2))
    return np.concatenate(out)
