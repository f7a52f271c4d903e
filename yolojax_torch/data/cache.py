"""Offline dataset cache builder: VOC XML / COCO JSON -> per-phase cache.

Copy of ``yolojax/data/cache.py`` (numpy and xml only, so it is copied
rather than imported): parse annotations once on the host, write a unified
per-phase cache of (image path, per-object class + normalized box), plus a
class-names list, as one ``.npz`` per phase (paths + ragged boxes via
offsets). A cache written by either package loads in the other.

Box convention in the cache: normalized (cx, cy, w, h) in [0, 1] relative to
the original image, classes as int32 indices into the names list.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)

VOC_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@dataclasses.dataclass
class DatasetCache:
    """In-memory view of one phase's cache.

    VOC ``difficult`` objects are KEPT in the cache with a flag (the VOC
    protocol *ignores* them at eval — dropping them at cache time would
    turn detections on difficult objects into false positives). Training
    views (:meth:`example`) exclude them, matching the usual VOC training
    convention; the evaluator reads :meth:`example_eval` and passes the
    flags through to the ignore-aware matcher.
    """

    paths: np.ndarray  # (M,) unicode image paths
    sizes: np.ndarray  # (M, 2) original (width, height)
    offsets: np.ndarray  # (M + 1,) int64 into boxes/classes
    boxes: np.ndarray  # (sum_G, 4) normalized xywh float32
    classes: np.ndarray  # (sum_G,) int32
    names: Tuple[str, ...]
    difficult: np.ndarray = None  # (sum_G,) bool; None -> all False

    def __post_init__(self):
        if self.difficult is None:
            self.difficult = np.zeros(len(self.classes), bool)

    def __len__(self) -> int:
        return len(self.paths)

    def example(self, i: int):
        """Training view: (path, boxes, classes), difficult excluded."""
        lo, hi = self.offsets[i], self.offsets[i + 1]
        keep = ~self.difficult[lo:hi]
        return self.paths[i], self.boxes[lo:hi][keep], self.classes[lo:hi][keep]

    def example_eval(self, i: int):
        """Eval view: (path, boxes, classes, difficult), nothing excluded."""
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return (self.paths[i], self.boxes[lo:hi], self.classes[lo:hi],
                self.difficult[lo:hi])


# ---------------------------------------------------------------------------
# Parsers (host CPU, pure Python)
# ---------------------------------------------------------------------------


def parse_voc(
    root: str, image_set: str, names: Sequence[str] = VOC_NAMES,
    *, skip_difficult: bool = False,
) -> List[Tuple[str, Tuple[int, int], List[Tuple[int, float, float, float, float, int]]]]:
    """Parse a PASCAL VOC devkit layout: <root>/{Annotations,JPEGImages,
    ImageSets/Main/<image_set>.txt}.
    Returns [(path, (w, h), [(cls, x, y, w, h, difficult)])].

    ``difficult`` objects are flagged, not dropped (the eval protocol
    ignores them; see :class:`DatasetCache`). ``skip_difficult=True``
    restores the legacy drop-at-parse behavior.
    """
    name_to_idx = {n: i for i, n in enumerate(names)}
    set_file = os.path.join(root, "ImageSets", "Main", image_set + ".txt")
    with open(set_file) as f:
        ids = [line.strip().split()[0] for line in f if line.strip()]
    out = []
    for img_id in ids:
        ann = os.path.join(root, "Annotations", img_id + ".xml")
        tree = ET.parse(ann)
        size = tree.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        objs = []
        for obj in tree.iter("object"):
            diff = 0
            if obj.find("difficult") is not None:
                if (obj.find("difficult").text or "0").strip() == "1":
                    diff = 1
            if skip_difficult and diff:
                continue
            cls_name = obj.find("name").text.strip()
            if cls_name not in name_to_idx:
                continue
            bb = obj.find("bndbox")
            xmin = float(bb.find("xmin").text)
            ymin = float(bb.find("ymin").text)
            xmax = float(bb.find("xmax").text)
            ymax = float(bb.find("ymax").text)
            cx = (xmin + xmax) / 2 / w
            cy = (ymin + ymax) / 2 / h
            bw = (xmax - xmin) / w
            bh = (ymax - ymin) / h
            objs.append((name_to_idx[cls_name], cx, cy, bw, bh, diff))
        path = os.path.join(root, "JPEGImages", img_id + ".jpg")
        out.append((path, (int(w), int(h)), objs))
    return out


def parse_coco(
    ann_json: str, image_dir: str, names: Sequence[str] = None
) -> Tuple[List, Tuple[str, ...]]:
    """Parse a COCO instances JSON. Returns (examples, names)."""
    with open(ann_json) as f:
        coco = json.load(f)
    cats = sorted(coco["categories"], key=lambda c: c["id"])
    if names is None:
        names = tuple(c["name"] for c in cats)
        cat_to_idx = {c["id"]: i for i, c in enumerate(cats)}
    else:
        # Honor the caller's class ordering (names.txt is written from it;
        # mapping by sorted category id instead would silently mislabel
        # custom names files and VOC+COCO mixes). Match by name, like
        # parse_voc does.
        name_to_idx = {n: i for i, n in enumerate(names)}
        unknown = [c["name"] for c in cats if c["name"] not in name_to_idx]
        if unknown:
            raise ValueError(
                f"COCO categories not in the provided names list: {unknown}"
            )
        cat_to_idx = {c["id"]: name_to_idx[c["name"]] for c in cats}
    imgs = {im["id"]: im for im in coco["images"]}
    anns_by_img: Dict[int, list] = {}
    for a in coco.get("annotations", []):
        if a.get("iscrowd"):
            continue
        anns_by_img.setdefault(a["image_id"], []).append(a)
    out = []
    for img_id, im in imgs.items():
        w, h = float(im["width"]), float(im["height"])
        objs = []
        for a in anns_by_img.get(img_id, []):
            x, y, bw, bh = a["bbox"]  # COCO: top-left + size, pixels
            objs.append(
                (
                    cat_to_idx[a["category_id"]],
                    (x + bw / 2) / w,
                    (y + bh / 2) / h,
                    bw / w,
                    bh / h,
                    0,  # COCO has no 'difficult'; crowds are skipped above
                )
            )
        out.append((os.path.join(image_dir, im["file_name"]), (int(w), int(h)), objs))
    return out, names


# ---------------------------------------------------------------------------
# Cache IO
# ---------------------------------------------------------------------------


def _to_cache(examples, names) -> DatasetCache:
    paths, sizes, offsets, boxes, classes, difficult = [], [], [0], [], [], []
    for path, size, objs in examples:
        paths.append(path)
        sizes.append(size)
        for obj in objs:
            cls, cx, cy, bw, bh = obj[:5]
            classes.append(cls)
            boxes.append((cx, cy, bw, bh))
            difficult.append(bool(obj[5]) if len(obj) > 5 else False)
        offsets.append(len(classes))
    return DatasetCache(
        paths=np.asarray(paths),
        sizes=np.asarray(sizes, np.int32),
        offsets=np.asarray(offsets, np.int64),
        boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
        classes=np.asarray(classes, np.int32),
        names=tuple(names),
        difficult=np.asarray(difficult, bool),
    )


def build_cache(
    out_dir: str,
    phase: str,
    datasets: Sequence[dict],
    names: Sequence[str] = VOC_NAMES,
) -> DatasetCache:
    """Build + write one phase's cache.

    datasets: list of {"kind": "voc", "root": ..., "image_set": ...} or
              {"kind": "coco", "ann_json": ..., "image_dir": ...}.
    """
    examples = []
    for ds in datasets:
        if ds["kind"] == "voc":
            examples += parse_voc(ds["root"], ds["image_set"], names)
        elif ds["kind"] == "coco":
            ex, names = parse_coco(ds["ann_json"], ds["image_dir"], names)
            examples += ex
        else:
            raise ValueError(f"unknown dataset kind {ds['kind']!r}")
    cache = _to_cache(examples, names)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        os.path.join(out_dir, f"{phase}.npz"),
        paths=cache.paths,
        sizes=cache.sizes,
        offsets=cache.offsets,
        boxes=cache.boxes,
        classes=cache.classes,
        difficult=cache.difficult,
    )
    with open(os.path.join(out_dir, "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    log.info("cached %d examples (%d objects) -> %s/%s.npz",
             len(cache), len(cache.classes), out_dir, phase)
    return cache


def load_cache(cache_dir: str, phase: str) -> DatasetCache:
    z = np.load(os.path.join(cache_dir, f"{phase}.npz"), allow_pickle=False)
    with open(os.path.join(cache_dir, "names.txt")) as f:
        names = tuple(line.strip() for line in f if line.strip())
    return DatasetCache(
        paths=z["paths"], sizes=z["sizes"], offsets=z["offsets"],
        boxes=z["boxes"], classes=z["classes"], names=names,
        # caches written before the flag existed load as all-easy
        difficult=z["difficult"] if "difficult" in z.files else None,
    )
