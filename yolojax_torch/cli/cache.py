#!/usr/bin/env python3
"""Offline dataset cache build: parse the VOC/COCO annotations of each
phase named in ``[cache]`` and write ``<basedir>/<phase>.npz`` plus
``names.txt``. Port of ``cli/cache.py``; the files are the ones yolojax
writes.

Usage:

  python -m yolojax_torch.cli.cache -c config.ini [section.key=value ...]
"""

from __future__ import annotations

from yolojax_torch.data.cache import build_cache
from yolojax_torch.utils.cli import make_parser, setup


def main():
    args = make_parser(__doc__).parse_args()
    cfg = setup(args)
    names = cfg.names()
    built = 0
    for phase in ("train", "val", "test"):
        datasets = cfg.cache_datasets(phase)
        if not datasets:
            continue
        cache = build_cache(cfg.cache.basedir, phase, datasets, names)
        print(f"{phase}: {len(cache)} images, {len(cache.classes)} objects "
              f"-> {cfg.cache.basedir}/{phase}.npz")
        built += 1
    if not built:
        raise SystemExit(
            "no datasets configured; set [cache] train/val/test entries "
            "like 'voc:/data/VOCdevkit/VOC2007:trainval'"
        )


if __name__ == "__main__":
    main()
