#!/usr/bin/env python3
"""Estimate YOLOv2 anchors from a cached dataset (port of
``cli/kmeans_anchors.py``, Darknet's ``calc_anchors``).

Runs IoU k-means (arXiv:1612.08242 "Dimension Clusters") over the cached
GT box shapes in grid-cell units at [model] dim, and prints a ready-to-use
``anchors = w,h w,h ...`` line for the INI plus the mean best-IoU.

Usage: python -m yolojax_torch.cli.kmeans_anchors -c config.ini [--num 5]
       [--phase train] [--stretch] [--seed 0]
"""

from yolojax_torch.utils.cli import make_parser, setup


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--num", type=int, default=5,
                        help="number of anchors (default 5, the VOC "
                             "YOLOv2 count)")
    parser.add_argument("--phase", default="train",
                        help="cached phase to cluster (default train)")
    parser.add_argument("--stretch", action="store_true",
                        help="Darknet plain-resize convention (normalized "
                             "wh x grid) instead of the letterbox scale "
                             "the default pipeline applies")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    cfg = setup(args)

    from yolojax_torch.data.anchors import cache_box_shapes, kmeans_anchors
    from yolojax_torch.data.cache import load_cache

    cache = load_cache(cfg.cache.basedir, args.phase)
    wh = cache_box_shapes(cache, cfg.model.dim, stretch=args.stretch)
    if not len(wh):
        raise SystemExit(f"no GT boxes in cached phase {args.phase!r}")
    anchors, mean_iou = kmeans_anchors(wh, args.num, seed=args.seed)
    print(f"# {len(wh)} boxes, {args.num} anchors, "
          f"mean best-IoU {mean_iou:.4f} "
          f"(grid {cfg.model.dim // 32}, "
          f"{'stretch' if args.stretch else 'letterbox'} scaling)")
    print("anchors = " + " ".join(f"{w:.4g},{h:.4g}" for w, h in anchors))


if __name__ == "__main__":
    main()
