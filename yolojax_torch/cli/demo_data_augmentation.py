#!/usr/bin/env python3
"""Augmentation visual fixture (port of ``cli/demo_data_augmentation.py``):
a grid of augmented samples from the cached training data, GT boxes drawn.

The batch is augmented on the device (``data/augment.py::augment_batch``,
on the card unless ``--device cpu``); the draws come from the port's
generator, so the pixels are not yolojax's. :func:`render_grid` returns the
uint8 RGB grid and needs no cv2 (boxes are outlined in their class colour,
without yolojax's cv2 text labels); ``main`` writes it with cv2.

Usage: python -m yolojax_torch.cli.demo_data_augmentation -c config.ini
       [--out grid.png] [--rows 3] [--cols 4] [--seed 0] [--device cpu]
"""

import numpy as np

from yolojax_torch.utils.cli import make_parser, setup


def render_grid(cfg, rows: int, cols: int, seed: int = 0,
                device=None) -> np.ndarray:
    """``rows * cols`` augmented training samples with their GT boxes, as
    a (rows * dim, cols * dim, 3) uint8 RGB grid."""
    import torch

    from yolojax_torch.data.augment import augment_batch
    from yolojax_torch.data.cache import load_cache
    from yolojax_torch.data.loader import Loader, LoaderConfig
    from yolojax_torch.utils.device import resolve_device
    from yolojax_torch.utils.draw import class_color, draw_rectangle

    device = resolve_device(device)
    n = rows * cols
    cache = load_cache(cfg.cache.basedir, "train")
    loader = Loader(cache, LoaderConfig(
        batch_size=n, canvas_dim=cfg.queue.canvas_dim,
        max_boxes=cfg.queue.max_boxes, seed=seed, num_threads=4,
        drop_remainder=False))
    images, boxes, classes, valid = next(iter(loader.epoch(0)))
    dim = cfg.model.dim
    gen = torch.Generator(device).manual_seed(seed)
    imgs, bxs, vld = augment_batch(
        gen, torch.from_numpy(images).to(device),
        torch.from_numpy(boxes).to(device),
        torch.from_numpy(valid).to(device), dim, cfg.augment)
    imgs, bxs, vld = (t.cpu().numpy() for t in (imgs, bxs, vld))

    grid = np.zeros((rows * dim, cols * dim, 3), np.uint8)
    k = 0
    for r in range(rows):
        for c in range(cols):
            if k >= imgs.shape[0]:
                break
            img = (np.clip(imgs[k], 0, 1) * 255).astype(np.uint8).copy()
            for gi in range(bxs.shape[1]):
                if not vld[k, gi]:
                    continue
                cx, cy, w, h = bxs[k, gi]
                draw_rectangle(img, int((cx - w / 2) * dim),
                               int((cy - h / 2) * dim),
                               int((cx + w / 2) * dim),
                               int((cy + h / 2) * dim),
                               class_color(int(classes[k, gi]))[::-1], 2)
            grid[r * dim:(r + 1) * dim, c * dim:(c + 1) * dim] = img
            k += 1
    return grid


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--out", default="augmentation_demo.png")
    parser.add_argument("--rows", type=int, default=3)
    parser.add_argument("--cols", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)

    import cv2

    grid = render_grid(cfg, args.rows, args.cols, args.seed, args.device)
    cv2.imwrite(args.out, cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
    print(f"wrote {args.out} ({args.rows}x{args.cols} augmented samples)")


if __name__ == "__main__":
    main()
