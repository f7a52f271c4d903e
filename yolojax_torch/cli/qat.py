#!/usr/bin/env python3
"""Quantization-aware fine-tune (QAT): repair the int8 serving path's
rounding loss. Port of ``cli/qat.py``: loads trained weights, folds BN,
calibrates activation scales on train batches, fine-tunes with fake-quant
straight-through estimators (``quantize/qat.py``) and writes a standard
identity-BN ``.npz`` that every surface loads:

  python -m yolojax_torch.cli.qat -c config.ini --weights W \\
      --output qat.npz [--steps 200] [--lr 1e-5] [--grad-clip 1.0] \\
      [--calib-batches 1] [--bits N] [--no-augment] [--distill] \\
      [--device cpu]
  python -m yolojax_torch.cli.eval -c config.ini --weights qat.npz \\
      detect.use_int8=1

Runs in f32 with TF32 off, on the card unless ``--device`` names another
device. The augmentation and dropout draw from generators seeded by
``train.seed + 17`` and the step (``train/step.py::step_seeds``), not
JAX's ``PRNGKey(seed + 17)``. ``queue.loader=grain`` reads the train
cache through ``data/grain_loader.py``.
"""

from __future__ import annotations

import copy
import itertools
import logging
import math

import torch

from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data.augment import resize
from yolojax_torch.data.cache import load_cache
from yolojax_torch.data.grain_loader import make_loader
from yolojax_torch.quantize.ptq import calibrate
from yolojax_torch.quantize.qat import (
    QatConfig,
    init_qat_state,
    make_qat_distill_step,
    make_qat_optimizer,
    make_qat_step,
    reembed_folded,
)
from yolojax_torch.utils.cli import make_parser, setup
from yolojax_torch.utils.device import resolve_device
from yolojax_torch.utils.restore import load_weights

log = logging.getLogger("qat")


def run_qat(cfg, weights: str, output: str, qcfg: QatConfig, *,
            bits: int = 0, augment: bool = True, distill: bool = False,
            device=None):
    """Fine-tune ``weights`` under fake quantization and write the
    identity-BN ``.npz`` to ``output``. Returns (first loss, last loss)."""
    bits = bits or cfg.detect.quant_bits
    if not 2 <= bits <= 8:
        raise SystemExit(f"--bits must be in [2, 8], got {bits}")
    qmax = 2 ** (bits - 1) - 1
    device = resolve_device(device)
    model = cfg.build_model()
    dim = cfg.model.dim

    cache = load_cache(cfg.cache.basedir, "train")
    loader = make_loader(cache, cfg.queue, cfg.queue.loader)
    if len(loader) == 0:
        raise SystemExit(
            f"cache has {len(cache)} images < batch_size "
            f"{cfg.queue.batch_size}; no full batch per epoch")
    log.info("QAT data: %d images, %d classes, device %s", len(cache),
             model.num_classes, device)

    net = load_weights(weights, model, cfg.model.dim,
                       use_ema=cfg.detect.use_ema)
    folded_model, folded = fold_bn(model, net)
    folded = folded.to(device)

    def batches():
        for epoch in itertools.count():
            yield from loader.epoch(epoch)

    batch_iter = batches()
    # activation calibration on train images at the deploy dim, with the
    # percentile the PTQ export uses: the scales stay frozen here and are
    # derived the same way at deployment
    parts = []
    for _ in range(max(qcfg.calib_batches, 1)):
        imgs = torch.from_numpy(next(batch_iter)[0]).to(device).float()
        if imgs.shape[1] != dim:
            imgs = resize(imgs, dim)
        parts.append(imgs)
    calib = torch.cat(parts)
    in_scale, act_scales = calibrate(
        folded_model, folded, calib,
        percentile=cfg.detect.calib_percentile, qmax=qmax)
    log.info("calibrated on %d images (percentile %.4g, %d-bit grid)",
             calib.shape[0], cfg.detect.calib_percentile, bits)

    tx = make_qat_optimizer(qcfg)
    teacher = None
    if distill:
        # the frozen f32 teacher: the folded weights before the fine-tune
        teacher = copy.deepcopy(folded).requires_grad_(False)
        step_fn = make_qat_distill_step(
            folded_model, tx, in_scale, act_scales, aug_cfg=cfg.augment,
            augment=augment, qmax=qmax)
    else:
        step_fn = make_qat_step(
            folded_model, tx, in_scale, act_scales,
            loss_cfg=cfg.loss_config(), aug_cfg=cfg.augment,
            augment=augment, qmax=qmax)
    st = init_qat_state(folded, tx)
    seed = cfg.train.seed + 17

    first = last = None
    for step_i in range(qcfg.steps):
        batch = tuple(torch.from_numpy(a).to(device)
                      for a in next(batch_iter))
        if teacher is not None:
            st, m = step_fn(st, batch, teacher, seed, dim)
        else:
            st, m = step_fn(st, batch, seed, dim)
        # finiteness every step: a divergence must never reach the .npz
        total = float(m["total"])
        if not math.isfinite(total):
            raise SystemExit(
                f"non-finite QAT loss at step {step_i + 1}; lower --lr")
        if first is None:
            first = total
        last = total
        if step_i == 0 or (step_i + 1) % cfg.train.summary_steps == 0:
            log.info("qat step %d/%d loss %.4f", step_i + 1, qcfg.steps,
                     total)

    save_network_npz(output, model, reembed_folded(model, st.net))
    log.info("QAT done (loss %.4f -> %.4f); wrote %s — use it with "
             "detect.use_int8=1 (same calib percentile)", first or 0.0,
             last or 0.0, output)
    return first, last


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", required=True,
                        help=".npz param store or training logdir")
    parser.add_argument("--output", required=True,
                        help="output .npz param store (identity-BN layout; "
                             "load with --weights anywhere)")
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--grad-clip", type=float, default=1.0)
    parser.add_argument("--calib-batches", type=int, default=1,
                        help="loader batches for activation calibration "
                             "(detect.calib_percentile applies)")
    parser.add_argument("--bits", type=int, default=0,
                        help="quant code width to fine-tune under (default: "
                             "detect.quant_bits; deploy with the same "
                             "detect.quant_bits)")
    parser.add_argument("--no-augment", action="store_true",
                        help="fine-tune on plain resized canvases instead "
                             "of the augmentation pipeline")
    parser.add_argument("--distill", action="store_true",
                        help="minimize the MSE to the frozen f32 teacher's "
                             "head instead of the detection loss")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    cfg = setup(args)
    qcfg = QatConfig(steps=args.steps, learning_rate=args.lr,
                     grad_clip_norm=args.grad_clip,
                     calib_batches=args.calib_batches)
    return run_qat(cfg, args.weights, args.output, qcfg, bits=args.bits,
                   augment=not args.no_augment, distill=args.distill,
                   device=args.device)


if __name__ == "__main__":
    main()
