#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yolojax_torch``) on one CUDA card.

Usage, from the root of a checkout, on a machine with an H100 and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. identify the card (``nvidia-smi`` name and power limit) and the software;
2. build every CUDA kernel of the port from ``yolojax_torch/csrc``, one
   ``nvcc`` per source, all at once (``-Xptxas -v`` output is printed);
3. hold each kernel against its plain PyTorch version on the card: the
   greedy-NMS kernel's keep masks bit for bit on nine cases, the fused-stem
   kernel within ``nn/stem.py::stem_tolerance`` on six input shapes (one
   ragged) with random weights, random weights and a cancelling bias, and
   the seeded Darknet-19's conv0 weights (and ``detect.fuse_stem=auto``
   launches it, as ``pallas`` does), the int8 requant kernel's codes equal
   on seven cases (both modes), and the int8 product's int32 sums equal to
   an exact CPU product on seven convs and dense layers;
4. drive the serving path as a user does (``build_detector`` and
   ``run_detect`` on YOLOv2 Darknet-19 at 416, full width, random weights
   from a seed), count the kernel launches of that run, check the path's
   NMS output against the plain sweep, and check the f32 forward on the
   card against the CPU on a small input;
5. drive the eval path as a user does (``cli.cache`` on a seeded COCO-layout
   set of PPM images, then ``cli.eval`` with ``detect.fuse_stem=pallas``),
   count its kernel launches (each kernel once per batch), check its
   metrics and the fused-stem head against the unfused forward;
6. drive the training path as a user does (``cli.cache`` with a train and
   a val phase, then ``cli.train`` on ``config.ini``: Darknet-19 at 416,
   batch 64, six steps with checkpoints, the EMA and an in-training eval
   through both kernels; then a resume to step 8), count its kernel
   launches, load its checkpoint directory in ``cli.eval`` and, with the
   EMA weights, ``cli.detect``; hold one f32 train step on the card
   against the CPU (a small v2, TF32 off) and the augmentation apply on
   the card against the CPU, and overfit a four-conv model on the card;
7. drive the int8 path (``detect.use_int8=1``) as a user does:
   ``cli.detect --image``, ``cli.detect --stdin`` (output order) and
   ``cli.eval``, each counting its launches; hold small int8 models'
   codes on the card against the CPU, and the overfit model's int8 mAP
   against its f32 mAP;
8. drive the QAT -> export -> serve path: one QAT and one distill step of
   a small v2 on the card against the CPU (TF32 off, the card's forward
   taking the CPU's fake-quant codes), the same steps with TF32 on as the
   control that must fail, and yolojax's gate that QAT beats PTQ on the
   quantized objective (on four nets); ``cli.qat`` on
   ``config.ini`` (3 steps, then 2 with ``--distill``) and ``cli.eval
   detect.use_int8=1`` on its output; ``cli.export`` of three artifacts
   (bf16 with the fused stem and int8 from the QAT weights at batch 8,
   bf16 at batch 1), each held against the live program on the same
   canvases with its kernels counted inside the exported graph;
   ``cli.serve --artifact`` answering 32 concurrent requests as
   ``cli.detect --artifact`` does; ``cli.detect --artifact --stdin`` and
   ``cli.eval --artifact``; the QAT and distill step times at b64@416;
9. drive the converters and host tools: ``model_from_cfg`` on Darknet's
   yolo-voc.cfg against the registry's Darknet-19; adam on the card
   against the CPU bit for bit; the seeded weights written as Darknet
   ``.weights`` and read back by ``python -m yolojax_torch parse-darknet
   --cfg`` into an ``.npz`` equal to the seeded one; ``cli.detect
   --weights x.weights`` printing what the ``.npz`` run prints; the
   camera loop of ``cli.detect_camera`` (bf16, and int8 calibrating on its
   first two frames) equal to ``cli.detect --stdin`` on the same frames;
   ``cli.kmeans_anchors`` on the train cache and the augmentation grid on
   the card;
10. time the paths and the kernels on the card (the NMS kernel's build and
   sweep phases also apart; the b128 int8 batch beside the bf16 ones, with
   every requant launch of it held against the plain version on its own
   sums; the b64@416 train step), check that the fused-stem batch beats
   the unfused one, and print the MFU of the timed programs over the
   H100's peaks (``utils/flops.py``);
11. multi-device: ``cli.train`` in a world-1 ``nccl`` group against no
   group, two ``gloo`` ranks sharing the card (data parallel, ZeRO-1,
   tensor parallel) against one rank, two-process ``cli.eval
   eval.distributed=1``, ``--data-parallel`` detect and serve, and grain;
12. TF export: ``export_spec`` of config.ini's portable build (f32, and
   int8 calibrated on the same 8 canvases) built on the card equals the
   CPU's (f32 bit for bit; int8 weight codes, with the activation scales'
   difference printed), launching no kernel; where tensorflow does not
   import, ``cli.export --format savedmodel`` exits non-zero naming it and
   writes nothing; where it does, the exported SavedModel's keep mask
   equals the live portable program's on the card.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional
from unittest import mock

import numpy as np
import torch

import yolojax_torch.__main__ as dispatcher
from yolojax_torch.cli import cache as cache_cli
from yolojax_torch.cli import detect as detect_cli
from yolojax_torch.cli import eval as eval_cli
from yolojax_torch.cli import export as export_cli
from yolojax_torch.cli import kmeans_anchors as kmeans_cli
from yolojax_torch.cli import qat as qat_cli
from yolojax_torch.cli import train as train_cli
from yolojax_torch.cli.demo_data_augmentation import render_grid
from yolojax_torch.cli.detect_camera import camera_loop
from yolojax_torch.cli.detect import (
    build_detector,
    build_serving,
    load_artifact_detector,
    run_detect,
)
from yolojax_torch.cli.serve import build_server
from yolojax_torch.config import load_config
from yolojax_torch.convert.cfg import model_from_cfg
from yolojax_torch.convert.darknet import save_darknet_weights
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.data import augment
from yolojax_torch.data.cache import build_cache, load_cache
from yolojax_torch.data.loader import (
    Loader,
    LoaderConfig,
    decode_image,
    write_ppm,
)
from yolojax_torch.eval.evaluator import evaluate_model, serving_weights
from yolojax_torch.kernels import build
from yolojax_torch.models import Model, get_model
from yolojax_torch.nn import cuda_stem
from yolojax_torch.parallel import distributed, launch
from yolojax_torch.parallel.mesh import make_mesh, shard_batch
from yolojax_torch.parallel.sharding import Plan
from yolojax_torch.nn.cuda_stem import stem_fused_cuda
from yolojax_torch.nn.layers import (
    ConvSpec,
    MaxPoolSpec,
    RouteSpec,
    _darknet_padding,
    conv2d,
    leaky_relu,
    max_pool,
)
from yolojax_torch.nn.stem import (
    fuse_stem,
    pack_stem_kernel,
    stem_fused_torch,
    stem_tolerance,
    unpack_stem_kernel,
)
from yolojax_torch.ops.boxes import iou_matrix
from yolojax_torch.postprocess import cuda_nms
from yolojax_torch.postprocess.cuda_nms import MAX_K, nms_greedy_cuda
from yolojax_torch.postprocess.nms import (
    CLASS_OFFSET,
    nms_greedy_torch,
    postprocess_v2,
)
from yolojax_torch.quantize import cuda_int8, ptq, qat
from yolojax_torch.quantize.cuda_int8 import int8_requant_cuda
from yolojax_torch.quantize.int8_ops import (
    gemm_operand,
    int8_conv,
    int8_conv_exact,
    int8_matmul,
    int8_requant_torch,
)
from yolojax_torch.serve import load_artifact
from yolojax_torch.serve.tf_graph import export_spec
from yolojax_torch.train import step as train_step
from yolojax_torch.train.checkpoint import Checkpointer
from yolojax_torch.utils import flops
from yolojax_torch.utils.device import full_f32

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 128
# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and f32
# outside the tensor cores, for the kernels' least-time bounds.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12  # tensor cores, dense: the stem's operands are bf16
# f32 operations of one IoU(i, j) > thr test, as the kernel computes it:
# 2 min, 2 max, 2 sub, 2 clamp, 1 mul, 1 add, 1 sub, 1 clamp, 1 div, 1 cmp
IOU_OPS = 14
AREA_OPS = 5  # 2 sub, 2 clamp, 1 mul per box
# f32 forward on the card vs the CPU, TF32 off: summation order only
FORWARD_RTOL = 1e-4
# every kernel of the port, with its own nvcc flags (as its wrapper loads it)
KERNELS = (("nms_greedy", cuda_nms.NVCC_FLAGS),
           ("stem_fused", cuda_stem.NVCC_FLAGS),
           ("int8_requant", cuda_int8.NVCC_FLAGS))
# (N, H, W) inputs of the stem kernel against its plain version: the eval
# batch, one image, a smaller and a larger (multiscale 608) square, a tiny
# one, and a ragged one (W/2 = 67 is no multiple of the tile's 32 columns,
# W = 134 no multiple of 4, so no row is 16-byte aligned)
STEM_CASES = ((BATCH, 416, 416), (1, 416, 416), (3, 320, 320),
              (2, 608, 608), (5, 64, 64), (2, 90, 134))
# kernel vs plain: within nn/stem.py::stem_tolerance (the tensor cores sum
# the exact bf16 products in another order); the printed ratio must be <= 1
# fused-stem head vs the unfused forward, of max|ref|: the stem rounds its
# input and output to bf16 at other points than conv 0 + pool do
STEM_HEAD_RTOL = 3e-2
EVAL_IMAGES, EVAL_BATCH = 64, 32
# the train path: config.ini's batch of 64, six steps, then a resume to 8
TRAIN_STEPS, RESUME_STEPS = 6, 8
# one f32 train step on the card vs the CPU, TF32 off (summation order
# only): loss terms relative, gradients and updated params of the tree's
# max|.|, BN running statistics of their max|.|
TRAIN_LOSS_RTOL, TRAIN_STATE_RTOL, TRAIN_BN_RTOL = 1e-5, 1e-4, 1e-5
# the augment apply, absolute on [0, 1] images of up to 96 px: the card
# divides by a scalar as a multiply by its reciprocal, so the resample's
# scale may sit an ulp or two off the CPU's; sample positions up to 96 px
# then move by up to 2 * 96 * 2^-23 px and the triangle weights by as much,
# times |img - 0.5| <= 0.5 summed over two taps
AUGMENT_ATOL = 4 * 96 * 2.0 ** -23 * 0.5
OVERFIT_STEPS = 300
# the int8 head (a bf16 conv on bf16-rounded dequantized codes) on the card
# vs the CPU: each side within one bf16 ulp of the exact sum, so two ulps
# of the largest value (tests/test_torch_ptq.py::HEAD_RTOL)
INT8_HEAD_RTOL = 2.0 ** -7
# the overfit model's int8 mAP may sit this far below or above its f32 mAP
# (the spirit of yolojax's int8 mAP-delta gate)
INT8_MAP_TOL = 0.05
# f32 operations of one requant value: convert, FMA, compare + multiply +
# select (leaky), multiply, round, two clamps
REQUANT_OPS = 9
# the plain requant on the card runs in chunks of about this many values
# (whole rows), so its float64 temporaries stay a few GB
PLAIN_CHUNK = 1 << 26
INT8_PATHS = ("int8_detect", "int8_stdin", "int8_eval")
# phase 9: QAT -> export -> serve. cli.qat's steps on config.ini; the
# artifacts' fixed batch; the daemon's load
QAT_STEPS, DISTILL_STEPS, ART_BATCH = 3, 2, 8
SERVE_REQUESTS, SERVE_CLIENTS = 32, 8
# one QAT / distill step on the card vs the CPU, TF32 off, from one folded
# state on one batch. The card's forward takes the CPU's value at every
# fake-quantized activation and keeps its own gradient (the estimator
# passes it through as identity): a code flipped at a .5 boundary by the
# convs' other sum order would otherwise move that activation a whole grid
# step, and with it the loss by ~1e-4 and the gradients of the layers after
# it by up to ~1e-2 (an H100 measured 1.4e-2 with two flips). The flips
# are counted and printed. With the codes shared, the train-step limits
# hold: loss terms 1e-5 relative, every gradient leaf 1e-4 of its largest
# |value|; each parameter leaf's change in the step is held to the CPU's
# by the norm of the difference over the norm of the change
# (tests/test_torch_qat.py's 1e-2), the params after it to 1e-4 of their
# largest value. The same steps with TF32 on, the control, must fail the
# limits of the loss, the gradients or the changes.
QAT_LOSS_RTOL, QAT_GRAD_RTOL, QAT_DELTA_RTOL = 1e-5, 1e-4, 1e-2
# yolojax's QAT-beats-PTQ gate (tests/unit/test_qat.py), on this many
# default-initialised nets
GATE_SEEDS = 4
QAT_PATHS = ("qat_eval", "artifact_bf16", "artifact_int8", "serve",
             "artifact_stdin")
# phase 10: converters and tools. The camera loop's frames (two sizes)
CAMERA_FRAMES = 6
TOOL_PATHS = ("weights_detect", "camera", "camera_int8")
# phase 11: multi-device. (a) cli.train in a world-1 nccl group: steps at
# this batch, the eval after the first ones, a resume to the last step
WORLD1_BATCH, WORLD1_STEPS = 16, 3
# (b) two gloo ranks on the one card: full-width Darknet-19 @416, a global
# batch of 32, two steps of each mesh (name, data, model, zero), f32 with
# TF32 off; a constant learning rate so the steps move the weights
MULTI_BATCH, MULTI_STEPS = 32, 2
MULTI_RUNS = (("dp", 2, 1, False), ("zero", 2, 1, True),
              ("tp", 1, 2, False))
MULTI_OVERRIDES = ["train.warmup_steps=0", "train.learning_rate=1e-4"]
# two ranks vs one, the CPU tests' bounds (tests/test_torch_parallel_train.py)
MULTI_LOSS_RTOL, MULTI_PARAM_ATOL, MULTI_BN_RTOL = 1e-5, 1e-5, 1e-5
MULTI_BN_ATOL = 1e-7
MULTI_TIMEOUT = 300  # seconds a spawned group may take before it is killed
MULTI_PATHS = ("world1_train", "dist_eval", "dp_detect", "dp_serve")
# (c) the eval set's first images, evaluated at batch 1
MULTI_EVAL_IMAGES = 32
# phase 12: TF export. The portable builds, whose spec the TF formats bake
TF_PATHS = ("tf_export",)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int) -> list:
    """Per-call device milliseconds of ``fn()``, one CUDA-event pair per
    call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms_queued(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` back-to-back
    calls, with the host's launch overhead kept out: a spin kernel holds the
    stream while every call is enqueued behind it, so the calls then run
    with no gap. Raises if the spin ended before the enqueue did."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not start.query(), "the spin outlasted the enqueue")
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# NMS cases: score-sorted, class-offset corner boxes and a validity mask
# ---------------------------------------------------------------------------


def nms_case(rng: np.random.RandomState, n: int, k: int, num_classes: int,
             valid_frac: float, device) -> tuple:
    cy, cx = rng.uniform(0, 1, (2, n, k))
    h, w = rng.uniform(0.02, 0.5, (2, n, k))
    boxes = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
    classes = rng.randint(0, num_classes, (n, k))
    boxes = boxes + (classes * CLASS_OFFSET)[..., None]
    valid = rng.uniform(0, 1, (n, k)) < valid_frac
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


def kernel_cases(device) -> dict:
    rng = np.random.RandomState(SEED)
    same = torch.tensor([0.1, 0.2, 0.6, 0.5], device=device).expand(4, 256, 4)
    return {
        "n128_k256_voc_80pct_valid": nms_case(rng, 128, 256, 20, 0.8, device),
        "n64_k256_one_class": nms_case(rng, 64, 256, 1, 0.8, device),
        "n16_k100": nms_case(rng, 16, 100, 20, 0.8, device),
        "n1_k1": nms_case(rng, 1, 1, 20, 1.0, device),
        "all_identical": (same.contiguous(),
                          torch.ones((4, 256), dtype=torch.bool, device=device)),
        "all_invalid": (nms_case(rng, 8, 256, 20, 0.0, device)[0],
                        torch.zeros((8, 256), dtype=torch.bool, device=device)),
        "n32_k256_coco80": nms_case(rng, 32, 256, 80, 0.8, device),
        "n8_k300_ragged_word": nms_case(rng, 8, 300, 20, 0.9, device),
        f"n4_k{MAX_K}_largest_k": nms_case(rng, 4, MAX_K, 5, 0.9, device),
    }


def nms_bound_ms(boxes: torch.Tensor, valid: torch.Tensor,
                 keep: torch.Tensor) -> tuple:
    """Least time of greedy NMS on these inputs: the larger of its bytes
    (boxes and valid read once, keep written once) over HBM bandwidth and
    its f32 operations over the non-tensor f32 peak. The operations are
    what this data needs: one area per box, and for each valid box i one
    IoU test against each kept box before it."""
    n, k = valid.shape
    nbytes = boxes.numel() * 4 + valid.numel() + keep.numel()
    kept_before = torch.cumsum(keep.long(), dim=1) - keep.long()
    pairs = int((kept_before * valid.long()).sum())
    ops = IOU_OPS * pairs + AREA_OPS * n * k
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, ops


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def identify() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs on the "
                         "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    return smi


def build_kernels() -> None:
    """One ``nvcc`` per kernel source, all started together."""
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = [(name, pool.submit(build.build, name, flags, verbose=True))
                   for name, flags in KERNELS]
        for name, fut in futures:
            res = fut.result()
            print(f"build {name}: {res.seconds:.2f} s -> {res.path.name}"
                  + ("" if res.seconds else " (already built)"), flush=True)
            for line in res.log.splitlines():
                if "ptxas" in line:
                    print("  " + line.strip(), flush=True)


def compare_kernels(device, iou_thresh: float) -> float:
    """Each kernel against its plain version on the card; returns the
    largest absolute difference (0 for equal keep masks)."""
    worst = 0.0
    for name, (boxes, valid) in kernel_cases(device).items():
        got = nms_greedy_cuda(boxes, valid, iou_thresh)
        want = nms_greedy_torch(boxes, valid, iou_thresh)
        torch.cuda.synchronize()
        err = float((got.int() - want.int()).abs().max())
        worst = max(worst, err)
        print(f"  nms {name}: N={valid.shape[0]} K={valid.shape[1]} "
              f"kept {int(got.sum())}/{int(valid.sum())} valid, "
              f"equal={torch.equal(got, want)}", flush=True)
        check(torch.equal(got, want), f"kernel == plain on {name}")
    for bad, why in (
        (lambda: nms_greedy_cuda(torch.zeros((1, MAX_K + 1, 4), device=device),
                                 torch.ones((1, MAX_K + 1), dtype=torch.bool,
                                            device=device), iou_thresh),
         "K above the limit"),
        (lambda: nms_greedy_cuda(torch.zeros((2, 8, 4), device=device)[:, ::2],
                                 torch.ones((2, 4), dtype=torch.bool,
                                            device=device), iou_thresh),
         "non-contiguous boxes"),
    ):
        try:
            bad()
        except ValueError:
            continue
        raise RuntimeError(f"chip_smoke: the wrapper accepted {why}")
    return worst


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bf16 ulps of two bf16 tensors."""

    def ordinal(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    return (ordinal(a) - ordinal(b)).abs()


def cancelling_bias(w0: torch.Tensor, device) -> torch.Tensor:
    """Minus each channel's mean pre-activation of the bf16 conv over
    uniform [0, 1) images: about half of the sums then cancel to near zero,
    where the order of the additions matters most."""
    x = torch.rand((4, 64, 64, 3), device=device,
                   generator=torch.Generator(device).manual_seed(SEED + 6))
    xb = x.to(torch.bfloat16).double().permute(0, 3, 1, 2)
    wb = w0.to(torch.bfloat16).double().permute(3, 2, 0, 1)  # HWIO -> OIHW
    pre = torch.nn.functional.conv2d(xb, wb, padding=1)
    return (-pre.mean(dim=(0, 2, 3))).float().contiguous()


def compare_stem(device, stem_layer) -> tuple:
    """The stem kernel against its plain version on the card, on
    :data:`STEM_CASES` with random weights, with random weights and a
    cancelling bias, and with ``stem_layer``'s (the seeded Darknet-19's
    folded conv0). Prints, per case, the largest |got - want| / tolerance,
    the largest distance in bf16 ulps and the count of values that are not
    bit-equal; returns the largest absolute difference and ratio."""
    rng = np.random.RandomState(SEED + 2)
    w0 = rng.normal(0, 0.2, (3, 3, 3, 32)).astype(np.float32)
    wp = torch.from_numpy(pack_stem_kernel(w0)).to(device)
    w0 = torch.from_numpy(w0).to(device)
    weights = {
        "random": (wp, torch.from_numpy(rng.normal(0, 0.1, 32).astype(
            np.float32)).to(device)),
        "near-cancellation": (wp, cancelling_bias(w0, device)),
        "darknet19 conv0": (stem_layer.wp, stem_layer.b),
    }
    gen = torch.Generator(device).manual_seed(SEED + 3)
    worst, worst_ratio = 0.0, 0.0
    for n, h, w in STEM_CASES:
        x = torch.rand((n, h, w, 3), device=device, generator=gen)
        for label, (wp, b) in weights.items():
            got = stem_fused_cuda(x, wp, b)
            want = stem_fused_torch(x, wp, b)
            torch.cuda.synchronize()
            check(got.shape == (n, h // 2, w // 2, 32)
                  and got.dtype == torch.bfloat16, "stem output shape/type")
            diff = (got.float() - want.float()).abs()
            tol = stem_tolerance(x, unpack_stem_kernel(wp.float()), b, want)
            ratio = float((diff / tol).max())
            ulps = bf16_ulps(got, want)
            err = float(diff.max())
            worst, worst_ratio = max(worst, err), max(worst_ratio, ratio)
            print(f"  stem ({n}, {h}, {w}) {label} weights: max |err| / "
                  f"tolerance {ratio:.4f}, max {int(ulps.max())} bf16 ulp, "
                  f"{int((ulps > 0).sum())} of {ulps.numel()} values not "
                  f"bit-equal, max abs err {err:.3g}", flush=True)
            check(ratio <= 1.0, f"stem kernel within stem_tolerance of plain "
                                f"on ({n}, {h}, {w}) {label}")
            del got, want, ulps, diff, tol
    wp, b = weights["random"]
    for bad, why in (
        (lambda: stem_fused_cuda(torch.zeros((1, 415, 416, 3), device=device),
                                 wp, b), "an odd H"),
        (lambda: stem_fused_cuda(torch.zeros((1, 416, 832, 3),
                                             device=device)[:, :, ::2],
                                 wp, b), "a non-contiguous input"),
        (lambda: stem_fused_cuda(torch.zeros((1, 64, 64, 3), device=device,
                                             dtype=torch.float16), wp, b),
         "an f16 input"),
        (lambda: stem_fused_cuda(torch.zeros((1, 64, 64, 3), device=device),
                                 wp[..., :64], b[:16]), "Co = 16"),
    ):
        try:
            bad()
        except ValueError:
            continue
        raise RuntimeError(f"chip_smoke: the stem wrapper accepted {why}")
    return worst, worst_ratio


def random_weights(cfg, path: str) -> None:
    """Full-width weights from SEED with random BN statistics, written
    through the port's .npz store."""
    model = cfg.build_model()
    gen = torch.Generator().manual_seed(SEED)
    net = model.init(gen, cfg.model.dim)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1, generator=gen)
                layer.var.uniform_(0.5, 1.5, generator=gen)
                layer.scale.uniform_(0.5, 1.5, generator=gen)
                layer.bias.normal_(0.0, 0.1, generator=gen)
    save_network_npz(path, model, net)


def synthetic_images(rng: np.random.RandomState) -> list:
    """Decoded RGB uint8 images of a few camera sizes: smooth colour
    fields plus noise, so the letterbox resize has real work."""
    images = []
    for h, w in ((375, 500), (480, 640), (416, 416), (720, 1280)):
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        base = np.stack([np.sin(6 * xx + c) * np.cos(4 * yy - c)
                         for c in (0.0, 1.0, 2.0)], -1)
        img = 127.5 * (1 + base) + rng.normal(0, 12, (h, w, 3))
        images.append(np.clip(img, 0, 255).astype(np.uint8))
    return images


def drive_main_path(cfg, npz: str, device, batch: int) -> dict:
    """The serving path as a user drives it: ``build_detector``, then
    ``run_detect`` on decoded images of a few sizes and ``infer`` on a
    batch of canvases. Counts the kernel launches of exactly that run."""
    detector = build_detector(cfg, npz, device=device)
    _, dim, infer = detector
    images = synthetic_images(np.random.RandomState(SEED))
    gen = torch.Generator(device).manual_seed(SEED)
    canvases = torch.rand((batch, dim, dim, 3), device=device, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize()
    nms_greedy_cuda.launches = 0
    stem_fused_cuda.launches = 0
    int8_requant_cuda.launches = 0
    with contextlib.redirect_stdout(io.StringIO()) as det_lines:
        results = run_detect(cfg, npz, images, detector=detector)
    out = infer(canvases)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = nms_greedy_cuda.launches
    print(f"phase serving path: nms_greedy launches {launches}, stem_fused "
          f"launches {stem_fused_cuda.launches}, int8_requant launches "
          f"{int8_requant_cuda.launches} (detect.fuse_stem="
          f"{cfg.detect.fuse_stem})", flush=True)
    for label, raw, dets in results:
        print(f"  run_detect {label} {raw.shape[1]}x{raw.shape[0]}: "
              f"{len(dets)} detections", flush=True)
    check(len(det_lines.getvalue().splitlines())
          == sum(len(r[2]) for r in results), "one line per detection")
    return {"launches": launches, "stem_launches": stem_fused_cuda.launches,
            "int8_launches": int8_requant_cuda.launches,
            "out": out, "canvases": canvases, "infer": infer}


def check_main_path(cfg, out: dict, device) -> tuple:
    """The path's output: shapes, finite values, and its keep mask equal to
    the plain sweep on the path's own candidates. Returns those candidates
    (class-shifted boxes, valid) and the path's keep, on ``device``."""
    n, k = out["keep"].shape
    check(out["boxes"].shape == (n, k, 4) and k == cfg.detect.top_k,
          "output shapes")
    check(all(np.isfinite(out[key]).all() for key in ("boxes", "scores")),
          "finite boxes and scores")
    boxes = torch.from_numpy(out["boxes"]).to(device)
    classes = torch.from_numpy(out["classes"]).to(device)
    scores = torch.from_numpy(out["scores"]).to(device)
    # the expressions of postprocess/nms.py::_run_nms, so the same floats
    shifted = boxes + (classes.float() * CLASS_OFFSET)[..., None]
    valid = scores > cfg.detect.threshold
    keep = torch.from_numpy(out["keep"]).to(device)
    plain = nms_greedy_torch(shifted, valid, cfg.detect.nms_iou)
    print(f"  b{n}: {int(valid.sum())} valid of {valid.numel()} candidates, "
          f"{int(keep.sum())} kept; keep == plain sweep: "
          f"{torch.equal(keep, plain)}", flush=True)
    check(torch.equal(keep, plain), "path keep == plain sweep")
    check(0 < int(keep.sum()) < int(valid.sum()),
          "NMS did real work on the path")
    return shifted, valid, keep


def check_forward(cfg, npz: str, device, dim: int):
    """The f32 forward on ``device`` (TF32 off) against the CPU on a small
    input; returns the BN-folded model."""
    model = cfg.build_model()
    model, net_cpu = fold_bn(model, load_network_npz(npz, model))
    net_dev = copy.deepcopy(net_cpu).to(device)
    small = torch.rand((2, dim, dim, 3),
                       generator=torch.Generator().manual_seed(SEED + 1))
    with full_f32(), torch.inference_mode():
        ref = model.apply(net_cpu, small, compute_dtype=torch.float32)
        got = model.apply(net_dev, small.to(device),
                          compute_dtype=torch.float32).cpu()
        bf = model.apply(net_dev, small.to(device),
                         compute_dtype=torch.bfloat16).cpu()
    check(bool(torch.isfinite(bf).all()), "finite bf16 head")
    rel = float((got - ref).abs().max() / ref.abs().max())
    rel_bf = float((bf - ref).abs().max() / ref.abs().max())
    print(f"  f32 head on {device.type} vs CPU at {dim}: max err {rel:.2e} "
          f"of max|ref| (limit {FORWARD_RTOL:g}); bf16 head: {rel_bf:.2e}",
          flush=True)
    check(rel <= FORWARD_RTOL, "f32 forward on the card == CPU")
    return model


def write_eval_set(root: str, names, n_images: int) -> tuple:
    """A seeded COCO-layout set of PPM images of several camera sizes, with
    one to three boxes each over the config's class names. Returns
    (instances.json path, image directory)."""
    rng = np.random.RandomState(SEED + 4)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, anns = [], []
    sizes = ((375, 500), (480, 640), (416, 416), (500, 333), (240, 320))
    for i in range(n_images):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        phase = rng.uniform(0, 3)
        base = np.stack([np.sin(6 * xx + c + phase) * np.cos(4 * yy - c)
                         for c in (0.0, 1.0, 2.0)], -1)
        img = 127.5 * (1 + base) + rng.normal(0, 12, (h, w, 3))
        write_ppm(os.path.join(img_dir, f"{i:06d}.ppm"),
                  np.clip(img, 0, 255).astype(np.uint8))
        images.append({"id": i + 1, "file_name": f"{i:06d}.ppm", "width": w,
                       "height": h})
        for _ in range(rng.randint(1, 4)):
            bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8, h // 2)
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(rng.randint(len(names))) + 1,
                         "bbox": [int(rng.randint(0, w - bw)),
                                  int(rng.randint(0, h - bh)), bw, bh],
                         "iscrowd": 0})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c + 1, "name": n}
                                  for c, n in enumerate(names)]}, f)
    return ann, img_dir


def run_cli(module, argv: list):
    """``python -m <module> argv...`` in this process; returns main()'s
    value and what it printed."""
    saved = sys.argv
    sys.argv = [module.__name__, *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            result = module.main()
    finally:
        sys.argv = saved
    return result, out.getvalue()


def eval_argv(npz: str, cache_dir: str, device, overrides=()) -> list:
    return (["-c", "config.ini", "--weights", npz, f"cache.basedir={cache_dir}",
             "detect.fuse_stem=pallas", f"eval.batch_size={EVAL_BATCH}",
             *overrides]
            + (["--device", "cpu"] if device.type == "cpu" else []))


def drive_eval_path(npz: str, tmp: str, device, n_images: int,
                    overrides=()) -> dict:
    """The eval path as a user drives it: ``cli.cache`` over a fresh set,
    then ``cli.eval`` with the fused stem. Counts the kernel launches of
    exactly that eval run; returns them with the metrics and the cache."""
    names = load_config(["config.ini"]).names()
    ann, img_dir = write_eval_set(os.path.join(tmp, "eval_set"), names,
                                  n_images)
    cache_dir = os.path.join(tmp, "cache")
    _, printed = run_cli(cache_cli, ["-c", "config.ini",
                                     f"cache.basedir={cache_dir}",
                                     f"cache.test=coco:{ann}:{img_dir}",
                                     *overrides])
    print(f"phase eval path: cli.cache: {printed.strip()}", flush=True)
    argv = eval_argv(npz, cache_dir, device, overrides)
    if device.type == "cuda":
        torch.cuda.synchronize()
    nms_greedy_cuda.launches = 0
    stem_fused_cuda.launches = 0
    int8_requant_cuda.launches = 0
    t0 = time.perf_counter()
    metrics, printed = run_cli(eval_cli, argv)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"nms_greedy": nms_greedy_cuda.launches,
                "stem_fused": stem_fused_cuda.launches,
                "int8_requant": int8_requant_cuda.launches}
    lines = printed.splitlines()
    for line in lines[:-1]:
        print(f"  cli.eval: {line}", flush=True)
    print(f"  cli.eval launches {launches}, {seconds:.2f} s for {n_images} "
          "images (first run, builds the cuDNN plans)", flush=True)
    check(json.loads(lines[-1]) == {
        k: (None if isinstance(v, float) and v != v else v)
        for k, v in metrics.items()}, "the JSON line is the metrics")
    check(metrics["num_images"] == n_images, "every image evaluated")
    check(all(np.isfinite(v) for k, v in metrics.items()
              if k in ("map", "num_detections") or k.startswith("ap_")),
          "finite metrics")
    check(metrics["num_detections"] > 0, "the eval run detected something")
    return {"launches": launches, "metrics": metrics, "cache_dir": cache_dir,
            "argv": argv, "seconds": seconds, "img_dir": img_dir}


def check_fused_head(cfg, npz: str, cache_dir: str, device) -> None:
    """Batch 0 of the eval set through the fused-stem forward (the stem
    kernel on the card) against the unfused forward, in the serving dtype."""
    cache = load_cache(cache_dir, "test")
    images = next(Loader(cache, LoaderConfig(
        batch_size=EVAL_BATCH, canvas_dim=cfg.model.dim, max_boxes=64,
        drop_remainder=False, num_threads=4)).epoch(0, shuffle=False))[0]
    model = cfg.build_model()
    model, net = fold_bn(model, load_network_npz(npz, model))
    fused_model, fused = fuse_stem(model, copy.deepcopy(net), impl="pallas")
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    net = serving_weights(net, device, dtype)
    fused = serving_weights(fused, device, dtype)
    x = torch.from_numpy(images).to(device)
    with torch.inference_mode():
        ref = model.apply(net, x, compute_dtype=dtype)
        got = fused_model.apply(fused, x, compute_dtype=dtype)
    check(bool(torch.isfinite(got).all()), "finite fused head")
    rel = float((got - ref).abs().max() / ref.abs().max())
    print(f"  batch 0 ({x.shape[0]} images) head, fused stem vs unfused: max "
          f"err {rel:.2e} of max|ref| (limit {STEM_HEAD_RTOL:g})", flush=True)
    check(rel <= STEM_HEAD_RTOL, "fused-stem head == unfused head")


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def log_lines(name: str):
    """The messages logged to logger ``name`` inside the block."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger(name)
    logger.addHandler(handler)
    try:
        yield lines
    finally:
        logger.removeHandler(handler)


def metric_rows(logdir: str) -> list:
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def drive_train_path(tmp: str, device, n_images: int, overrides=()) -> dict:
    """The training path as a user drives it: ``cli.cache`` over a fresh
    set (its train and val phases), ``cli.train`` for six steps with
    checkpoints every three, the EMA and an in-training eval at step six
    with the fused stem, then the same command to step eight, which must
    resume. Counts the kernel launches of the first run."""
    names = load_config(["config.ini"]).names()
    ann, img_dir = write_eval_set(os.path.join(tmp, "train_set"), names,
                                  n_images)
    cache_dir = os.path.join(tmp, "train_cache")
    _, printed = run_cli(cache_cli, ["-c", "config.ini",
                                     f"cache.basedir={cache_dir}",
                                     f"cache.train=coco:{ann}:{img_dir}",
                                     f"cache.val=coco:{ann}:{img_dir}",
                                     *overrides])
    print(f"phase train path: cli.cache: {' / '.join(printed.splitlines())}",
          flush=True)
    cfg = load_config(["config.ini"], overrides)
    root = os.path.join(tmp, "train_logdir")
    logdir = os.path.join(root, f"{cfg.model.model}_{cfg.model.inference}")
    argv = ["-c", "config.ini", f"cache.basedir={cache_dir}",
            f"train.logdir={root}", "train.save_steps=3",
            "train.summary_steps=1", f"train.eval_steps={TRAIN_STEPS}",
            "train.ema_decay=0.999", "detect.fuse_stem=pallas",
            f"eval.batch_size={EVAL_BATCH}", *overrides]
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    if device.type == "cuda":
        torch.cuda.synchronize()
    nms_greedy_cuda.launches = 0
    stem_fused_cuda.launches = 0
    int8_requant_cuda.launches = 0
    t0 = time.perf_counter()
    with log_lines("train") as first:
        run_cli(train_cli, argv + [f"train.steps={TRAIN_STEPS}", *cpu])
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"nms_greedy": nms_greedy_cuda.launches,
                "stem_fused": stem_fused_cuda.launches,
                "int8_requant": int8_requant_cuda.launches}
    rows = metric_rows(logdir)
    losses = [r for r in rows if "total" in r]
    print(f"  cli.train to step {TRAIN_STEPS}: {seconds:.2f} s (first run: "
          f"cuDNN plans, checkpoints, the eval); launches {launches}",
          flush=True)
    for r in losses:
        print(f"  step {r['step']}: loss {r['total']:.4f} (coord "
              f"{r['coord']:.3f} obj {r['object']:.3f} noobj "
              f"{r['noobject']:.3f} cls {r['class']:.3f}) grad_norm "
              f"{r['grad_norm']:.3f}, {r['images_per_sec']:.1f} img/s",
              flush=True)
    check([r["step"] for r in losses] == list(range(1, TRAIN_STEPS + 1)),
          "every step logged once")
    check(all(np.isfinite(r[k]) for r in losses for k in r),
          "finite loss rows")
    check([r["step"] for r in rows if "val_map" in r] == [TRAIN_STEPS],
          "one in-training eval")
    steps = Checkpointer(os.path.join(logdir, "ckpt")).steps()
    check({3, TRAIN_STEPS} <= set(steps), "checkpoints at steps 3 and 6")
    print(f"  val_map {[r['val_map'] for r in rows if 'val_map' in r]}, "
          f"checkpoints {steps}", flush=True)
    with log_lines("train") as resumed:
        run_cli(train_cli, argv + [f"train.steps={RESUME_STEPS}", *cpu])
    losses = [r["step"] for r in metric_rows(logdir) if "total" in r]
    check(f"resumed from step {TRAIN_STEPS}" in resumed,
          f"the second run resumed from step {TRAIN_STEPS}")
    check(losses == list(range(1, RESUME_STEPS + 1)),
          "every step logged once across the resume")
    print(f"  cli.train to step {RESUME_STEPS}: "
          f"{[m for m in resumed if m.startswith('resumed')]}, steps "
          f"logged {losses}", flush=True)
    del first
    return {"launches": launches, "logdir": logdir, "cache_dir": cache_dir,
            "image": os.path.join(img_dir, "000000.ppm"),
            "images_per_sec": [r["images_per_sec"] for r in rows
                               if "total" in r],
            "seconds": seconds}


def check_checkpoint_as_weights(tr: dict, device, overrides=()) -> None:
    """``cli.eval`` and ``cli.detect`` (EMA weights) take the training
    logdir as ``--weights``."""
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    metrics, _ = run_cli(eval_cli, [
        "-c", "config.ini", "--weights", tr["logdir"], "--phase", "val",
        f"cache.basedir={tr['cache_dir']}", "detect.fuse_stem=pallas",
        f"eval.batch_size={EVAL_BATCH}", *overrides, *cpu])
    check(metrics["num_images"] > 0 and np.isfinite(metrics["map"]),
          "cli.eval on the checkpoint dir")
    with log_lines("yolojax_torch.utils.restore") as restore:
        _, printed = run_cli(detect_cli, [
            "-c", "config.ini", "--weights", tr["logdir"], "--image",
            tr["image"], "detect.use_ema=1", "detect.threshold=0.005",
            *overrides, *cpu])
    check("using EMA (Polyak-averaged) weights" in restore,
          "cli.detect took the EMA weights")
    print(f"  cli.eval --weights <logdir>: mAP {metrics['map']:.4f} over "
          f"{metrics['num_images']} images, {metrics['num_detections']} "
          f"detections; cli.detect --weights <logdir> detect.use_ema=1: "
          f"{len(printed.splitlines())} detections ({restore[0]})",
          flush=True)


def _tree_err(got: dict, want: dict) -> float:
    """max |got - want| over a dict of tensors, of the dict's max |want|."""
    scale = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].detach().cpu() - w.detach()).abs().max())
               for k, w in want.items()) / max(scale, 1e-30)


def check_train_card_vs_cpu(device) -> dict:
    """One f32 train step of a small v2 (tiny @ 96, batch 4, momentum with
    decay) from the same state on ``device`` and on the CPU, TF32 off;
    and the augmentation apply with the same parameters on both."""
    model = get_model("yolo2", "tiny", 20)
    net = model.init(torch.Generator().manual_seed(SEED + 7), 96)
    rng = np.random.RandomState(SEED + 7)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (4, 8, 2)),
                            rng.uniform(0.05, 0.4, (4, 8, 2))], -1)
    batch = (torch.from_numpy(rng.uniform(0, 1, (4, 96, 96, 3)).astype(
                 np.float32)),
             torch.from_numpy(boxes.astype(np.float32)),
             torch.from_numpy(rng.randint(0, 20, (4, 8)).astype(np.int32)),
             torch.from_numpy(rng.uniform(0, 1, (4, 8)) < 0.6))
    tx = train_step.make_optimizer(train_step.OptimizerConfig(
        optimizer="momentum", learning_rate=1e-3, weight_decay=5e-4))
    fn = train_step.make_train_step(model, tx, augment=False,
                                    compute_dtype=torch.float32)
    params = augment.draw_params(torch.Generator().manual_seed(SEED + 7), 4,
                                 augment.AugmentConfig())
    out = {}
    with full_f32():
        for dev in (torch.device("cpu"), device):
            ts = train_step.TrainState(0, copy.deepcopy(net).to(dev), None)
            ts.opt_state = tx.init(ts.params())
            ts, m = fn(ts, tuple(t.to(dev) for t in batch), SEED, 96,
                       with_grads=True)
            p = augment.AugmentParams(**{k: v.to(dev) for k, v in
                                         params.__dict__.items()})
            img, bx, _ = augment.apply_geometry(
                batch[0].to(dev), batch[1].to(dev), batch[3].to(dev), 80, p)
            geo = img.cpu()
            if dev.type == "cpu":  # the jitter gets the same input on both
                jitter_in = img
            img = augment.apply_color_jitter(jitter_in.to(dev), p)
            out[dev.type] = (ts, m, geo, img.cpu(), bx.cpu())
    (ts_c, m_c, geo_c, img_c, bx_c), (ts_d, m_d, geo_d, img_d, bx_d) = (
        out["cpu"], out[device.type])
    loss_err = max(abs(float(m_d[k]) - float(m_c[k]))
                   / max(abs(float(m_c[k])), 1e-30)
                   for k in ("coord", "object", "noobject", "class", "total"))
    grad_err = _tree_err(m_d["grads"], m_c["grads"])
    param_err = _tree_err(ts_d.params(), {k: v.detach() for k, v in
                                          ts_c.params().items()})
    bn_err = _tree_err(dict(ts_d.net.named_buffers()),
                       dict(ts_c.net.named_buffers()))
    geo_err = float((geo_d - geo_c).abs().max())
    jit_err = float((img_d - img_c).abs().max())
    box_err = float((bx_d - bx_c).abs().max())
    aug_err = max(geo_err, jit_err, box_err)
    print(f"  train step tiny@96 b4 f32, {device.type} vs CPU (TF32 off): "
          f"loss terms {loss_err:.2e} relative (limit {TRAIN_LOSS_RTOL:g}), "
          f"gradients {grad_err:.2e} and updated params {param_err:.2e} of "
          f"max (limit {TRAIN_STATE_RTOL:g}), BN stats {bn_err:.2e} (limit "
          f"{TRAIN_BN_RTOL:g}); augment apply max abs err: geometry "
          f"{geo_err:.2e}, jitter {jit_err:.2e}, boxes {box_err:.2e} (limit "
          f"{AUGMENT_ATOL:g})", flush=True)
    check(loss_err <= TRAIN_LOSS_RTOL, "train loss on the card == CPU")
    check(grad_err <= TRAIN_STATE_RTOL and param_err <= TRAIN_STATE_RTOL,
          "gradients and updated params on the card == CPU")
    check(bn_err <= TRAIN_BN_RTOL, "BN running stats on the card == CPU")
    check(aug_err <= AUGMENT_ATOL, "augment apply on the card == CPU")
    return {"loss": loss_err, "grads": grad_err, "params": param_err,
            "bn": bn_err, "augment": aug_err}


def overfit_set(n: int = 8, dim: int = 48):
    """tests/e2e/test_overfit.py's set: gray images with one colored
    rectangle each; class = color."""
    rng = np.random.RandomState(0)
    images = np.full((n, dim, dim, 3), 0.5, np.float32)
    boxes = np.zeros((n, 2, 4), np.float32)
    classes = np.zeros((n, 2), np.int32)
    valid = np.zeros((n, 2), bool)
    for i in range(n):
        w, h = rng.uniform(0.3, 0.5, 2)
        cx = rng.uniform(w / 2 + 0.05, 1 - w / 2 - 0.05)
        cy = rng.uniform(h / 2 + 0.05, 1 - h / 2 - 0.05)
        x0, y0 = int((cx - w / 2) * dim), int((cy - h / 2) * dim)
        x1, y1 = int((cx + w / 2) * dim), int((cy + h / 2) * dim)
        images[i, y0:y1, x0:x1] = [0.9, 0.1, 0.1] if i % 2 == 0 else [
            0.1, 0.1, 0.9]
        boxes[i, 0] = [cx, cy, w, h]
        classes[i, 0] = i % 2
        valid[i, 0] = True
    return images, boxes, classes, valid


def check_overfit(device) -> tuple:
    """The four-conv model of tests/e2e/test_overfit.py trained on its 8
    images at 48 px with Adam 2e-3, in bf16 on ``device``: the last loss
    must be under a tenth of the first."""
    anchors = ((2.0, 2.0), (4.0, 4.0))
    model = Model("yolo2", "overfit", "v2", (
        ConvSpec(16, 3), MaxPoolSpec(), ConvSpec(32, 3), MaxPoolSpec(),
        ConvSpec(32, 3), ConvSpec(2 * 7, 1, bn=False, act="linear")),
        2, 4, anchors=anchors)
    tx = train_step.make_optimizer(train_step.OptimizerConfig(
        optimizer="adam", learning_rate=2e-3, weight_decay=0.0))
    ts = train_step.init_train_state(model, tx,
                                     torch.Generator().manual_seed(SEED), 48,
                                     device)
    fn = train_step.make_train_step(model, tx, augment=False,
                                    compute_dtype=torch.bfloat16)
    batch = tuple(torch.from_numpy(a).to(device) for a in overfit_set())
    losses = []
    for _ in range(OVERFIT_STEPS):
        ts, m = fn(ts, batch, SEED, 48)
        losses.append(m["total"])
    losses = torch.stack(losses).float().cpu()
    first, last = float(losses[0]), float(losses[-1])
    print(f"  overfit on {device.type} (bf16, {OVERFIT_STEPS} steps, Adam "
          f"2e-3): loss {first:.4f} -> {last:.4f} ({last / first:.4f} of the "
          f"first; limit 0.1)", flush=True)
    check(np.isfinite(last) and last < 0.1 * first, "the model learns")
    return first, last, model, ts.net


def train_batch(cfg, device) -> tuple:
    """A device-resident batch of the config's shape: canvases in [0, 1)
    and one to four boxes an image."""
    n, canvas, g = (cfg.queue.batch_size, cfg.queue.canvas_dim,
                    cfg.queue.max_boxes)
    gen = torch.Generator(device).manual_seed(SEED + 8)
    xy = 0.2 + 0.6 * torch.rand((n, g, 2), device=device, generator=gen)
    wh = 0.05 + 0.35 * torch.rand((n, g, 2), device=device, generator=gen)
    classes = torch.randint(0, cfg.build_model().num_classes, (n, g),
                            device=device, generator=gen, dtype=torch.int32)
    valid = torch.arange(g, device=device)[None, :] < torch.randint(
        1, 5, (n, 1), device=device, generator=gen)
    return (torch.rand((n, canvas, canvas, 3), device=device, generator=gen),
            torch.cat([xy, wh], -1), classes, valid)


def time_train_step(cfg, device, card: str) -> dict:
    """The config's train step (augment, bf16 train-mode forward, loss,
    backward, update) on a device-resident batch: CUDA events, median of 5
    after 2 warm-up steps; the step's peak device memory; its profile."""
    model = cfg.build_model()
    tx = train_step.make_optimizer(cfg.optimizer)
    state = {"ts": train_step.init_train_state(
        model, tx, torch.Generator().manual_seed(SEED), cfg.model.dim,
        device)}
    fn = train_step.make_train_step(
        model, tx, loss_cfg=cfg.loss_config(), aug_cfg=cfg.augment,
        augment=True, compute_dtype=torch.bfloat16)
    batch = train_batch(cfg, device)

    def one():
        state["ts"], m = fn(state["ts"], batch, SEED, cfg.model.dim)
        return m

    one()
    times = cuda_ms(one, 5)  # after its own warm-up step: 2 in all
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m = one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(m["total"])), "finite timed train loss")
    ms = statistics.median(times)
    n = batch[0].shape[0]
    print(f"  [{card}] train step b{n}@{cfg.model.dim} bf16 (canvas "
          f"{batch[0].shape[1]}, augment + forward + loss + backward + "
          f"{cfg.optimizer.optimizer} update), device-resident: {ms:.3f} "
          f"ms/step (median of 5: {', '.join(f'{t:.3f}' for t in times)}), "
          f"{n / ms * 1e3:.1f} img/s, peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)
    profile_batch(one, card + ", train step")
    del state
    torch.cuda.empty_cache()
    return {"ms": ms, "img_s": n / ms * 1e3, "peak_gib": peak / 2**30}


def profile_batch(fn, card: str, top: int = 10) -> None:
    """Device time of one call by kernel name (``torch.profiler``), and the
    device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(r[0] for r in rows)
    print(f"  [{card}] profile of one batch: device busy {busy_us / 1e3:.3f} "
          f"ms of {wall_us / 1e3:.3f} ms wall ({busy_us / wall_us:.1%}); "
          f"top kernels by device time:", flush=True)
    for us, count, key in sorted(rows, reverse=True)[:top]:
        print(f"    {us / 1e3:8.3f} ms {us / busy_us:6.1%} x{count:<4d} "
              f"{key[:90]}", flush=True)


def time_path(cfg, npz: str, model, run: dict, card: str) -> None:
    """Device time of the serving program on a device-resident batch, its
    postprocess share and peak memory; host-clock batch and batch-1 times
    through the user's ``infer``."""
    _, dim, infer_fn, net, _ = build_serving(cfg, npz)
    canvases, infer = run["canvases"], run["infer"]
    batch = canvases.shape[0]
    torch.cuda.reset_peak_memory_stats()
    full = cuda_ms(lambda: infer_fn(net, canvases), 5)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        head = model.apply(net, canvases, compute_dtype=torch.bfloat16)
        check(bool(torch.isfinite(head).all()), f"finite b{batch} head")

        def post():
            return postprocess_v2(
                head, model.anchors, score_thresh=cfg.detect.threshold,
                iou_thresh=cfg.detect.nms_iou, top_k=cfg.detect.top_k,
                use_pallas=cfg.detect.use_pallas,
                candidates=cfg.detect.candidates)

        post_times = cuda_ms(post, 5)
    full_ms, post_ms = statistics.median(full), statistics.median(post_times)
    print(f"  [{card}] b{batch}@{dim} bf16 device-resident: {full_ms:.3f} "
          f"ms/batch (median of 5: {', '.join(f'{t:.3f}' for t in full)}), "
          f"{batch / full_ms * 1e3:.1f} img/s", flush=True)
    print(f"  [{card}] postprocess (decode + top-K + NMS): {post_ms:.3f} ms "
          f"= {post_ms / full_ms:.1%} of the batch", flush=True)
    print(f"  [{card}] peak device memory b{batch}: {peak / 2**30:.2f} GiB",
          flush=True)
    profile_batch(lambda: infer_fn(net, canvases), card)
    host_batch = canvases.cpu().numpy()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        infer(host_batch)
        host.append((time.perf_counter() - t0) * 1e3)
    print(f"  [{card}] b{batch} host numpy in -> numpy out: "
          f"{statistics.median(host[1:]):.3f} ms/batch", flush=True)
    one = host_batch[:1]
    infer(one)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        infer(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(f"  [{card}] batch-1 latency, host numpy in -> numpy out: p50 "
          f"{statistics.median(lat):.3f} ms, min {min(lat):.3f} ms (20 runs)",
          flush=True)


def serving_programs(npz: str) -> dict:
    """The b128 serving program with ``detect.fuse_stem`` off and pallas:
    {setting: (infer_fn, net)}."""
    progs = {}
    for fuse in ("off", "pallas"):
        cfg = load_config(["config.ini"], ["detect.threshold=0.005",
                                           f"detect.fuse_stem={fuse}"])
        _, _, infer_fn, net, _ = build_serving(cfg, npz)
        progs[fuse] = (infer_fn, net)
    return progs


def check_auto_launches(npz: str, device) -> None:
    """``detect.fuse_stem=auto`` on the card runs the stem kernel too."""
    cfg = load_config(["config.ini"], ["detect.fuse_stem=auto"])
    _, dim, infer_fn, net, _ = build_serving(cfg, npz, device=device)
    x = torch.rand((2, dim, dim, 3), device=device,
                   generator=torch.Generator(device).manual_seed(SEED + 5))
    stem_fused_cuda.launches = 0
    infer_fn(net, x)
    torch.cuda.synchronize()
    print(f"  detect.fuse_stem=auto: stem_fused launches "
          f"{stem_fused_cuda.launches} for one batch", flush=True)
    check(stem_fused_cuda.launches == 1, "fuse_stem=auto runs the kernel")


def time_fusion(progs: dict, canvases, card: str) -> dict:
    """The device-resident batch through each serving program in turns
    (bf16 unfused and fused stem, int8 with the stem off and packed, then
    back), with peak device memory; then the profile of one fused bf16 and
    one int8 batch. Returns {program: [ms of each turn]}."""
    batch, dim = canvases.shape[0], canvases.shape[1]
    turns = ("off", "pallas", "int8-off", "int8-xla")
    times = {fuse: [] for fuse in progs}
    peaks = dict.fromkeys(progs, 0)
    for fuse in turns + turns[::-1]:
        if fuse not in progs:
            continue
        infer_fn, net = progs[fuse]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[fuse].append(statistics.median(
            cuda_ms(lambda: infer_fn(net, canvases), 5)))
        peaks[fuse] = max(peaks[fuse], torch.cuda.max_memory_allocated())
    for fuse, ms in times.items():
        mean = statistics.mean(ms)
        kind = ("int8, detect.fuse_stem=" + fuse[5:] if fuse.startswith("int8")
                else "bf16, detect.fuse_stem=" + fuse)
        print(f"  [{card}] b{batch}@{dim} {kind} device-resident: {mean:.3f} "
              f"ms/batch (medians of 5 in two turns: "
              f"{', '.join(f'{t:.3f}' for t in ms)}), "
              f"{batch / mean * 1e3:.1f} img/s, peak device memory "
              f"{peaks[fuse] / 2**30:.2f} GiB (all programs' weights "
              "resident)", flush=True)
    check(max(times["pallas"]) < min(times["off"]),
          "the fused-stem batch is faster than the unfused one")
    for fuse, label in (("pallas", "fused stem"), ("int8-off", "int8")):
        if fuse in progs:
            infer_fn, net = progs[fuse]
            profile_batch(lambda: infer_fn(net, canvases), f"{card}, {label}")
    return times


def stem_bound_ms(x: torch.Tensor, stem_layer) -> tuple:
    """Least time of the fused stem on ``x``: the larger of its bytes (the
    f32 input, weights and bias read once, the bf16 output written once)
    over HBM bandwidth and its multiply-adds (27 taps x 32 channels for each
    of the four pool phases of every pooled pixel) over the bf16 peak."""
    n, h, w, _ = x.shape
    pixels = n * (h // 2) * (w // 2)
    co = stem_layer.b.numel()
    nbytes = (x.numel() * 4 + stem_layer.wfrag.numel() * 4 + co * 4
              + pixels * co * 2)
    ops = pixels * 4 * 27 * co * 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, ops


def time_stem(progs: dict, canvases, card: str) -> dict:
    """The stem kernel's device time on the batch (launch overhead kept
    out), its plain version's time, the unfused stage it replaces (conv 0
    through cuDNN in bf16, the f32 bias + leaky epilogue, the cast, pool 1,
    as the unfused forward runs them) and the kernel's bound."""
    stem_layer = progs["pallas"][1].conv_0
    conv0 = progs["off"][1].conv_0
    x = canvases
    n, h, w, _ = x.shape

    def kernel():
        return stem_fused_cuda(x, stem_layer.wp, stem_layer.b,
                               wfrag=stem_layer.wfrag)

    def unfused():
        y = conv2d(x, conv0.w, 1, compute_dtype=torch.bfloat16).float()
        y = leaky_relu(y + conv0.b.float())
        return max_pool(y.to(torch.bfloat16), 2, 2)

    ms = cuda_ms_queued(kernel, 50)
    call_ms = statistics.median(cuda_ms(kernel, 10))
    unfused_ms = statistics.median(cuda_ms(unfused, 5))
    conv_ms = statistics.median(cuda_ms(
        lambda: conv2d(x, conv0.w, 1, compute_dtype=torch.bfloat16), 5))
    plain_ms = statistics.median(cuda_ms(
        lambda: stem_fused_torch(x, stem_layer.wp, stem_layer.b), 2))
    bound_ms, bound_by, nbytes, ops = stem_bound_ms(x, stem_layer)
    print(f"  [{card}] stem_fused at ({n}, {h}, {w}): kernel {ms:.3f} ms on "
          f"the device ({call_ms:.3f} ms a call from Python), bound "
          f"{bound_ms:.3f} ms ({bound_by}: {nbytes} B, {ops} bf16 ops), "
          f"plain version {plain_ms:.3f} ms, unfused stage {unfused_ms:.3f} "
          f"ms (of which the cuDNN conv {conv_ms:.3f} ms), library none",
          flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def time_eval(argv: list, n_images: int, card: str,
              program: str = "fused stem") -> None:
    """A second run of the same ``cli.eval`` (plans built): images/s of
    the whole path, host loader and mAP included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(eval_cli, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"  [{card}] cli.eval, {n_images} images at batch {EVAL_BATCH}, "
          f"{program}: {seconds:.3f} s = {n_images / seconds:.1f} img/s "
          "(cache load, host decode + letterbox, device, mAP)", flush=True)


def kernel_device_us(fn, reps: int) -> dict:
    """Device microseconds a call of each kernel ``fn()`` launches, by kernel
    name, from one ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def time_nms(shifted, valid, keep, iou_thresh: float, card: str) -> dict:
    """The kernel's device time (launch overhead kept out), its build and
    sweep kernels timed apart (profiler, by kernel name), its time per call
    from Python (through the wrapper and its custom op, and through the
    ctypes launcher alone: the op's dispatch cost), the plain sweep's time
    per call (one CUDA-event pair around each call: ~1,300 small launches,
    so mostly host time), and the kernel's bound on these inputs."""
    n, k = valid.shape

    def kernel():
        return nms_greedy_cuda(shifted, valid, iou_thresh)

    ms = cuda_ms_queued(kernel, 200)
    by_name = kernel_device_us(kernel, 200)
    phase_ms = {}
    for name, fn_name in (("build_ms", "nms_build_kernel"),
                          ("sweep_ms", "nms_sweep_kernel")):
        us = [t for key, t in by_name.items() if fn_name in key]
        check(len(us) == 1, f"the profile shows {fn_name} once")
        phase_ms[name] = us[0] / 1e3
    call_ms = statistics.median(cuda_ms(kernel, 20))
    direct_ms = statistics.median(cuda_ms(
        lambda: cuda_nms.launch(shifted, valid, iou_thresh), 20))
    plain_ms = statistics.median(cuda_ms(
        lambda: nms_greedy_torch(shifted, valid, iou_thresh), 3))
    bound_ms, bound_by, nbytes, ops = nms_bound_ms(shifted, valid, keep)
    print(f"  [{card}] nms_greedy at ({n}, {k}): kernel {ms * 1e3:.2f} us on "
          f"the device (profiled: build {phase_ms['build_ms'] * 1e3:.2f} us, "
          f"sweep {phase_ms['sweep_ms'] * 1e3:.2f} us a call; "
          f"{call_ms * 1e3:.2f} us a call from Python, {direct_ms * 1e3:.2f} "
          f"us of it without the custom op), bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} B, {ops} f32 ops), "
          f"plain sweep {plain_ms * 1e3:.1f} us, library none", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, **phase_ms}


# ---------------------------------------------------------------------------
# the int8 path
# ---------------------------------------------------------------------------


def requant_cases(device) -> dict:
    """int8_requant inputs: (acc, m, b, r, qmax, leaky, phases) on
    ``device``. Wide sums (past 2^24), small sums and zero rows, per-channel
    scales, biases on the .5 boundaries of y * r and one ulp either side, a
    ragged row count, and a column slice of a wider product (row stride
    above the width, as a padded ``_int_mm`` leaves it)."""
    rng = np.random.RandomState(SEED + 9)
    cases = {}
    for label, rows, c, phases, leaky, qmax in (
            ("C32", 4096, 32, 1, True, 127),
            ("C64 linear", 4096, 64, 1, False, 127),
            ("C1024", 1000, 1024, 1, True, 127),
            ("C32 ragged M", 123457, 32, 1, True, 127),
            ("stem phases C32", 4099, 32, 4, True, 127),
            ("C64 5-bit", 777, 64, 1, True, 15)):
        cols = phases * c
        acc = np.concatenate([
            rng.randint(-2 ** 27, 2 ** 27, (rows // 2, cols)),
            rng.randint(-3000, 3000, (rows - rows // 2 - 5, cols)),
            np.zeros((5, cols), np.int64)]).astype(np.int32)
        scale = np.float32(rng.uniform(0.01, 0.1))
        r = np.float32(1) / scale
        w_scale = (rng.uniform(0.5, 2, cols) * 1e-3).astype(np.float32)
        m = np.float32(rng.uniform(0.005, 0.02)) * w_scale
        b = rng.normal(0, 1, cols).astype(np.float32)
        k = rng.randint(-qmax, qmax, cols).astype(np.float32)
        edge = ((k + np.float32(0.5)) / r).astype(np.float32)
        pick = rng.randint(0, 3, cols)  # on the edge, one ulp up, one down
        b[::2] = np.where(pick == 0, edge, np.where(
            pick == 1, np.nextafter(edge, np.float32(np.inf)),
            np.nextafter(edge, -np.float32(np.inf))))[::2]
        cases[label] = (torch.from_numpy(acc).to(device),
                        torch.from_numpy(m).to(device),
                        torch.from_numpy(b).to(device), float(r), qmax,
                        leaky, phases)
    acc, m, b, r, qmax, leaky, phases = cases["C32"]
    wide = torch.zeros((acc.shape[0], 40), dtype=torch.int32, device=device)
    wide[:, :32] = acc
    cases["C32 column slice of a 40-wide product"] = (
        wide[:, :32], m, b, r, qmax, leaky, phases)
    return cases


def compare_requant(device) -> int:
    """The requant kernel against its plain version on the card: the codes
    must be equal. Returns the largest code difference (0)."""
    worst = 0
    for label, (acc, m, b, r, qmax, leaky, phases) in requant_cases(
            device).items():
        got = int8_requant_cuda(acc, m, b, r, qmax, leaky, phases)
        want = int8_requant_torch(acc, m, b, r, qmax, leaky, phases)
        torch.cuda.synchronize()
        diff = int((got.int() - want.int()).abs().max())
        worst = max(worst, diff)
        print(f"  int8_requant {label}: acc {tuple(acc.shape)} -> "
              f"{tuple(got.shape)}, qmax {qmax}, leaky {leaky}, codes equal "
              f"{torch.equal(got, want)} ({int((got != want).sum())} differ)",
              flush=True)
        check(torch.equal(got, want), f"int8_requant == plain on {label}")
    acc, m, b, r, qmax, leaky, _ = requant_cases(device)["C32"]
    for bad, why in (
        (lambda: int8_requant_cuda(acc.long(), m, b, r, qmax, leaky),
         "int64 sums"),
        (lambda: int8_requant_cuda(acc, m[:16], b, r, qmax, leaky),
         "a short scale vector"),
        (lambda: int8_requant_cuda(acc, m, b, r, qmax, leaky, 3), "3 phases"),
        (lambda: int8_requant_cuda(acc.t(), m, b, r, qmax, leaky),
         "column-major sums"),
    ):
        try:
            bad()
        except ValueError:
            continue
        raise RuntimeError(f"chip_smoke: the requant wrapper accepted {why}")
    return worst


def compare_products(device) -> None:
    """The int8 product (im2col + ``_int_mm``) on the card against the
    CPU's exact float64 conv / int64 product: the int32 sums must be
    equal."""
    rng = np.random.RandomState(SEED + 10)
    for label, shape, k, cout, stride in (
            ("3x3 128->256 @52", (2, 52, 52, 128), 3, 256, 1),
            ("1x1 512->256 @26", (2, 26, 26, 512), 1, 256, 1),
            ("conv0 3x3 3->32 @416 (K 27 -> 32)", (2, 416, 416, 3), 3, 32, 1),
            ("int8 stem 3x3 12->128 @208 (K 108 -> 112)", (2, 208, 208, 12),
             3, 128, 1),
            ("v1 7x7/s2 3->64 @448 (pad (3, 2))", (1, 448, 448, 3), 7, 64, 2)):
        x = torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (k, k, shape[3], cout))
                             .astype(np.int8))
        pad_h = _darknet_padding(shape[1], k, stride)
        pad_w = _darknet_padding(shape[2], k, stride)
        acc, (n, ho, wo) = int8_conv(x.to(device), w.to(device), stride,
                                     pad_h, pad_w)
        got = acc.reshape(n, ho, wo, cout).cpu()
        want = int8_conv_exact(x, w, stride, pad_h, pad_w)
        print(f"  int8 product {label}: sums {tuple(got.shape)} equal "
              f"{torch.equal(got, want)}", flush=True)
        check(torch.equal(got, want), f"int8 product == exact on {label}")
    for label, fin, fout in (("v1 dense b1 50176->256", 50176, 256),
                             ("v1 dense b1 256->4096", 256, 4096)):
        x = torch.from_numpy(rng.randint(-127, 128, (1, fin)).astype(np.int8))
        w = torch.from_numpy(rng.randint(-127, 128, (fin, fout))
                             .astype(np.int8))
        got = int8_matmul(x.to(device), gemm_operand(w.to(device)), fout).cpu()
        want = (x.long() @ w.long()).int()
        print(f"  int8 product {label}: sums {tuple(got.shape)} equal "
              f"{torch.equal(got, want)}", flush=True)
        check(torch.equal(got, want), f"int8 product == exact on {label}")


def random_folded(model, dim: int, seed: int):
    """A BN-folded network for ``model`` from ``seed`` with random BN
    statistics, on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    net = model.init(gen, dim)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1, generator=gen)
                layer.var.uniform_(0.5, 1.5, generator=gen)
                layer.scale.uniform_(0.5, 1.5, generator=gen)
                layer.bias.normal_(0.0, 0.1, generator=gen)
    return fold_bn(model, net)


def check_int8_card_vs_cpu(device) -> None:
    """Small models quantized on the CPU and moved to the card: every
    layer's int8 codes equal, the bf16 head within INT8_HEAD_RTOL of its
    max, unfused and with the fused int8 stem."""
    for label, name, inference, dim in (
            ("darknet19 v2 @64", "yolo2", "darknet", 64),
            ("tiny v2 @32", "yolo2", "tiny", 32)):
        model, net = random_folded(get_model(name, inference, 20), dim,
                                   SEED + 11)
        gen = torch.Generator().manual_seed(SEED + 12)
        calib = torch.rand((4, dim, dim, 3), generator=gen)
        x = torch.rand((3, dim, dim, 3), generator=gen)
        qm = ptq.quantize_model(model, net, calib)
        for stem in (False, True):
            q = ptq.fuse_stem_int8(qm) if stem else qm
            cpu_codes, dev_codes = [], []
            ref = ptq.apply_int8(q, x, codes=cpu_codes)
            got = ptq.apply_int8(q.to(device), x.to(device),
                                 codes=dev_codes).cpu()
            equal = [torch.equal(a, b.cpu()) for a, b in zip(cpu_codes,
                                                             dev_codes)]
            err = float((got - ref).abs().max() / ref.abs().max())
            print(f"  int8 {label}{' fused stem' if stem else ''}, card vs "
                  f"CPU: {sum(equal)} of {len(cpu_codes)} code tensors equal; "
                  f"head max err {err:.2e} of max|ref| (limit "
                  f"{INT8_HEAD_RTOL:g})", flush=True)
            check(len(dev_codes) == len(cpu_codes) and all(equal),
                  f"int8 codes on the card == CPU ({label})")
            check(err <= INT8_HEAD_RTOL, f"int8 head on the card ({label})")


def int8_programs(npz: str, canvases) -> dict:
    """The b128 int8 serving program, calibrated on the batch's first
    eight canvases, with ``detect.fuse_stem`` off and xla:
    {"int8-off"/"int8-xla": (infer_fn, qm-bearing net)}."""
    progs = {}
    for fuse in ("off", "xla"):
        cfg = load_config(["config.ini"], ["detect.threshold=0.005",
                                           "detect.use_int8=1",
                                           f"detect.fuse_stem={fuse}"])
        _, _, infer_fn, net, _ = build_serving(cfg, npz, canvases[:8])
        progs[f"int8-{fuse}"] = (infer_fn, net)
    return progs


def count_launches(fn) -> dict:
    """Every kernel's launches over ``fn()``: counts set to 0 just before,
    read just after."""
    torch.cuda.synchronize()
    for kern in (nms_greedy_cuda, stem_fused_cuda, int8_requant_cuda):
        kern.launches = 0
    fn()
    torch.cuda.synchronize()
    return {"nms_greedy": nms_greedy_cuda.launches,
            "stem_fused": stem_fused_cuda.launches,
            "int8_requant": int8_requant_cuda.launches}


def check_requant_launches(infer_fn, net, canvases, label: str) -> tuple:
    """One call of the serving program in which every requant launch is
    also run through the plain version, on the same sums, scales and bias,
    in chunks of rows (so its float64 temporaries fit): the codes must be
    equal. Returns ((rows, channels, phases) of each launch, the plain
    version's device milliseconds summed over the launches)."""
    shapes, plain = [], [0.0]

    def checked(acc, m, b, r, qmax, leaky, phases=1):
        got = int8_requant_cuda(acc, m, b, r, qmax, leaky, phases)
        rows, cols = acc.shape
        step = max(PLAIN_CHUNK // cols, 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = [int8_requant_torch(acc[s:s + step], m, b, r, qmax, leaky,
                                   phases) for s in range(0, rows, step)]
        end.record()
        end.synchronize()
        plain[0] += start.elapsed_time(end)
        equal = all(torch.equal(got[s:s + step], w)
                    for s, w in zip(range(0, rows, step), want))
        shapes.append((rows, cols // phases, phases))
        check(equal, f"int8_requant == plain at launch {len(shapes)} of "
                     f"{label}: acc {tuple(acc.shape)}, {phases} phases")
        return got

    with mock.patch.object(ptq, "int8_requant_cuda", checked):
        infer_fn(net, canvases)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  {label}: {len(shapes)} int8_requant launches held against the "
          f"plain version on their own sums, codes equal in all; (rows, C, "
          f"phases) {shapes}", flush=True)
    return shapes, plain[0]


def time_int8_requant(progs: dict, canvases, card: str) -> dict:
    """The requant kernel at the b128 batch's shapes: its device time a
    batch (the profiler's sum over its launches in the ``fuse_stem=off``
    serving program), its bound (bytes: each launch's int32 sums read once,
    its codes written once, its m and b read once, over HBM bandwidth), and
    its plain version's time on the same sums. Every launch of both int8
    programs (off and xla, whose stem launch takes the four-phase mode) is
    held against the plain version on its own inputs."""
    infer_fn, net = progs["int8-off"]
    by_name = kernel_device_us(lambda: infer_fn(net, canvases), 3)
    rows = [(key, us) for key, us in by_name.items()
            if "int8_requant_kernel" in key]
    check(bool(rows), "the profile shows int8_requant_kernel")
    ms = sum(us for _, us in rows) / 1e3
    tag = f"b{canvases.shape[0]}@{canvases.shape[1]}"
    shapes, plain = check_requant_launches(infer_fn, net, canvases,
                                           f"{tag} int8-off")
    stem_shapes, _ = check_requant_launches(*progs["int8-xla"], canvases,
                                            f"{tag} int8-xla")
    check(stem_shapes[0][2] == 4, "the int8-xla program's stem launch")
    nbytes = sum(r * p * c * 4 + r * c + 2 * p * c * 4 for r, c, p in shapes)
    ops = sum(r * p * c * REQUANT_OPS for r, c, p in shapes)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"  [{card}] int8_requant at {tag}: {len(shapes)} launches a "
          f"batch, kernel {ms:.3f} ms on the device a batch, bound "
          f"{bound_ms:.3f} ms ({bound_by}: {nbytes} B, {ops} f32 ops), plain "
          f"version {plain:.3f} ms on the same sums, library none",
          flush=True)
    for key, us in rows:
        print(f"    {us / 1e3:8.3f} ms  {key[:90]}", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by}


def write_ppms(images: list, root: str) -> list:
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, img in enumerate(images):
        paths.append(os.path.join(root, f"int8_{i}.ppm"))
        write_ppm(paths[-1], img)
    return paths


def drive_int8_cli(npz: str, tmp: str, ev: dict, device,
                   overrides=()) -> dict:
    """The int8 path as a user drives it: ``cli.detect --image`` on the
    four images, ``cli.detect --stdin`` with ``detect.calib_images=2`` on
    three paths and an unreadable one, and ``cli.eval`` on the eval set,
    each with ``detect.use_int8=1``. Counts each run's kernel launches and
    returns them with the eval argv."""
    paths = write_ppms(synthetic_images(np.random.RandomState(SEED)),
                       os.path.join(tmp, "int8_images"))
    int8 = ["detect.use_int8=1", "detect.threshold=0.005", *overrides]
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    launches = {}
    argv = ["-c", "config.ini", "--weights", npz, *cpu, *int8]
    for p in paths:
        argv += ["--image", p]
    printed = {}

    def detect_images():
        printed["detect"] = run_cli(detect_cli, argv)[1]

    launches["int8_detect"] = count_launches(detect_images)
    lines = printed["detect"].splitlines()
    print(f"phase int8 path: cli.detect --image x{len(paths)} "
          f"detect.use_int8=1: {len(lines)} detections; launches "
          f"{launches['int8_detect']}", flush=True)
    check(len(lines) > 0 and all(line.split(":")[0] in
                                 {os.path.basename(p) for p in paths}
                                 for line in lines), "int8 detect lines")

    stream = [paths[0], os.path.join(tmp, "missing.ppm"), paths[1], paths[2]]
    saved = sys.stdin

    def detect_stream():
        sys.stdin = io.StringIO("\n".join(stream) + "\n")
        try:
            printed["stdin"] = run_cli(detect_cli, [
                "-c", "config.ini", "--weights", npz, "--stdin", *cpu, *int8,
                "detect.calib_images=2"])[1]
        finally:
            sys.stdin = saved

    with log_lines("detect") as warned:
        launches["int8_stdin"] = count_launches(detect_stream)
    blocks = printed["stdin"].split("\n\n")[:-1]
    order = [b.splitlines()[0].split(":")[0] if b else "" for b in blocks]
    print(f"  cli.detect --stdin detect.use_int8=1 detect.calib_images=2: "
          f"blocks in order {order}; launches {launches['int8_stdin']}",
          flush=True)
    check(order == [os.path.basename(p) for p in stream],
          "--stdin answers in input order")
    check(blocks[1] == "missing.ppm: ERROR unreadable", "the error block")
    check(any("buffers the first 2 frames" in w for w in warned),
          "the buffering warning")

    eval_argv_int8 = eval_argv(npz, ev["cache_dir"], device,
                               ["detect.use_int8=1", *overrides])
    result = {}

    def run_eval():
        result["metrics"] = run_cli(eval_cli, eval_argv_int8)[0]

    t0 = time.perf_counter()
    launches["int8_eval"] = count_launches(run_eval)
    seconds = time.perf_counter() - t0
    metrics = result["metrics"]
    print(f"  cli.eval detect.use_int8=1: {metrics['num_images']} images, "
          f"{metrics['num_detections']} detections, mAP {metrics['map']:.4f} "
          f"in {seconds:.2f} s (first run: calibration, plans); launches "
          f"{launches['int8_eval']}", flush=True)
    check(metrics["num_images"] == ev["metrics"]["num_images"] and
          np.isfinite(metrics["map"]), "int8 cli.eval metrics")
    return {"launches": launches, "eval_argv": eval_argv_int8}


def write_overfit_cache(root: str) -> str:
    """The overfit set as PPM images in a COCO layout, cached: returns the
    cache directory."""
    imgs, boxes, classes, valid = overfit_set()
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    images, anns = [], []
    n, dim = imgs.shape[0], imgs.shape[1]
    for i in range(n):
        write_ppm(os.path.join(img_dir, f"{i:06d}.ppm"),
                  np.round(imgs[i] * 255).astype(np.uint8))
        images.append({"id": i + 1, "file_name": f"{i:06d}.ppm",
                       "width": dim, "height": dim})
        for g in np.nonzero(valid[i])[0]:
            cx, cy, w, h = boxes[i, g] * dim
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": int(classes[i, g]) + 1,
                         "bbox": [float(cx - w / 2), float(cy - h / 2),
                                  float(w), float(h)], "iscrowd": 0})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "red"},
                                  {"id": 2, "name": "blue"}]}, f)
    cache_dir = os.path.join(root, "cache")
    build_cache(cache_dir, "test", [{"kind": "coco", "ann_json": ann,
                                     "image_dir": img_dir}],
                names=("red", "blue"))
    return cache_dir


def top_detections(dump: str) -> dict:
    """image id -> (class, score, corner box) of its best detection in an
    ``evaluate_model`` dump."""
    with open(dump) as f:
        dets = json.load(f)["detections"]
    best = {}
    for d in dets:
        if d["image_id"] not in best or d["score"] > best[d["image_id"]][1]:
            x, y, w, h = d["bbox"]
            best[d["image_id"]] = (d["category_id"], d["score"],
                                   np.array([x, y, x + w, y + h]))
    return best


def check_int8_map(model, net, tmp: str, device) -> tuple:
    """The trained overfit model evaluated in f32 and in int8 (calibrated on
    its eight images) on its own set: the int8 mAP@0.5 within INT8_MAP_TOL
    of the f32 one. mAP@0.5 saturates on this set, so COCO's AP@0.75 and
    AP@[.5:.95] and each image's best detection (class, score, IoU between
    the two) are printed beside it."""
    cache = load_cache(write_overfit_cache(os.path.join(tmp, "overfit")),
                       "test")
    kw = dict(input_dim=48, batch_size=8, top_k=64, device=device,
              compute_dtype=torch.float32, coco=True)
    dumps = [os.path.join(tmp, f"overfit_{k}.json") for k in ("f32", "int8")]
    f32 = evaluate_model(model, net, cache, dump_path=dumps[0], **kw)
    int8 = evaluate_model(model, net, cache, int8=True, calib_images=8,
                          dump_path=dumps[1], **kw)
    print(f"  overfit model on its 8 images, f32 / int8: mAP@0.5 "
          f"{f32['map']:.4f} / {int8['map']:.4f} (|delta| "
          f"{abs(int8['map'] - f32['map']):.4f}, limit {INT8_MAP_TOL}); "
          f"AP@0.75 {f32['ap75']:.4f} / {int8['ap75']:.4f}; AP@[.5:.95] "
          f"{f32['coco_map']:.4f} / {int8['coco_map']:.4f}", flush=True)
    top_f32, top_int8 = (top_detections(d) for d in dumps)
    same_class, score_diff, ious = 0, 0.0, []
    for img, (cls, score, box) in top_f32.items():
        cls8, score8, box8 = top_int8.get(img, (None, 0.0, np.zeros(4)))
        same_class += cls == cls8
        score_diff = max(score_diff, abs(score - score8))
        ious.append(float(iou_matrix(torch.from_numpy(box[None]),
                                     torch.from_numpy(box8[None]))))
    print(f"  best detection of each image, int8 vs f32: class equal on "
          f"{same_class} of {len(top_f32)}, max |score delta| "
          f"{score_diff:.4f}, IoU min {min(ious):.4f} mean "
          f"{np.mean(ious):.4f}", flush=True)
    check(abs(int8["map"] - f32["map"]) <= INT8_MAP_TOL,
          "int8 mAP within the limit of the f32 mAP")
    return f32["map"], int8["map"]


# ---------------------------------------------------------------------------
# phase 9: QAT -> export -> serve
# ---------------------------------------------------------------------------


def _qat_batch(n: int, dim: int, seed: int) -> tuple:
    rng = np.random.RandomState(seed)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (n, 8, 2)),
                            rng.uniform(0.05, 0.4, (n, 8, 2))], -1)
    return (torch.from_numpy(rng.uniform(0, 1, (n, dim, dim, 3)).astype(
                np.float32)),
            torch.from_numpy(boxes.astype(np.float32)),
            torch.from_numpy(rng.randint(0, 20, (n, 8)).astype(np.int32)),
            torch.from_numpy(rng.uniform(0, 1, (n, 8)) < 0.6))


def _folded_tiny(seed: int, num_classes: int, dim: int):
    model = get_model("yolo2", "tiny", num_classes)
    gen = torch.Generator().manual_seed(seed)
    net = model.init(gen, dim)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1, generator=gen)
                layer.var.uniform_(0.5, 1.5, generator=gen)
    return fold_bn(model, net)


@contextlib.contextmanager
def _shared_codes(store: list, flips: Optional[list] = None):
    """Inside, ``qat_forward``'s fake quantization of each activation
    records its value in ``store`` (``flips`` None), or takes the value
    recorded there, call for call, keeping its own gradient, and appends
    to ``flips`` how many of its codes differed from it."""
    orig = qat.fake_quant
    recorded = iter(list(store))

    def fake_quant(x, scale, qmax=127.0):
        out = orig(x, scale, qmax)
        if flips is None:
            store.append(out.detach().cpu())
            return out
        ref = next(recorded).to(out.device)
        flips.append(int(((out.detach() - ref).abs() > scale / 2).sum()))
        return out + (ref - out.detach())

    with mock.patch.object(qat, "fake_quant", fake_quant):
        yield


@contextlib.contextmanager
def _tf32():
    """TF32 on for convs and products inside (the control of
    :func:`check_qat_card_vs_cpu`), the settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _qat_state_to(st, dev):
    """A copy of a QAT state on ``dev``."""
    opt = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
               else v) for k, v in st.opt_state.items()}
    return qat.QatState(st.step, copy.deepcopy(st.net).to(dev), opt)


def _qat_steps(model, start: dict, batch, scales, tx, dev, codes: dict,
               flips: Optional[dict] = None) -> dict:
    """One QAT and one distill step on ``dev`` (no augment), each from a
    copy of its state in ``start`` (the distill teacher under "teacher"):
    kind -> (params before, state after, metrics with grads), each forward
    recording its activations in ``codes[kind]`` or, with ``flips``, taking
    them from there."""
    in_scale, act_scales = scales
    b = tuple(t.to(dev) for t in batch)
    teacher = copy.deepcopy(start["teacher"]).to(dev)
    out = {}
    for kind in ("qat", "distill"):
        st = _qat_state_to(start[kind], dev)
        before = {k: v.detach().clone() for k, v in st.params().items()}
        with _shared_codes(codes.setdefault(kind, []),
                           None if flips is None
                           else flips.setdefault(kind, [])):
            if kind == "qat":
                st, m = qat.make_qat_step(model, tx, in_scale, act_scales,
                                          augment=False)(
                    st, b, SEED, 64, with_grads=True)
            else:
                st, m = qat.make_qat_distill_step(
                    model, tx, in_scale, act_scales, augment=False)(
                    st, b, teacher, SEED, 64, with_grads=True)
        out[kind] = (before, st, m)
    return out


def _qat_step_errs(got: tuple, want: tuple) -> tuple:
    """(loss terms' largest relative difference, worst gradient leaf's
    largest difference over its largest |value|, worst parameter leaf's
    change: norm of the difference over the norm of the CPU's change, the
    params' largest difference over their largest |value|)."""
    (b_d, st_d, m_d), (b_c, st_c, m_c) = got, want
    keys = [k for k in m_c if k not in ("grads", "grad_norm")]
    loss = max(abs(float(m_d[k]) - float(m_c[k]))
               / max(abs(float(m_c[k])), 1e-30) for k in keys)
    grads = max(float((m_d["grads"][k].cpu() - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in m_c["grads"].items())
    p_d, p_c = st_d.params(), st_c.params()
    delta = max(float(torch.linalg.vector_norm(
        (p_d[k].detach().cpu() - b_d[k].cpu()) - (p_c[k].detach() - b_c[k])))
        / max(float(torch.linalg.vector_norm(p_c[k].detach() - b_c[k])),
              1e-30) for k in p_c)
    params = _tree_err(p_d, {k: v.detach() for k, v in p_c.items()})
    return loss, grads, delta, params


def check_qat_card_vs_cpu(device) -> dict:
    """One QAT step and one distill step of tiny v2 @ 64 (batch 2, QAT's
    default adam) from the same state (folded, one CPU step in) on
    ``device`` and on the CPU (TF32 off inside the steps), the card's
    activations taken from the CPU's forward: loss terms, gradients and
    each parameter's change. Then the control: the card's steps again with
    TF32 on must fail a limit."""
    model, folded = _folded_tiny(SEED + 9, 20, 64)
    batch = _qat_batch(2, 64, SEED + 9)
    scales = ptq.calibrate(model, folded, batch[0],
                           compute_dtype=torch.float32)
    tx = qat.make_qat_optimizer(qat.QatConfig())
    # each kind from its state after one CPU step on another batch, so
    # adam's moments are not zero (a first adam step moves every weight by
    # lr * sign(gradient), whatever its size)
    start = {"teacher": copy.deepcopy(folded).requires_grad_(False)}
    first = _qat_steps(model, {"teacher": start["teacher"],
                               "qat": qat.init_qat_state(
                                   copy.deepcopy(folded), tx),
                               "distill": qat.init_qat_state(
                                   copy.deepcopy(folded), tx)},
                       _qat_batch(2, 64, SEED + 8), scales, tx,
                       torch.device("cpu"), {})
    start.update({kind: first[kind][1] for kind in ("qat", "distill")})
    codes: dict = {}
    cpu = _qat_steps(model, start, batch, scales, tx, torch.device("cpu"),
                     codes)
    errs, flips = {}, {}
    for what, ctx in (("TF32 off", contextlib.nullcontext()),
                      ("control, TF32 on",
                       mock.patch.object(qat, "full_f32", _tf32))):
        flips[what] = {}
        with ctx:
            card = _qat_steps(model, start, batch, scales, tx, device,
                              codes, flips[what])
        for kind in ("qat", "distill"):
            loss, grads, delta, params = _qat_step_errs(card[kind],
                                                        cpu[kind])
            errs[what, kind] = (loss, grads, delta, params)
            print(f"  {kind} step tiny@64 b2 f32, {device.type} vs CPU "
                  f"({what}): loss {loss:.2e} relative (limit "
                  f"{QAT_LOSS_RTOL:g}), worst gradient leaf {grads:.2e} of "
                  f"its max (limit {QAT_GRAD_RTOL:g}), worst param change "
                  f"{delta:.2e} of its norm (limit {QAT_DELTA_RTOL:g}), "
                  f"params {params:.2e} of max (limit "
                  f"{TRAIN_STATE_RTOL:g}); codes taken from the CPU's that "
                  f"differed, per layer {flips[what][kind]}", flush=True)
    for kind in ("qat", "distill"):
        loss, grads, delta, params = errs["TF32 off", kind]
        check(loss <= QAT_LOSS_RTOL, f"{kind} loss on the card == CPU")
        check(grads <= QAT_GRAD_RTOL and delta <= QAT_DELTA_RTOL
              and params <= TRAIN_STATE_RTOL,
              f"{kind} gradients and params on the card == CPU")
        loss, grads, delta, _ = errs["control, TF32 on", kind]
        check(loss > QAT_LOSS_RTOL or grads > QAT_GRAD_RTOL
              or delta > QAT_DELTA_RTOL,
              f"the {kind} step with TF32 on fails the card-vs-CPU limits")
    return {"flips": flips, **{f"{w}_{k}_{n}": v for (w, k), e in
                               errs.items() for n, v in
                               zip(("loss", "grads", "delta", "params"),
                                   e)}}


def _qat_gate(model, net, x) -> tuple:
    """yolojax's gate on one folded net: distil it toward its own f32
    outputs under fake quantization for 60 adam steps at 1e-4. Returns the
    60 losses and the real int8 program's MSE to the f32 target before (PTQ
    of the original weights) and after (of the tuned ones)."""
    with torch.no_grad(), full_f32():
        target = model.apply(net, x, compute_dtype=torch.float32)
    in_scale, act_scales = ptq.calibrate(model, net, x)

    def int8_err(n):
        qm = ptq.quantize_model(model, n.requires_grad_(False), x)
        with torch.inference_mode():
            err = float(((ptq.apply_int8(qm, x) - target) ** 2).mean())
        n.requires_grad_(True)
        return err

    err_ptq = int8_err(net)
    # the distill step with no augment is the gate's objective: the MSE of
    # the fake-quant head to the frozen f32 forward on the same images
    tx = train_step.make_optimizer(train_step.OptimizerConfig(
        optimizer="adam", learning_rate=1e-4, weight_decay=0.0))
    step = qat.make_qat_distill_step(model, tx, in_scale, act_scales,
                                     augment=False)
    teacher = copy.deepcopy(net).requires_grad_(False)
    st = qat.init_qat_state(copy.deepcopy(net), tx)
    n, dev = x.shape[0], x.device
    batch = (x, torch.zeros((n, 1, 4), device=dev),
             torch.zeros((n, 1), dtype=torch.int32, device=dev),
             torch.zeros((n, 1), dtype=torch.bool, device=dev))
    losses = []
    for _ in range(60):
        st, m = step(st, batch, teacher, SEED, x.shape[1])
        losses.append(float(m["total"]))
    return losses, err_ptq, int8_err(st.net)


def check_qat_beats_ptq(device) -> tuple:
    """yolojax's mechanism gate (tests/unit/test_qat.py) on the card, on
    :data:`GATE_SEEDS` default-initialised, folded tiny v2 @ 32 nets: after
    60 adam steps the fake-quant loss ends below its first value (the
    straight-through estimator descends) and the real int8 program of the
    tuned weights (the requant kernel) tracks the f32 target better than
    PTQ of the original weights. yolojax asserts both on one net; on the
    CPU either ratio lands above 1 on some nets, in yolojax's own gate and
    the port's alike (the first adam steps throw the loss up ~1000x from
    the quantization floor it starts at, and 60 steps bring it back to
    about that floor), so the gate holds the geometric mean of each ratio
    over the nets below 1 and prints every net's."""
    x = torch.from_numpy(np.random.RandomState(7).uniform(
        0, 1, (4, 32, 32, 3)).astype(np.float32)).to(device)
    ratios = []
    for k in range(GATE_SEEDS):
        model = get_model("yolo2", "tiny", 2)
        model, net = fold_bn(model, model.init(
            torch.Generator().manual_seed(SEED + 10 + k), 32))
        losses, err_ptq, err_qat = _qat_gate(model, net.to(device), x)
        ratios.append((losses[-1] / losses[0], err_qat / err_ptq))
        print(f"  QAT vs PTQ on the card (tiny v2 @ 32, net {k}, 60 adam "
              f"steps): fake-quant loss first {losses[0]:.3e}, max "
              f"{max(losses):.3e}, last {losses[-1]:.3e}; int8 MSE to the "
              f"f32 target: PTQ {err_ptq:.3e}, QAT {err_qat:.3e}",
              flush=True)
    loss_ratio, err_ratio = (float(np.exp(np.mean(np.log(r))))
                             for r in zip(*ratios))
    print(f"  QAT vs PTQ over {GATE_SEEDS} nets: geometric mean of last / "
          f"first loss {loss_ratio:.4f}, of QAT / PTQ int8 MSE "
          f"{err_ratio:.4f} (each must be < 1)", flush=True)
    check(loss_ratio < 1, "the straight-through estimator descends")
    check(err_ratio < 1, "QAT beats PTQ on the quantized objective")
    return loss_ratio, err_ratio


def drive_qat_cli(npz: str, tr: dict, ev: dict, tmp: str, device,
                  overrides=()) -> dict:
    """``cli.qat`` on config.ini (Darknet-19 @ 416, batch 64 of 448
    canvases) from the seeded weights over the train cache: three steps,
    then two with ``--distill``; then ``cli.eval detect.use_int8=1`` on
    each output, the first run's launches counted (path ``qat_eval``)."""
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    outs, launches, metrics = [], None, []
    for steps, extra in ((QAT_STEPS, []), (DISTILL_STEPS, ["--distill"])):
        out = os.path.join(tmp, f"qat{'_distill' if extra else ''}.npz")
        argv = ["-c", "config.ini", "--weights", npz, "--output", out,
                "--steps", str(steps), *extra, *cpu,
                f"cache.basedir={tr['cache_dir']}", "train.summary_steps=1",
                *overrides]
        t0 = time.perf_counter()
        with log_lines("qat") as lines:
            run_cli(qat_cli, argv)
        seconds = time.perf_counter() - t0
        losses = [float(m.split("loss ")[1]) for m in lines
                  if m.startswith("qat step")]
        print(f"phase qat path: cli.qat {' '.join(extra) or '(detection '
              f'loss)'} {steps} steps in {seconds:.2f} s: losses "
              f"{[round(v, 4) for v in losses]}; {lines[-1]}", flush=True)
        check(len(losses) == steps and all(np.isfinite(losses)),
              "cli.qat logged every step with a finite loss")
        outs.append(out)
    for i, out in enumerate(outs):
        argv = eval_argv(out, ev["cache_dir"], device,
                         ["detect.use_int8=1", *overrides])
        result = {}
        got = count_launches(lambda: result.update(
            metrics=run_cli(eval_cli, argv)[0]))
        metrics.append(result["metrics"])
        launches = launches or got
        print(f"  cli.eval detect.use_int8=1 --weights {os.path.basename(out)}"
              f": mAP {result['metrics']['map']:.4f} over "
              f"{result['metrics']['num_images']} images, launches {got}",
              flush=True)
        check(result["metrics"]["num_images"] == EVAL_IMAGES
              and np.isfinite(result["metrics"]["map"]), "QAT npz evaluates")
    return {"outputs": outs, "launches": launches, "metrics": metrics}


def drive_export(npz: str, qat_npz: str, ppms: list, tmp: str, device,
                 overrides=()) -> dict:
    """``cli.export`` of three artifacts at the eval floor: bf16 with the
    fused stem (batch 8), int8 from the QAT ``.npz`` calibrated on eight of
    the PPM images (batch 8), bf16 (batch 1). Returns {name: (path, the
    overrides, weights, seconds)}."""
    calib = [a for p in ppms[:ART_BATCH] for a in ("--calib-image", p)]
    batch = ["--batch", str(ART_BATCH)]
    specs = {  # weights, flags, settings
        "bf16_fused_b8": (npz, batch, ["detect.fuse_stem=pallas"]),
        "int8_b8": (qat_npz, batch + calib, ["detect.use_int8=1"]),
        "bf16_b1": (npz, [], []),
    }
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    arts = {}
    for name, (weights, flags, settings) in specs.items():
        path = os.path.join(tmp, f"{name}.yjts")
        t0 = time.perf_counter()
        _, printed = run_cli(export_cli, [
            "-c", "config.ini", "--weights", weights, "--out", path, *flags,
            *cpu, "detect.threshold=0.005", *settings, *overrides])
        seconds = time.perf_counter() - t0
        print(f"phase export: {name}: {printed.strip()} in {seconds:.2f} s",
              flush=True)
        arts[name] = (path, settings, weights, seconds)
    return arts


def check_artifacts(arts: dict, ppms: list, canvases, card: str,
                    overrides=()) -> dict:
    """Each artifact against the live ``build_serving`` program of its
    settings on the same canvases: keep masks equal, boxes equal (int8) or
    within the fused-head limit (bf16), and its kernels launched inside the
    exported graph; the batch-8 artifacts timed against their live
    programs (CUDA events, median of 5, in turns)."""
    device = canvases.device
    dim = canvases.shape[1]
    calib = [augment.letterbox_host(decode_image(p), dim)[0]
             for p in ppms[:ART_BATCH]]
    launches, times = {}, {}
    for name, (path, settings, weights, _) in arts.items():
        art = load_artifact(path, device=device)
        batch = art.meta["batch"]
        x = canvases[:batch].contiguous()
        cfg = load_config(["config.ini"], ["detect.threshold=0.005",
                                           *settings, *overrides])
        _, _, infer_fn, net, _ = build_serving(
            cfg, weights, calib if cfg.detect.use_int8 else None,
            device=device)
        got = {}
        launches[name] = count_launches(lambda: got.update(art(x)))
        want = infer_fn(net, x)
        keep_equal = torch.equal(got["keep"], want["keep"])
        box_err = float((got["boxes"] - want["boxes"]).abs().max()
                        / want["boxes"].abs().max())
        print(f"  artifact {name} (b{batch}, platforms "
              f"{art.meta['platforms']}, {art.meta['payload_bytes'] / 1e6:.1f}"
              f" MB) vs the live program: keep equal {keep_equal} "
              f"({int(got['keep'].sum())} kept), boxes max err "
              f"{box_err:.2e} of max; launches {launches[name]}", flush=True)
        check(keep_equal, f"{name}: keep == live keep")
        if cfg.detect.use_int8:
            check(torch.equal(got["boxes"], want["boxes"]),
                  f"{name}: boxes == live boxes")
        else:
            check(box_err <= STEM_HEAD_RTOL, f"{name}: boxes near live")
        if batch == ART_BATCH and device.type == "cuda":
            runs = {"live": [], "artifact": []}
            for key in ("live", "artifact", "artifact", "live"):
                fn = (lambda: infer_fn(net, x)) if key == "live" else (
                    lambda: art(x))
                runs[key] += cuda_ms(fn, 5)
            times[name] = {k: statistics.median(v) for k, v in runs.items()}
            print(f"  [{card}] {name} b{batch}@{dim}: artifact "
                  f"{times[name]['artifact']:.3f} ms, live program "
                  f"{times[name]['live']:.3f} ms (median of 10 each, in "
                  f"turns)", flush=True)
        del art, net, infer_fn
        torch.cuda.empty_cache()
    return {"launches": launches, "times": times}


def drive_serve(arts: dict, ppms: list, device, card: str,
                overrides=()) -> dict:
    """``cli.serve --artifact`` (the int8 batch-8 artifact) in this process
    on 127.0.0.1, port 0: 32 image files POSTed from 8 threads; each answer
    equal to ``cli.detect --artifact`` on that image (the same detections
    per image; scores and boxes within the JSON's rounding of the direct
    artifact path); ``/stats`` 32 images and 0 errors. Returns the
    daemon's launches and its rate, latency and fill."""
    import threading
    import urllib.request

    path = arts["int8_b8"][0]
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    httpd, batcher = build_server(load_config(["config.ini"], overrides),
                                  "127.0.0.1", 0, artifact=path,
                                  window_ms=5.0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    files = ppms[:SERVE_REQUESTS]
    blobs = []
    for p in files:
        with open(p, "rb") as f:
            blobs.append(f.read())
    answers, lat = [None] * len(files), [0.0] * len(files)

    def post(i):
        t0 = time.perf_counter()
        req = urllib.request.Request(base + "/detect", data=blobs[i],
                                     method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            answers[i] = (r.status, json.loads(r.read().decode()))
        lat[i] = (time.perf_counter() - t0) * 1e3

    def burst():
        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            list(pool.map(post, range(len(files))))

    try:
        t0 = time.perf_counter()
        launches = count_launches(burst)
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read().decode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(30)
    check(all(a is not None and a[0] == 200 for a in answers),
          "every request answered 200")
    print(f"phase serve: cli.serve --artifact int8_b8: {len(files)} requests "
          f"from {SERVE_CLIENTS} threads, stats {stats}; launches "
          f"{launches}", flush=True)
    check(stats["images"] == len(files) and stats["errors"] == 0,
          "/stats: every image, no error")
    # the same images through cli.detect --artifact, and its direct path
    argv = ["-c", "config.ini", "--artifact", path, *overrides, *cpu]
    for p in files:
        argv += ["--image", p]
    _, printed = run_cli(detect_cli, argv)
    per_image = {}
    for line in printed.splitlines():
        label, rest = line.split(": ", 1)
        per_image.setdefault(label, []).append(rest.split()[0])
    (names, dim, infer, batch), _ = load_artifact_detector(path, device)
    filler = np.full((dim, dim, 3), 0.5, np.float32)

    def direct(p):
        raw = decode_image(p)
        canvas, tf = augment.letterbox_host(raw, dim)
        out = infer(np.stack([canvas.numpy()] + [filler] * (batch - 1)))
        return detect_cli._extract(out, 0, tf, raw.shape, names)

    for p, (_, body) in zip(files, answers):
        got = body["detections"]
        label = os.path.basename(p)
        want = direct(p)
        if [d["name"] for d in got] != per_image.get(label, []):
            first = next((i for i, (g, w) in enumerate(zip(got, want))
                          if g["name"] != w[0]), min(len(got), len(want)))
            print(f"  {label}: the daemon answered {len(got)} detections "
                  f"(batch_fill {body['batch_fill']}), cli.detect printed "
                  f"{len(per_image.get(label, []))}, the direct path "
                  f"{len(want)}; from position {first}, daemon "
                  f"{[(d['name'], d['score']) for d in got[first:first + 4]]}"
                  f", direct "
                  f"{[(n, round(s, 5)) for n, _, s, _ in want[first:first + 4]]}",
                  flush=True)
        check([d["name"] for d in got] == per_image.get(label, []),
              f"daemon == cli.detect --artifact on {label}")
        check(len(got) == len(want) and all(
            g["class"] == cls and abs(g["score"] - score) <= 1e-4
            and max(abs(a - b) for a, b in zip(g["box"], box)) <= 0.02
            for g, (_, cls, score, box) in zip(got, want)),
            f"daemon == the direct artifact path on {label}")
    rps = len(files) / wall
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    print(f"  [{card}] daemon int8_b8 artifact: {rps:.1f} requests/s over "
          f"{len(files)} requests ({wall * 1e3:.1f} ms wall), latency p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms, mean_fill "
          f"{stats['mean_fill']:.2f} of {batch}; every answer equal to "
          f"cli.detect --artifact", flush=True)
    return {"launches": launches, "batches": stats["batches"], "rps": rps,
            "p50_ms": p50, "p99_ms": p99, "mean_fill": stats["mean_fill"]}


def drive_artifact_clis(arts: dict, ev: dict, ppms: list, device,
                        overrides=()) -> dict:
    """``cli.detect --artifact --stdin`` (the batch-1 artifact) on three
    paths and ``cli.eval --artifact`` (the int8 batch-8 artifact) on the 64
    images, each run's launches counted."""
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    printed = {}
    saved = sys.stdin

    def stream():
        sys.stdin = io.StringIO("\n".join(ppms[:3]) + "\n")
        try:
            printed["stdin"] = run_cli(detect_cli, [
                "-c", "config.ini", "--artifact", arts["bf16_b1"][0],
                "--stdin", *overrides, *cpu])[1]
        finally:
            sys.stdin = saved

    launches = {"artifact_stdin": count_launches(stream)}
    blocks = printed["stdin"].split("\n\n")[:-1]
    print(f"phase artifact CLIs: cli.detect --artifact bf16_b1 --stdin: "
          f"{len(blocks)} blocks, launches {launches['artifact_stdin']}",
          flush=True)
    check(len(blocks) == 3, "--stdin answered each path")
    result = {}
    argv = ["-c", "config.ini", "--artifact", arts["int8_b8"][0],
            f"cache.basedir={ev['cache_dir']}", *overrides, *cpu]
    launches["artifact_int8"] = count_launches(
        lambda: result.update(metrics=run_cli(eval_cli, argv)[0]))
    m = result["metrics"]
    print(f"  cli.eval --artifact int8_b8: mAP {m['map']:.4f} over "
          f"{m['num_images']} images, {m['num_detections']} detections; "
          f"launches {launches['artifact_int8']}", flush=True)
    check(m["num_images"] == EVAL_IMAGES and np.isfinite(m["map"]),
          "cli.eval --artifact metrics")
    return launches


def time_qat_steps(cfg, npz: str, device, card: str) -> dict:
    """The QAT and distill steps of ``cli.qat`` at config.ini's shape (a
    batch of 64 canvases of 448, augmented to 416; f32, TF32 off) on a
    device-resident batch: CUDA events, median of 5 after 2 warm-ups, and
    each step's peak device memory; then one step's profile."""
    model = cfg.build_model()
    fm, folded = fold_bn(model, load_network_npz(npz, model))
    folded = folded.to(device)
    batch = train_batch(cfg, device)
    in_scale, act_scales = ptq.calibrate(
        fm, folded, augment.resize(batch[0][:16], cfg.model.dim))
    tx = qat.make_qat_optimizer(qat.QatConfig())
    teacher = copy.deepcopy(folded).requires_grad_(False)
    out = {}
    for kind in ("qat", "distill"):
        state = {"st": qat.init_qat_state(copy.deepcopy(folded), tx)}
        if kind == "qat":
            fn = qat.make_qat_step(fm, tx, in_scale, act_scales,
                                   loss_cfg=cfg.loss_config(),
                                   aug_cfg=cfg.augment)

            def one():
                state["st"], m = fn(state["st"], batch, SEED, cfg.model.dim)
                return m
        else:
            fn = qat.make_qat_distill_step(fm, tx, in_scale, act_scales,
                                           aug_cfg=cfg.augment)

            def one():
                state["st"], m = fn(state["st"], batch, teacher, SEED,
                                    cfg.model.dim)
                return m

        one()
        times = cuda_ms(one, 5)  # after its own warm-up step: 2 in all
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m = one()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(bool(torch.isfinite(m["total"])), f"finite timed {kind} loss")
        ms = statistics.median(times)
        n = batch[0].shape[0]
        print(f"  [{card}] {kind} step b{n}@{cfg.model.dim} f32 (canvas "
              f"{batch[0].shape[1]}, augment + fake-quant forward + loss + "
              f"backward + adam), device-resident: {ms:.3f} ms/step "
              f"(median of 5: {', '.join(f'{t:.3f}' for t in times)}), "
              f"{n / ms * 1e3:.1f} img/s, peak device memory {peak:.2f} GiB",
              flush=True)
        out[kind] = {"ms": ms, "peak_gib": peak}
        if kind == "qat":
            profile_batch(one, card + ", qat step")
        del state
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 10: converters and tools
# ---------------------------------------------------------------------------


def repo_cfg_text(name: str) -> str:
    """A Darknet cfg kept as the string ``name`` in
    tests/parity/test_cfg.py, read with ``ast`` (that module imports jax)."""
    import ast

    with open(os.path.join(ROOT, "tests", "parity", "test_cfg.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise RuntimeError(f"chip_smoke: no {name} in tests/parity/test_cfg.py")


def check_cfg_specs(tmp: str) -> str:
    """``model_from_cfg`` on Darknet's yolo-voc.cfg gives the registry's
    Darknet-19 specs, routes as absolute indices. Returns the cfg path."""
    path = os.path.join(tmp, "yolo-voc.cfg")
    with open(path, "w") as f:
        f.write(repo_cfg_text("YOLO_VOC_CFG"))
    got = model_from_cfg(path)
    ref = get_model("yolo2", "darknet", 20)
    absolute = tuple(
        RouteSpec(tuple(r if r >= 0 else i + r for r in s.layers))
        if isinstance(s, RouteSpec) else s for i, s in enumerate(ref.specs))
    print(f"phase converters and tools: yolo-voc.cfg -> {len(got.specs)} "
          f"specs, {got.num_anchors} anchors, downsample {got.downsample}; "
          f"equal to yolo2.darknet: {got.specs == absolute}", flush=True)
    check(got.specs == absolute and got.anchors == ref.anchors
          and got.downsample == ref.downsample and got.num_classes == 20,
          "yolo-voc.cfg parses to the registry's Darknet-19")
    return path


def check_adam_card_vs_cpu(device) -> None:
    """Adam (no clip) on the card and on the CPU, from the same grads for
    20 updates: the updates bit for bit (f32 bias corrections divided as
    device tensors, correctly rounded square roots); the CPU's are
    optax's bit for bit (tests/test_torch_qat.py)."""
    tx = train_step.make_optimizer(train_step.OptimizerConfig(
        optimizer="adam", learning_rate=1e-3, weight_decay=0.0))
    gen = torch.Generator().manual_seed(SEED + 11)
    p = {"w": torch.randn(4096, generator=gen)}
    states = {"cpu": tx.init(p), "card": tx.init({"w": p["w"].to(device)})}
    unequal = 0
    for step in range(20):
        g = torch.randn(4096, generator=gen) * (0.01 if step % 2 else 3.0)
        u_cpu, states["cpu"] = tx.update({"w": g}, states["cpu"], p)
        u_dev, states["card"] = tx.update({"w": g.to(device)},
                                          states["card"],
                                          {"w": p["w"].to(device)})
        unequal += int((u_dev["w"].cpu() != u_cpu["w"]).sum())
    print(f"  adam on {device.type} vs CPU, 20 updates of 4096 values: "
          f"{unequal} not bit-equal", flush=True)
    check(unequal == 0, "adam's updates on the card == CPU bit for bit")


def dispatch(argv: list) -> str:
    """``python -m yolojax_torch argv...`` in this process; returns what
    it printed."""
    saved = sys.argv
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            check(dispatcher.main(argv) == 0, f"python -m yolojax_torch "
                                               f"{argv[0]} exits 0")
    finally:
        sys.argv = saved
    return out.getvalue()


def drive_converters(cfg, npz: str, cfg_path: str, tmp: str,
                     card: str) -> str:
    """The seeded weights written as Darknet ``.weights`` by the port's
    ``save_darknet_weights``, then ``python -m yolojax_torch parse-darknet
    --cfg yolo-voc.cfg`` back to an ``.npz`` whose every array must equal
    the seeded ``.npz``'s. Returns the ``.weights`` path."""
    model = cfg.build_model()
    weights = os.path.join(tmp, "darknet19_seed0.weights")
    t0 = time.perf_counter()
    save_darknet_weights(model, load_network_npz(npz, model), weights)
    write_s = time.perf_counter() - t0
    out = os.path.join(tmp, "parsed.npz")
    t0 = time.perf_counter()
    printed = dispatch(["parse-darknet", "-c", "config.ini", "--cfg",
                        cfg_path, weights, "-o", out])
    parse_s = time.perf_counter() - t0
    with np.load(out) as got, np.load(npz) as want:
        same = (sorted(got.files) == sorted(want.files) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
            for k in want.files))
        n_arrays = len(want.files)
    print(f"  [{card}] save_darknet_weights: "
          f"{os.path.getsize(weights) / 1e6:.1f} MB in {write_s:.2f} s; "
          f"python -m yolojax_torch parse-darknet --cfg yolo-voc.cfg: "
          f"{parse_s:.2f} s: {printed.strip()}", flush=True)
    print(f"  parsed .npz vs the seeded .npz: {n_arrays} arrays, all "
          f"bit-equal: {same}", flush=True)
    check(same, "parse-darknet's .npz == the seeded .npz, array by array")
    return weights


def drive_weights_detect(npz: str, weights: str, tmp: str, device,
                         overrides=()) -> dict:
    """``cli.detect --weights x.weights detect.fuse_stem=pallas`` on the
    four images prints what ``--weights seeded.npz`` prints; counts the
    ``.weights`` run's launches."""
    paths = write_ppms(synthetic_images(np.random.RandomState(SEED)),
                       os.path.join(tmp, "weights_images"))
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    printed, launches = {}, {}
    for name, w in (("npz", npz), ("weights", weights)):
        argv = ["-c", "config.ini", "--weights", w, *cpu]
        for p in paths:
            argv += ["--image", p]
        argv += ["detect.threshold=0.005", "detect.fuse_stem=pallas",
                 *overrides]

        def run(argv=argv, name=name):
            printed[name] = run_cli(detect_cli, argv)[1]

        launches[name] = count_launches(run)
    lines = printed["weights"].splitlines()
    print(f"  cli.detect --weights x.weights detect.fuse_stem=pallas: "
          f"{len(lines)} detections on {len(paths)} images, equal to "
          f"--weights seeded.npz: {printed['weights'] == printed['npz']}; "
          f"launches {launches['weights']}", flush=True)
    check(len(lines) > 0 and printed["weights"] == printed["npz"],
          "cli.detect on the .weights file == on the .npz")
    return launches["weights"]


def camera_frames() -> list:
    """Seeded RGB frames of two camera sizes."""
    rng = np.random.RandomState(SEED + 9)
    frames = []
    for i in range(CAMERA_FRAMES):
        h, w = (480, 640) if i % 2 == 0 else (360, 480)
        yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
        phase = rng.uniform(0, 3)
        base = np.stack([np.sin(5 * xx + c + phase) * np.cos(3 * yy - c)
                         for c in (0.0, 1.0, 2.0)], -1)
        img = 127.5 * (1 + base) + rng.normal(0, 12, (h, w, 3))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def drive_camera(npz: str, tmp: str, device, int8: bool,
                 overrides=()) -> dict:
    """``cli.detect_camera``'s loop over the seeded frames (int8:
    ``detect.calib_images=2``, buffered as the camera buffers them); each
    frame's detections must equal ``cli.detect --stdin`` on the same
    frames as PPM files. Counts the loop's launches."""
    overrides = ["detect.threshold=0.005", *overrides] + (
        ["detect.use_int8=1", "detect.calib_images=2"] if int8 else [])
    cfg = load_config(["config.ini"], overrides)
    frames = camera_frames()
    paths = write_ppms(frames, os.path.join(
        tmp, "camera_int8" if int8 else "camera"))
    names = [os.path.basename(p) for p in paths]
    lines = []

    def sink(n, frame, dets):
        for name, _, score, (x0, y0, x1, y1) in dets:
            lines.append(f"{names[n - 1]}: {name} {score:.3f} "
                         f"[{x0:.0f}, {y0:.0f}, {x1:.0f}, {y1:.0f}]")
        lines.append("")
        return False

    served = []
    launches = count_launches(lambda: served.append(camera_loop(
        cfg, npz, iter(frames), sink, device=device)))
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    saved = sys.stdin
    sys.stdin = io.StringIO("\n".join(paths) + "\n")
    try:
        stdin_out = run_cli(detect_cli, ["-c", "config.ini", "--weights",
                                         npz, "--stdin", *cpu,
                                         *overrides])[1]
    finally:
        sys.stdin = saved
    camera_out = "\n".join(lines) + "\n"
    label = "int8" if int8 else "bf16"
    print(f"  camera loop ({label}) over {served[0]} frames "
          f"({frames[0].shape[1]}x{frames[0].shape[0]} and "
          f"{frames[1].shape[1]}x{frames[1].shape[0]}): "
          f"{len(lines) - served[0]} detections, equal to cli.detect "
          f"--stdin: {camera_out == stdin_out}; launches {launches}",
          flush=True)
    check(served[0] == CAMERA_FRAMES and camera_out == stdin_out,
          f"the {label} camera loop == cli.detect --stdin")
    return launches


def drive_host_tools(tr: dict, device, overrides=()) -> None:
    """``cli.kmeans_anchors`` on the train path's cache, and the
    augmentation demo's grid rendered on ``device``."""
    printed = run_cli(kmeans_cli, ["-c", "config.ini",
                                   f"cache.basedir={tr['cache_dir']}",
                                   *overrides])[1]
    lines = printed.splitlines()
    print(f"  cli.kmeans_anchors on the train cache: {' / '.join(lines)}",
          flush=True)
    check(len(lines) == 2 and lines[1].startswith("anchors = ")
          and len(lines[1].split()) == 2 + 5, "five anchors printed")
    cfg = load_config(["config.ini"], [f"cache.basedir={tr['cache_dir']}",
                                       *overrides])
    t0 = time.perf_counter()
    grid = render_grid(cfg, 2, 3, SEED, device)
    dim = cfg.model.dim
    print(f"  augmentation grid on {device.type}: {grid.shape} uint8, "
          f"mean {grid.mean():.1f}, {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(grid.shape == (2 * dim, 3 * dim, 3) and grid.dtype == np.uint8
          and grid.any(), "the augmentation grid")


def print_mfu(card: str, label: str, images_per_sec: float,
              flops_per_image: float, peak: float, peak_name: str) -> None:
    print(f"  [{card}] mfu {label}: "
          f"{flops.mfu(images_per_sec, flops_per_image, peak):.4f} "
          f"({images_per_sec:.1f} img/s x {flops_per_image / 1e9:.2f} "
          f"GFLOP an image over the {peak_name} peak "
          f"{peak / 1e12:.1f} TFLOP/s)", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: multi-device (one process per device, torch.distributed)
# ---------------------------------------------------------------------------


def _reset_launches() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    for kern in (nms_greedy_cuda, stem_fused_cuda, int8_requant_cuda):
        kern.launches = 0


def _launches() -> dict:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"nms_greedy": nms_greedy_cuda.launches,
            "stem_fused": stem_fused_cuda.launches,
            "int8_requant": int8_requant_cuda.launches}


def _world_one_rank(rank: int, cache_dir: str, root: str, port: int,
                    cpu: list, overrides: list) -> dict:
    """(a), in a process of its own: ``cli.train`` on config.ini (train.zero=1,
    the in-training eval with the fused stem, a checkpoint, a resume), once
    without a process group and once inside a one-process ``nccl`` group
    made by ``distributed.initialize`` with the same config keys. cuDNN
    picks its algorithms by heuristics and deterministically in both."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    argv = ["-c", "config.ini", f"cache.basedir={cache_dir}",
            f"queue.batch_size={WORLD1_BATCH}", "train.save_steps=2",
            "train.summary_steps=1", f"train.eval_steps={WORLD1_STEPS - 1}",
            "train.zero=1", "detect.fuse_stem=pallas",
            f"eval.batch_size={EVAL_BATCH}", *overrides]
    cfg = load_config(["config.ini"], overrides)
    run_dir = f"{cfg.model.model}_{cfg.model.inference}"
    out = {}
    for name in ("plain", "group"):
        extra = []
        if name == "group":
            distributed.initialize(f"127.0.0.1:{port}", 1, 0,
                                   backend="nccl" if not cpu else "gloo",
                                   device="cpu" if cpu else "cuda")
            extra = [f"train.coordinator=127.0.0.1:{port}",
                     "train.num_processes=1", "train.process_id=0"]
        logroot = os.path.join(root, name)
        logdir = os.path.join(logroot, run_dir)
        _reset_launches()
        t0 = time.perf_counter()
        run_cli(train_cli, argv + extra + [f"train.logdir={logroot}",
                                           f"train.steps={WORLD1_STEPS - 1}",
                                           *cpu])
        launches = _launches()
        with log_lines("train") as resumed:
            run_cli(train_cli, argv + extra + [f"train.logdir={logroot}",
                                               f"train.steps={WORLD1_STEPS}",
                                               *cpu])
        seconds = time.perf_counter() - t0
        ck = Checkpointer(os.path.join(logdir, "ckpt"))
        _, state = ck.restore_latest_raw()
        out[name] = {"rows": metric_rows(logdir), "launches": launches,
                     "resumed": any(m.startswith(f"resumed from step "
                                                 f"{WORLD1_STEPS - 1}")
                                    for m in resumed),
                     "state": state, "seconds": seconds}
    a, b = out["plain"]["state"], out["group"]["state"]
    unequal = [f"{sec}/{k}" for sec in ("params", "bn_state")
               for k in a[sec] if not torch.equal(a[sec][k], b[sec][k])]
    unequal += [f"opt_state/{key}/{k}" for key, v in a["opt_state"].items()
                if isinstance(v, dict) for k in v
                if not torch.equal(v[k], b["opt_state"][key][k])]
    for name in out:
        out[name].pop("state")
    rows = {name: [{k: v for k, v in r.items()
                    if k not in ("images_per_sec", "time")}
                   for r in out[name]["rows"]] for name in out}
    out["rows_equal"] = rows["plain"] == rows["group"]
    out["unequal"] = unequal
    out["steps"] = a["step"], b["step"]
    return out


def check_world_one(tr: dict, tmp: str, device, card: str,
                    overrides=()) -> dict:
    """(a) world size 1 under ``nccl`` equals no process group, bit for
    bit: the metric rows (losses, gradient norms, the eval's mAP) and every
    tensor of the final checkpoint; the NMS kernel runs once an eval
    batch."""
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    res = launch.run(_world_one_rank, 1, group=False, timeout=MULTI_TIMEOUT,
                     args=(tr["cache_dir"], os.path.join(tmp, "world1"),
                           launch.free_port(), cpu, list(overrides)))[0]
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    g = res["group"]
    print(f"phase multi-device (a): cli.train b{WORLD1_BATCH} "
          f"train.zero=1, {WORLD1_STEPS - 1} steps + eval + resume to "
          f"{WORLD1_STEPS}: without a group {res['plain']['seconds']:.2f} s, "
          f"in a world-1 nccl group {g['seconds']:.2f} s; metric rows equal "
          f"{res['rows_equal']}, checkpoint tensors unequal "
          f"{len(res['unequal'])} {res['unequal'][:4]}; launches "
          f"{g['launches']}", flush=True)
    plain_rate = {r["step"]: r["images_per_sec"]
                  for r in res["plain"]["rows"] if "total" in r}
    for r in g["rows"]:
        if "total" in r:
            print(f"  [{card}] world-1 step {r['step']}: loss {r['total']:.6f}"
                  f" grad_norm {r['grad_norm']:.6f}, {r['images_per_sec']:.1f}"
                  f" img/s (no group: {plain_rate[r['step']]:.1f})",
                  flush=True)
    check(res["steps"] == (WORLD1_STEPS, WORLD1_STEPS),
          "both runs resumed to the last step")
    check(res["plain"]["resumed"] and g["resumed"], "both runs resumed")
    check(res["rows_equal"] and not res["unequal"],
          "world-1 nccl run == the run without a group, bit for bit")
    check(g["launches"]["nms_greedy"] == g["launches"]["stem_fused"]
          == batches, "the world-1 in-training eval: each kernel once a "
                      "batch")
    return g["launches"]


def multi_batches(cfg) -> list:
    """MULTI_STEPS global batches of MULTI_BATCH canvases with two boxes
    each, seeded."""
    rng = np.random.RandomState(SEED + 3)
    c, g = cfg.queue.canvas_dim, cfg.queue.max_boxes
    out = []
    for _ in range(MULTI_STEPS):
        images = rng.uniform(0, 1, (MULTI_BATCH, c, c, 3)).astype(np.float32)
        boxes = np.zeros((MULTI_BATCH, g, 4), np.float32)
        boxes[:, 0] = [0.4, 0.5, 0.3, 0.3]
        boxes[:, 1] = [0.7, 0.3, 0.2, 0.4]
        cls = rng.randint(0, 20, (MULTI_BATCH, g)).astype(np.int32)
        valid = np.zeros((MULTI_BATCH, g), bool)
        valid[:, :2] = True
        out.append((images, boxes, cls, valid))
    return out


def multi_setup(device, overrides=()):
    cfg = load_config(["config.ini"], MULTI_OVERRIDES + list(overrides))
    model = cfg.build_model()
    tx = train_step.make_optimizer(cfg.optimizer)
    ts = train_step.init_train_state(
        model, tx, torch.Generator().manual_seed(SEED), cfg.model.dim, device)
    fn = train_step.make_train_step(
        model, tx, loss_cfg=cfg.loss_config(), aug_cfg=cfg.augment,
        augment=True, compute_dtype=torch.float32)
    return cfg, ts, fn


def multi_steps(cfg, ts, fn, device) -> tuple:
    """The seeded steps, this rank's rows of each global batch: per-step
    (loss, ms on the host clock around the step and its sync)."""
    losses, ms = [], []
    for b in multi_batches(cfg):
        b = tuple(torch.from_numpy(a) for a in b)
        if ts.plan is not None and ts.plan.mesh.data > 1:
            b = shard_batch(ts.plan.mesh, b)
        b = tuple(t.to(device) for t in b)
        sync = torch.cuda.synchronize if device.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        ts, m = fn(ts, b, SEED + 1, cfg.model.dim)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["total"]))
    return losses, ms


def probe_collectives(device) -> dict:
    """Which collectives the default group takes on ``device`` tensors."""
    import torch.distributed as dist

    x = torch.ones(8, device=device)
    probes = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(dist.get_world_size())], x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "barrier": dist.barrier,
    }
    got = {}
    for name, fn in probes.items():
        try:
            fn()
            got[name] = "ok"
        except RuntimeError as e:
            got[name] = str(e).splitlines()[0][:120]
    return got


def multi_errors(got: dict, ref: dict) -> dict:
    """Two runs' distance: the largest relative loss error over the steps,
    the largest absolute parameter error, and the BN statistics' error as
    |a - b| / (|b| + atol / rtol) (<= rtol iff within assert_allclose's
    rtol and atol, the CPU tests' check)."""
    return {
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(got["losses"], ref["losses"])),
        "param": max(float((got["params"][k].detach().cpu() - v).abs().max())
                     for k, v in ref["params"].items()),
        "bn": max(float(((got["bn_state"][k].cpu() - v).abs()
                         / (v.abs() + MULTI_BN_ATOL / MULTI_BN_RTOL)).max())
                  for k, v in ref["bn_state"].items()),
    }


def _multi_rank(rank: int, ref_path: str, device_type: str,
                overrides: list) -> dict:
    """(b), on rank ``rank`` of two ``gloo`` ranks sharing the card: each
    mesh's steps from the seeded full state (f32, TF32 off, cuDNN's
    deterministic algorithms), its full state gathered; rank 0 measures
    its distance from the one-rank run."""
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    out = {"collectives": probe_collectives(device)}
    missing = [k for k, v in out["collectives"].items() if v != "ok"]
    if missing:
        raise RuntimeError(f"gloo on {device_type} tensors refuses "
                           f"{missing}: {out['collectives']}")
    ref = torch.load(ref_path) if rank == 0 else None
    torch.backends.cudnn.deterministic = True
    with full_f32():
        for name, data, model_ax, zero in MULTI_RUNS:
            cfg, ts, fn = multi_setup(device, overrides)
            Plan(make_mesh(data=data, model=model_ax), zero=zero).shard(ts)
            losses, ms = multi_steps(cfg, ts, fn, device)
            full = ts.plan.gather(ts) if ts.plan.sharded else \
                multi_state(ts)
            out[name] = {"losses": losses, "ms": ms}
            if rank == 0:
                out[name]["errors"] = multi_errors(
                    {"losses": losses, **full}, ref)
            del ts, full
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return out


def multi_state(ts) -> dict:
    return {"params": {k: v.detach().cpu()
                       for k, v in ts.net.named_parameters()},
            "bn_state": {k: v.cpu() for k, v in ts.net.named_buffers()
                         if k.endswith((".mean", ".var"))}}


def _moments_in_halves(y, mesh=None):
    """Train-mode BN's moments with every sum taken as two ranks take it:
    each half of the batch summed, then the two sums added (one process
    computing what a two-rank all-reduce computes, in f32)."""
    n = y.shape[0] * y.shape[1] * y.shape[2]
    h = y.shape[0] // 2

    def sum2(t):
        return t[:h].sum(dim=(0, 1, 2)) + t[h:].sum(dim=(0, 1, 2))

    m = sum2(y) / n
    return m, sum2(torch.square(y - m)) / n


def check_multi_steps(tmp: str, device, card: str, overrides=()) -> dict:
    """(b) two ranks on the one card under ``gloo`` (``nccl`` refuses two
    ranks on one GPU): data parallel with augmentation, ZeRO-1 and
    ``mesh_model=2``, each two steps of full-width Darknet-19 @416 on a
    global batch of 32 in f32 (TF32 off), against one rank on the same
    global batches with cuDNN's deterministic algorithms; the step times
    beside the one-rank step's, as a finding.

    Full-width Darknet-19 takes a large first step from its random init,
    and its 23 layers of batch statistics carry an f32 rounding difference
    to the loss and weights (the CPU tests' bounds hold on their smaller
    nets). So the one-rank step also runs twice more, to measure this
    card's floor for two runs of one step: once with every BN sum taken in
    the two ranks' halves (the order the all-reduce adds them in), once
    with cuDNN free to pick its (non-deterministic) algorithms, as the
    ranks' smaller batches make it pick others. Each mesh is held within
    the CPU tests' bounds or, where it is larger, twice the sum of the two
    floors."""
    from yolojax_torch.nn import layers

    refs = {}
    for name, det in (("deterministic", True), ("halves", True),
                      ("heuristic", False)):
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.deterministic = det
        cfg, ts, fn = multi_setup(device, overrides)
        with full_f32(), mock.patch.object(
                layers, "_batch_moments",
                _moments_in_halves if name == "halves"
                else layers._batch_moments):
            losses, ms = multi_steps(cfg, ts, fn, device)
        refs[name] = {"losses": losses, "ms": ms, **multi_state(ts)}
        del ts
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = False
    ref = refs["deterministic"]
    floors = {n: multi_errors(refs[n], ref) for n in ("halves", "heuristic")}
    limit = {k: max(bound, 2 * (floors["halves"][k]
                                + floors["heuristic"][k]))
             for k, bound in (("loss", MULTI_LOSS_RTOL),
                              ("param", MULTI_PARAM_ATOL),
                              ("bn", MULTI_BN_RTOL))}
    ref_path = os.path.join(tmp, "multi_ref.pt")
    torch.save(ref, ref_path)
    t0 = time.perf_counter()
    res = launch.run(_multi_rank, 2,
                     args=(ref_path, device.type, list(overrides)),
                     backend="gloo", device=device.type,
                     timeout=MULTI_TIMEOUT)
    seconds = time.perf_counter() - t0
    print(f"phase multi-device (b): gloo on {device.type} tensors: "
          f"{res[0]['collectives']}; two ranks, {seconds:.1f} s", flush=True)
    print(f"  [{card}] one rank b{MULTI_BATCH}@{cfg.model.dim} f32 (TF32 "
          f"off), deterministic cuDNN: losses "
          f"{', '.join(f'{v:.6f}' for v in ref['losses'])}; step ms "
          f"{', '.join(f'{v:.1f}' for v in ref['ms'])}", flush=True)
    for name, f in floors.items():
        print(f"  one rank, floor {name} vs deterministic: loss "
              f"{f['loss']:.2e}, params {f['param']:.2e}, BN {f['bn']:.2e}",
              flush=True)
    print(f"  limits (the CPU bounds 1e-5, or twice the floors' sum): loss "
          f"{limit['loss']:.2e}, params {limit['param']:.2e}, BN "
          f"{limit['bn']:.2e}", flush=True)
    for name, *_ in MULTI_RUNS:
        r = res[0][name]
        err = r["errors"]
        print(f"  [{card}] {name} 2 ranks: loss rel err {err['loss']:.2e}, "
              f"params max abs err {err['param']:.2e}, BN err "
              f"{err['bn']:.2e}; step ms rank 0 "
              f"{', '.join(f'{v:.1f}' for v in r['ms'])}, rank 1 "
              f"{', '.join(f'{v:.1f}' for v in res[1][name]['ms'])}",
              flush=True)
        check(res[1][name]["losses"] == r["losses"], f"{name}: ranks agree")
        check(all(err[k] <= limit[k] for k in limit),
              f"{name}: two ranks == one rank within the limits")
    return {"one_rank_ms": ref["ms"],
            **{n: res[0][n]["ms"] for n, *_ in MULTI_RUNS}}


def _eval_rank(rank: int, npz: str, cache_dir: str, dumps: list,
               overrides: list) -> list:
    """Both ``cli.eval`` runs of (c) on this rank of a two-process group,
    over the cache's first MULTI_EVAL_IMAGES images at batch 1: plain (the
    primary evaluates them while the other waits) and
    ``eval.distributed=1`` (each process its strided half); each with its
    kernel launches."""
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    keys = ["train.coordinator=127.0.0.1:1", "train.num_processes=2",
            f"train.process_id={rank}", "eval.batch_size=1"]
    out = []
    for dump, dist_on, batches in zip(
            dumps, ("0", "1"), (MULTI_EVAL_IMAGES, MULTI_EVAL_IMAGES // 2)):
        argv = ["--dump", dump, "--max-batches", str(batches)] + eval_argv(
            npz, cache_dir, device,
            overrides + keys + [f"eval.distributed={dist_on}"])
        _reset_launches()
        metrics, printed = run_cli(eval_cli, argv)
        out.append({"metrics": metrics, "launches": _launches(),
                    "printed": printed})
    return out


def _dump_rows(path: str) -> list:
    with open(path) as f:
        dump = json.load(f)
    return sorted((d["image_id"], d["category_id"], d["score"],
                   tuple(d["bbox"])) for d in dump["detections"])


def check_multi_eval(npz: str, ev: dict, tmp: str, device,
                     overrides=()) -> dict:
    """(c) ``cli.eval eval.distributed=1`` in two processes on the card
    (``gloo``) against the plain ``cli.eval`` of the same group's primary:
    equal metrics and detection lists; each process launches each kernel
    once a batch. Batches of one image: the card's bf16 convs give an image
    other last bits in another batch (the strided shards batch other
    images together), which would hide the eval's own faults. The first
    MULTI_EVAL_IMAGES images (``--max-batches``, which a distributed run
    counts per process) keep the batch-1 runs short."""
    dumps = [os.path.join(tmp, f"{n}_dump.json") for n in ("plain", "dist")]
    t0 = time.perf_counter()
    res = launch.run(_eval_rank, 2, backend="gloo", device=device.type,
                     timeout=MULTI_TIMEOUT,
                     args=(npz, ev["cache_dir"], dumps, list(overrides)))
    seconds = time.perf_counter() - t0
    plain, dist_res = res[0][0], [r[1] for r in res]
    want = plain["metrics"]
    same = _dump_rows(dumps[0]) == _dump_rows(dumps[1])
    launches = {k: sum(r["launches"][k] for r in dist_res)
                for k in plain["launches"]}
    print(f"phase multi-device (c): cli.eval eval.distributed=1, 2 processes "
          f"(gloo), {MULTI_EVAL_IMAGES} images at batch 1, {seconds:.1f} s: mAP "
          f"{dist_res[0]['metrics']['map']:.6f} / "
          f"{dist_res[1]['metrics']['map']:.6f} vs plain {want['map']:.6f}, "
          f"{dist_res[0]['metrics']['num_detections']} vs "
          f"{want['num_detections']} detections, lists equal {same}; "
          f"launches {[r['launches'] for r in dist_res]} (plain "
          f"{plain['launches']})", flush=True)
    check(res[1][0]["metrics"] is None and not res[1][0]["printed"],
          "plain eval: the second process waited for the primary")
    check(same, "distributed eval's detections == the plain run's")
    per_process = MULTI_EVAL_IMAGES // 2
    for r in dist_res:
        check(r["metrics"]["num_images"] == MULTI_EVAL_IMAGES
              and abs(r["metrics"]["map"] - want["map"]) <= 1e-6,
              "distributed metrics == the plain run's on every process")
        check(r["launches"]["nms_greedy"] == r["launches"]["stem_fused"]
              == per_process, "each process: each kernel once an image")
    check(bool(dist_res[0]["printed"]) and not dist_res[1]["printed"],
          "only the primary prints")
    return launches


def check_data_parallel_serving(npz: str, ev: dict, device,
                                overrides=()) -> dict:
    """(c) ``cli.detect --data-parallel`` and ``cli.serve --data-parallel``
    on the one card: a warning, the plain program's detections, launches
    counted, ``devices`` 1 in ``/healthz`` and ``/stats``."""
    import threading
    import urllib.request

    ppms = sorted(os.path.join(ev["img_dir"], f)
                  for f in os.listdir(ev["img_dir"]))[:4]
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    argv = ["-c", "config.ini", "--weights", npz, "detect.threshold=0.005",
            "detect.fuse_stem=pallas", *overrides, *cpu]
    images = [a for p in ppms for a in ("--image", p)]
    _, plain = run_cli(detect_cli, argv + images)
    _reset_launches()
    with log_lines("detect") as said:
        _, dp = run_cli(detect_cli, argv + images + ["--data-parallel"])
    detect_launches = _launches()
    cfg = load_config(["config.ini"], ["detect.threshold=0.005",
                                       *overrides])
    bodies = []
    for p in ppms:
        with open(p, "rb") as f:
            bodies.append(f.read())
    answers, stats = {}, {}
    serve_launches = None
    # fresh dispatch threads choose cuDNN plans by heuristics here, so the
    # two daemons' programs match bit for bit
    torch.backends.cudnn.benchmark = False
    try:
        for dp_on in (False, True):
            httpd, batcher = build_server(cfg, "127.0.0.1", 0, weights=npz,
                                          batch=ART_BATCH, window_ms=1.0,
                                          data_parallel=dp_on, device=device)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                _reset_launches()
                got = []
                for body in bodies:
                    req = urllib.request.Request(base + "/detect", data=body)
                    with urllib.request.urlopen(req, timeout=120) as r:
                        got.append(json.load(r)["detections"])
                if dp_on:
                    serve_launches = _launches()
                for path in ("/healthz", "/stats"):
                    with urllib.request.urlopen(base + path, timeout=60) as r:
                        stats[(dp_on, path)] = json.load(r)
            finally:
                httpd.shutdown()
                httpd.server_close()
                batcher.close()
                thread.join(30)
            answers[dp_on] = got
    finally:
        torch.backends.cudnn.benchmark = True
    devices = (stats[(True, "/healthz")]["devices"],
               stats[(True, "/stats")]["devices"])
    print(f"phase multi-device (c): cli.detect --data-parallel on 4 images: "
          f"{len(dp.splitlines())} detections, equal to the plain run "
          f"{dp == plain}, launches {detect_launches}, warned "
          f"{any('only 1 local device' in m for m in said)}; cli.serve "
          f"--data-parallel: 4 requests, devices (/healthz, /stats) "
          f"{devices}, answers equal {answers[True] == answers[False]}, "
          f"launches {serve_launches}", flush=True)
    check(dp == plain and bool(plain), "detect --data-parallel == plain")
    check(any("only 1 local device" in m for m in said),
          "detect --data-parallel warned of the one device")
    check(detect_launches["nms_greedy"] == detect_launches["stem_fused"] == 1,
          "detect --data-parallel: one batch, each kernel once")
    check(devices == (1, 1), "/healthz and /stats report 1 device")
    check(answers[True] == answers[False], "serve --data-parallel == plain")
    check(serve_launches["nms_greedy"] == stats[(True, "/stats")]["batches"]
          >= 1, "serve --data-parallel: one NMS launch a batch")
    return {"dp_detect": detect_launches, "dp_serve": serve_launches}


def check_grain(tr: dict, tmp: str, device, overrides=()) -> None:
    """(d) ``queue.loader=grain``: three steps and a resume to four when
    grain imports here; otherwise the ImportError must name it."""
    from yolojax_torch.data.grain_loader import make_loader

    try:
        import grain.python  # noqa: F401
    except ImportError as e:
        print(f"phase multi-device (d): grain is absent here ({e})",
              flush=True)
        try:
            make_loader(load_cache(tr["cache_dir"], "train"),
                        LoaderConfig(), "grain")
        except ImportError as err:
            check("grain" in str(err), "the ImportError names grain")
            return
        check(False, "queue.loader=grain without grain raised")
    cpu = ["--device", "cpu"] if device.type == "cpu" else []
    root = os.path.join(tmp, "grain_logdir")
    argv = ["-c", "config.ini", f"cache.basedir={tr['cache_dir']}",
            "queue.loader=grain", "queue.batch_size=8", "train.save_steps=3",
            "train.summary_steps=1", f"train.logdir={root}", *overrides]
    cfg = load_config(["config.ini"], overrides)
    t0 = time.perf_counter()
    run_cli(train_cli, argv + ["train.steps=3", *cpu])
    with log_lines("train") as resumed:
        run_cli(train_cli, argv + ["train.steps=4", *cpu])
    steps = [r["step"] for r in metric_rows(os.path.join(
        root, f"{cfg.model.model}_{cfg.model.inference}"))]
    print(f"phase multi-device (d): queue.loader=grain, 3 steps + resume to "
          f"4 in {time.perf_counter() - t0:.1f} s; steps logged {steps}; "
          f"{[m for m in resumed if 'grain' in m]}", flush=True)
    check(steps == [1, 2, 3, 4], "grain: every step logged once")
    check(any("restored grain loader state for step 3" in m
              for m in resumed), "grain: the stream state was restored")


def drive_multi_device(npz: str, ev: dict, tr: dict, tmp: str, device,
                       card: str, overrides=()) -> dict:
    """Phase 11: (a)-(d). Returns the kernels' launches on the new paths
    and the step times of (b). ``overrides`` shrink the model for a
    rehearsal on the CPU."""
    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    launches = {"world1_train": check_world_one(tr, tmp, device, card,
                                                overrides)}
    times = check_multi_steps(tmp, device, card, overrides)
    launches["dist_eval"] = check_multi_eval(npz, ev, tmp, device, overrides)
    launches.update(check_data_parallel_serving(npz, ev, device, overrides))
    check_grain(tr, tmp, device, overrides)
    print(f"phase multi-device: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "times": times}


# ---------------------------------------------------------------------------
# phase 12: TF export
# ---------------------------------------------------------------------------


def _spec_arrays(spec: dict) -> dict:
    """The arrays of a ``tf_graph.export_spec``, as ``{"<layer>.<key>":
    array}``."""
    return {f"{i}.{key}": v for i, layer in enumerate(spec["layers"])
            for key, v in layer.items() if isinstance(v, np.ndarray)}


def _spec_layout(spec: dict) -> list:
    """A spec without its arrays: ops, strides, activations, routes."""
    return [{key: v for key, v in layer.items()
             if not isinstance(v, np.ndarray) and key != "r"}
            for layer in spec["layers"]]


def check_tf_spec(npz: str, calib: torch.Tensor, device,
                  overrides=()) -> dict:
    """Phase 12 (a): ``export_spec`` of config.ini's portable build
    (``build_serving(portable=True)``, what ``cli.export --format
    savedmodel|tflite --device`` runs) with ``device`` against the CPU.
    f32: the folded weights are equal bit for bit (the fold runs on the
    host). int8, calibrated on the same ``calib`` canvases on each side:
    the weight codes and the f32 head are equal, the activation scales
    differ by the calibration's bf16 convs (printed). Returns the kernels'
    launches over both builds (the portable program launches none)."""
    cpu = torch.device("cpu")
    specs = {}
    _reset_launches()
    for int8 in (False, True):
        cfg = load_config(["config.ini"], [*overrides] + (
            ["detect.use_int8=1"] if int8 else []))
        for side, dev in (("card", device), ("cpu", cpu)):
            canvases = list(calib.to(dev)) if int8 else None
            _, _, infer_fn, net, _ = build_serving(cfg, npz, canvases,
                                                   device=dev, portable=True)
            specs[int8, side] = export_spec(infer_fn.model, net, infer_fn.qm)
            del infer_fn, net
    launches = _launches()
    card, host = (_spec_arrays(specs[False, s]) for s in ("card", "cpu"))
    check(_spec_layout(specs[False, "card"]) == _spec_layout(specs[False, "cpu"])
          and card.keys() == host.keys()
          and all(card[k].dtype == host[k].dtype
                  and card[k].tobytes() == host[k].tobytes() for k in card),
          "tf export: the f32 spec built on the card == the CPU's bit for bit")
    nbytes = sum(v.nbytes for v in card.values())
    q_card, q_host = (specs[True, s] for s in ("card", "cpu"))
    qa, qb = _spec_arrays(q_card), _spec_arrays(q_host)
    codes = [k for k in qa if k.endswith(".w_q")]
    head = [k for k in qa if q_card["layers"][int(k.split(".")[0])].get(
        "head")]
    check(_spec_layout(q_card) == _spec_layout(q_host)
          and qa.keys() == qb.keys() and len(codes) > 0
          and all(np.array_equal(qa[k], qb[k]) for k in codes + head),
          "tf export: the int8 spec's weight codes and head card == CPU")
    scales = np.asarray([q_card["int8"]["input_scale"],
                         *q_card["int8"]["act_scales"]])
    ref = np.asarray([q_host["int8"]["input_scale"],
                      *q_host["int8"]["act_scales"]])
    scale_rel = float(np.max(np.abs(scales - ref) / ref))
    print(f"phase tf export (a): f32 spec card == cpu bit for bit "
          f"({len(card)} arrays, {nbytes / 1e6:.1f} MB); int8 spec: "
          f"{len(codes)} layers' w_q codes and the head equal, largest "
          f"act-scale difference {scale_rel:.3e} relative "
          f"({len(scales)} scales); launches {launches}", flush=True)
    check(launches == {"nms_greedy": 0, "stem_fused": 0, "int8_requant": 0},
          "the portable builds launched no kernel")
    return launches


def start_tf_refusal(npz: str, tmp: str) -> tuple:
    """Phase 12 (b), where tensorflow does not import (the card's machine):
    starts ``python -m yolojax_torch.cli.export --format savedmodel``, which
    must exit non-zero naming tensorflow and write no directory
    (:func:`check_tf_refusal`). It runs while (a) builds."""
    out = os.path.join(tmp, "tf_refused_savedmodel")
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolojax_torch.cli.export", "-c",
         "config.ini", "--weights", npz, "--out", out, "--format",
         "savedmodel"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return proc, out


def check_tf_refusal(proc, out: str) -> None:
    try:
        _, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    said = (stderr.strip().splitlines() or [""])[-1]
    print(f"phase tf export (b): cli.export --format savedmodel exits "
          f"{proc.returncode}: {said}", flush=True)
    check(proc.returncode != 0 and "tensorflow" in stderr,
          "cli.export --format savedmodel without tensorflow exits non-zero "
          "naming it")
    check(not os.path.exists(out), "the refused export wrote nothing")


def check_tf_savedmodel(npz: str, canvases: torch.Tensor, tmp: str, device,
                        overrides=()) -> None:
    """Phase 12 (c), only where tensorflow imports: ``cli.export --format
    savedmodel --batch 1`` on the CPU, then its keep mask on one canvas
    against the live f32 ``build_serving(portable=True)`` program on
    ``device`` (TF32 off)."""
    # the eval floor, so candidates are valid and the sweep does work
    overrides = ["detect.threshold=0.005", *overrides]
    out = os.path.join(tmp, "tf_export_savedmodel")
    _, printed = run_cli(export_cli, [
        "-c", "config.ini", "--weights", npz, "--out", out, "--format",
        "savedmodel", "--batch", "1", "--device", "cpu", *overrides])
    from yolojax_torch.serve.savedmodel import load_savedmodel

    _, serve_fn = load_savedmodel(out)
    x = canvases[:1].float().contiguous()
    got = serve_fn(x.cpu().numpy())
    cfg = load_config(["config.ini"], list(overrides))
    _, _, infer_fn, net, _ = build_serving(cfg, npz, device=device,
                                           portable=True)
    with full_f32():
        want = infer_fn(net, x.to(device))
    keep = want["keep"].cpu().numpy()
    print(f"phase tf export (c): {printed.strip()}; keep {int(keep.sum())} "
          f"of {keep.size}, equal to the live program's: "
          f"{np.array_equal(got['keep'], keep)}", flush=True)
    check(np.array_equal(got["keep"], keep),
          "the SavedModel's keep mask == the live portable program's")


def drive_tf_export(npz: str, canvases: torch.Tensor, tmp: str, device,
                    overrides=()) -> dict:
    """Phase 12: (a), then (b) or, where tensorflow imports, (c). Returns
    the launches of (a)'s builds."""
    import importlib.util

    t0 = time.perf_counter()
    has_tf = importlib.util.find_spec("tensorflow") is not None
    refusal = None if has_tf else start_tf_refusal(npz, tmp)
    launches = check_tf_spec(npz, canvases[:8], device, overrides)
    if has_tf:
        check_tf_savedmodel(npz, canvases, tmp, device, overrides)
    else:
        check_tf_refusal(*refusal)
    print(f"phase tf export: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"tf_export": launches}


def main() -> int:
    os.chdir(ROOT)  # config.ini and its names_file are repo-relative
    card = identify()
    device = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True

    t0 = time.perf_counter()
    build_kernels()
    print(f"phase build: {time.perf_counter() - t0:.1f} s", flush=True)

    # the eval floor: every one of the 256 candidates is valid, so the NMS
    # kernel does real work on random weights (serving's 0.3 leaves none)
    cfg = load_config(["config.ini"], ["detect.threshold=0.005"])
    print("phase kernels vs plain:", flush=True)
    nms_err = compare_kernels(device, cfg.detect.nms_iou)
    requant_err = compare_requant(device)
    compare_products(device)

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "darknet19_seed0.npz")
        t0 = time.perf_counter()
        random_weights(cfg, npz)
        print(f"weights: {cfg.model.model}/{cfg.model.inference} dim "
              f"{cfg.model.dim}, {os.path.getsize(npz) / 2**20:.1f} MiB npz "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        progs = serving_programs(npz)
        stem_err, stem_ratio = compare_stem(device, progs["pallas"][1].conv_0)
        check_auto_launches(npz, device)

        run = drive_main_path(cfg, npz, device, BATCH)
        check(run["launches"] >= 2, "the main path launched the NMS kernel "
                                    "(run_detect's batch and the b128 batch)")
        shifted, valid, keep = check_main_path(cfg, run["out"], device)
        model = check_forward(cfg, npz, device, 96)

        ev = drive_eval_path(npz, tmp, device, EVAL_IMAGES)
        batches = -(-EVAL_IMAGES // EVAL_BATCH)
        check(ev["launches"]["stem_fused"] == ev["launches"]["nms_greedy"]
              == batches, "the eval path launched each kernel once a batch")
        check_fused_head(cfg, npz, ev["cache_dir"], device)

        check_int8_card_vs_cpu(device)
        i8 = drive_int8_cli(npz, tmp, ev, device)
        # the int8 convs: every conv but the bf16 head
        n_int8 = sum(isinstance(s, ConvSpec)
                     for s in cfg.build_model().specs) - 1
        for path, images in (("int8_detect", 1), ("int8_stdin", 3),
                             ("int8_eval", batches)):
            got = i8["launches"][path]
            check(got["int8_requant"] == n_int8 * images
                  and got["nms_greedy"] == images and got["stem_fused"] == 0,
                  f"{path}: int8_requant {n_int8} and nms_greedy once a batch")

        tr = drive_train_path(tmp, device, EVAL_IMAGES)
        check(tr["launches"]["stem_fused"] == tr["launches"]["nms_greedy"]
              == batches, "the in-training eval launched each kernel once "
                          "a batch")
        check_checkpoint_as_weights(tr, device)
        check_train_card_vs_cpu(device)
        _, _, om, onet = check_overfit(device)
        check_int8_map(om, onet, tmp, device)

        print("phase qat -> export -> serve:", flush=True)

        def qat_phase():
            check_qat_card_vs_cpu(device)
            check_qat_beats_ptq(device)
            qr = drive_qat_cli(npz, tr, ev, tmp, device)
            qat_times = time_qat_steps(load_config(["config.ini"]), npz,
                                       device, card)
            ppms = sorted(os.path.join(ev["img_dir"], f)
                          for f in os.listdir(ev["img_dir"]))
            arts = drive_export(npz, qr["outputs"][0], ppms, tmp, device)
            art_run = check_artifacts(arts, ppms, run["canvases"], card)
            served = drive_serve(arts, ppms, device, card)
            art_cli = drive_artifact_clis(arts, ev, ppms, device)
            return qr, arts, art_run, served, art_cli, qat_times

        # as users run these entry points: in a process without cuDNN's
        # autotuned plans. Turning autotuning off is not enough: cuDNN's
        # plans are cached per thread, under a key without the autotuning
        # flag, so this thread still holds the plans it autotuned in the
        # earlier phases. With them its cli.detect --artifact has run the
        # int8 head conv on another engine than the daemon's dispatch
        # thread, whose scores then all differed in their last bits, and
        # now and then an image's detections in their order. The phase
        # runs in a thread of its own, whose cache starts empty, and
        # without autotuning, which costs ~60 s on QAT's first f32 step at
        # b64.
        torch.backends.cudnn.benchmark = False
        with ThreadPoolExecutor(1) as pool:
            qr, arts, art_run, served, art_cli, qat_times = pool.submit(
                qat_phase).result()
        torch.backends.cudnn.benchmark = True
        print(f"  [{card}] export seconds: " + ", ".join(
            f"{k} {v[3]:.2f} s" for k, v in arts.items()), flush=True)
        qat_launches = {"qat_eval": qr["launches"],
                        "artifact_bf16": art_run["launches"]["bf16_fused_b8"],
                        "artifact_int8": art_cli["artifact_int8"],
                        "serve": served["launches"],
                        "artifact_stdin": art_cli["artifact_stdin"]}
        art_batches = -(-EVAL_IMAGES // ART_BATCH)
        for what, got, (nms, stem, requant) in (
                ("the QAT npz's int8 eval", qr["launches"],
                 (batches, 0, n_int8 * batches)),
                ("artifact bf16_fused_b8", art_run["launches"]["bf16_fused_b8"],
                 (1, 1, 0)),
                ("artifact int8_b8", art_run["launches"]["int8_b8"],
                 (1, 0, n_int8)),
                ("artifact bf16_b1", art_run["launches"]["bf16_b1"], (1, 0, 0)),
                ("the daemon", served["launches"],
                 (served["batches"], 0, n_int8 * served["batches"])),
                ("cli.detect --artifact --stdin", art_cli["artifact_stdin"],
                 (3, 0, 0)),
                ("cli.eval --artifact", art_cli["artifact_int8"],
                 (art_batches, 0, n_int8 * art_batches))):
            check(got == {"nms_greedy": nms, "stem_fused": stem,
                          "int8_requant": requant},
                  f"{what} launched its kernels inside the program")

        cfg_path = check_cfg_specs(tmp)
        check_adam_card_vs_cpu(device)
        weights = drive_converters(cfg, npz, cfg_path, tmp, card)
        tool_launches = {
            "weights_detect": drive_weights_detect(npz, weights, tmp, device),
            "camera": drive_camera(npz, tmp, device, int8=False),
            "camera_int8": drive_camera(npz, tmp, device, int8=True)}
        for path, want in (
                ("weights_detect", (1, 1, 0)),
                ("camera", (CAMERA_FRAMES, 0, 0)),
                ("camera_int8", (CAMERA_FRAMES, 0, n_int8 * CAMERA_FRAMES))):
            check(tool_launches[path] == dict(zip(
                ("nms_greedy", "stem_fused", "int8_requant"), want)),
                f"{path}: launches {want} (nms, stem, requant)")
        drive_host_tools(tr, device)

        print(f"phase times [{card}]:", flush=True)
        time_path(cfg, npz, model, run, card)
        progs.update(int8_programs(npz, run["canvases"]))
        for fuse in ("int8-off", "int8-xla"):
            infer_fn, net = progs[fuse]
            got = count_launches(lambda: infer_fn(net, run["canvases"]))
            print(f"  b{BATCH} {fuse} batch launches {got}", flush=True)
            check(got == {"nms_greedy": 1, "stem_fused": 0,
                          "int8_requant": n_int8},
                  f"{fuse}: one NMS and {n_int8} requant launches a batch")
        fusion_ms = time_fusion(progs, run["canvases"], card)
        stem_times = time_stem(progs, run["canvases"], card)
        nms_times = time_nms(shifted, valid, keep, cfg.detect.nms_iou, card)
        requant_times = time_int8_requant(progs, run["canvases"], card)
        time_eval(ev["argv"], EVAL_IMAGES, card)
        time_eval(i8["eval_argv"], EVAL_IMAGES, card,
                  "int8 trunk (no stem fusion; calibrates each run)")
        ips = tr["images_per_sec"]
        print(f"  [{card}] cli.train images_per_sec, steps 1-{len(ips)}: "
              f"{', '.join(f'{v:.1f}' for v in ips)} (median of steps 2-"
              f"{len(ips)}: {statistics.median(ips[1:]):.1f})", flush=True)
        train_times = time_train_step(load_config(["config.ini"]), device,
                                      card)
        # MFU over the H100 SXM5's dense peaks (utils/flops.py), FLOPs of
        # the unfused model as yolojax counts them
        unfused = cfg.build_model()
        per_image = flops.model_flops_per_image(unfused, cfg.model.dim)
        print_mfu(card, f"b{BATCH} bf16 fused serving",
                  BATCH / statistics.mean(fusion_ms["pallas"]) * 1e3,
                  per_image, flops.PEAK_BF16, "bf16")
        int8_ips = BATCH / statistics.mean(fusion_ms["int8-xla"]) * 1e3
        print(f"  [{card}] mfu b{BATCH} int8 xla serving: "
              f"{flops.int8_mfu(int8_ips, unfused, cfg.model.dim):.4f} "
              f"({int8_ips:.1f} img/s; the trunk at the int8 peak "
              f"{flops.PEAK_INT8 / 1e12:.1f} TFLOP/s, the bf16 head at the "
              f"bf16 peak {flops.PEAK_BF16 / 1e12:.1f})", flush=True)
        train_per_image = flops.train_flops_per_image(unfused, cfg.model.dim)
        tb = cfg.queue.batch_size
        print_mfu(card, f"b{tb} bf16 train step", train_times["img_s"],
                  train_per_image, flops.PEAK_BF16, "bf16")
        for kind in ("qat", "distill"):
            print_mfu(card, f"b{tb} f32 {kind} step (TF32 off)",
                      tb / qat_times[kind]["ms"] * 1e3, train_per_image,
                      flops.PEAK_F32, "f32")

        multi = drive_multi_device(npz, ev, tr, tmp, device, card)
        tf_run = drive_tf_export(npz, run["canvases"], tmp, device)

    # launches: the eval path's run (the int8 kernel: the int8 detect run);
    # launches_by_path: each path's own run
    by_path = {name: {"serving": serving, "eval": ev["launches"][name],
                      "train": tr["launches"][name],
                      **{p: i8["launches"][p][name] for p in INT8_PATHS},
                      **{p: qat_launches[p][name] for p in QAT_PATHS},
                      **{p: tool_launches[p][name] for p in TOOL_PATHS},
                      **{p: multi["launches"][p][name] for p in MULTI_PATHS},
                      **{p: tf_run[p][name] for p in TF_PATHS}}
               for name, serving in (("nms_greedy", run["launches"]),
                                     ("stem_fused", run["stem_launches"]),
                                     ("int8_requant", run["int8_launches"]))}
    print(json.dumps({"kernels": [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "yolojax_torch/csrc/nms_greedy.cu",
        "replaces": "yolojax/postprocess/pallas_nms.py:93",
        "launches": ev["launches"]["nms_greedy"],
        "launches_by_path": by_path["nms_greedy"],
        "max_abs_err": nms_err,
        **nms_times,
        "library_ms": None,
        "redesigned": "PR 3",
    }, {
        "name": "stem_fused",
        "route": "cuda",
        "source": "yolojax_torch/csrc/stem_fused.cu",
        "replaces": "yolojax/nn/pallas_stem.py:83",
        "launches": ev["launches"]["stem_fused"],
        "launches_by_path": by_path["stem_fused"],
        "max_abs_err": stem_err,
        "max_err_over_tolerance": stem_ratio,
        **stem_times,
        "library_ms": None,
        "redesigned": "PR 3",
    }, {
        "name": "int8_requant",
        "route": "cuda",
        "source": "yolojax_torch/csrc/int8_requant.cu",
        "replaces": "XLA epilogue fusion in yolojax/quantize/ptq.py:363",
        "launches": i8["launches"]["int8_detect"]["int8_requant"],
        "launches_by_path": by_path["int8_requant"],
        "max_abs_err": requant_err,
        **requant_times,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
