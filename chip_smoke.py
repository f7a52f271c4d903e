#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yolojax_torch``) on one CUDA card.

Usage, from the root of a checkout, on a machine with an H100 and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. identify the card (``nvidia-smi`` name and power limit) and the software;
2. build every CUDA kernel of the port from ``yolojax_torch/csrc``, one
   ``nvcc`` per source, all at once (``-Xptxas -v`` output is printed);
3. hold each kernel against its plain PyTorch version on the card: the
   greedy-NMS kernel on nine cases, the fused-stem kernel on five input
   shapes with random and with the seeded Darknet-19's conv0 weights
   (and ``detect.fuse_stem=auto`` launches it, as ``pallas`` does);
4. drive the serving path as a user does (``build_detector`` and
   ``run_detect`` on YOLOv2 Darknet-19 at 416, full width, random weights
   from a seed), count the kernel launches of that run, check the path's
   NMS output against the plain sweep, and check the f32 forward on the
   card against the CPU on a small input;
5. drive the eval path as a user does (``cli.cache`` on a seeded COCO-layout
   set of PPM images, then ``cli.eval`` with ``detect.fuse_stem=pallas``),
   count its kernel launches (each kernel once per batch), check its
   metrics and the fused-stem head against the unfused forward;
6. time the paths and the kernels on the card.

The line before the last is one JSON object describing each kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from yolojax_torch.cli import cache as cache_cli
from yolojax_torch.cli import eval as eval_cli
from yolojax_torch.cli.detect import build_detector, build_serving, run_detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.data.cache import load_cache
from yolojax_torch.data.loader import Loader, LoaderConfig, write_ppm
from yolojax_torch.eval.evaluator import serving_weights
from yolojax_torch.kernels import build
from yolojax_torch.nn import cuda_stem
from yolojax_torch.nn.cuda_stem import stem_fused_cuda
from yolojax_torch.nn.layers import conv2d, leaky_relu, max_pool
from yolojax_torch.nn.stem import fuse_stem, pack_stem_kernel, stem_fused_torch
from yolojax_torch.postprocess import cuda_nms
from yolojax_torch.postprocess.cuda_nms import MAX_K, nms_greedy_cuda
from yolojax_torch.postprocess.nms import (
    CLASS_OFFSET,
    nms_greedy_torch,
    postprocess_v2,
)

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
           ("stem_fused", cuda_stem.NVCC_FLAGS))
# (N, H, W) inputs of the stem kernel against its plain version: the eval
# batch, one image, a smaller and a larger (multiscale 608) square, a tiny one
STEM_CASES = ((BATCH, 416, 416), (1, 416, 416), (3, 320, 320),
              (2, 608, 608), (5, 64, 64))
STEM_MAX_ULPS = 1  # bf16 ulps, kernel vs plain (both sum in one f32 order)
# fused-stem head vs the unfused forward, of max|ref|: the stem rounds its
# input and output to bf16 at other points than conv 0 + pool do
STEM_HEAD_RTOL = 3e-2
EVAL_IMAGES, EVAL_BATCH = 64, 32


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
        f"n4_k{MAX_K}_over_48KB_smem": nms_case(rng, 4, MAX_K, 5, 0.9, device),
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


def compare_stem(device, stem_layer) -> float:
    """The stem kernel against its plain version on the card, on
    :data:`STEM_CASES` with random weights and with ``stem_layer``'s (the
    seeded Darknet-19's folded conv0); returns the largest absolute
    difference."""
    rng = np.random.RandomState(SEED + 2)
    w0 = rng.normal(0, 0.2, (3, 3, 3, 32)).astype(np.float32)
    weights = {
        "random": (torch.from_numpy(pack_stem_kernel(w0)).to(device),
                   torch.from_numpy(rng.normal(0, 0.1, 32).astype(
                       np.float32)).to(device)),
        "darknet19 conv0": (stem_layer.wp, stem_layer.b),
    }
    gen = torch.Generator(device).manual_seed(SEED + 3)
    worst = 0.0
    for n, h, w in STEM_CASES:
        x = torch.rand((n, h, w, 3), device=device, generator=gen)
        for label, (wp, b) in weights.items():
            got = stem_fused_cuda(x, wp, b)
            want = stem_fused_torch(x, wp, b)
            torch.cuda.synchronize()
            ulps = bf16_ulps(got, want)
            err = float((got.float() - want.float()).abs().max())
            worst = max(worst, err)
            print(f"  stem ({n}, {h}, {w}) {label} weights: max "
                  f"{int(ulps.max())} bf16 ulp ({int((ulps > 0).sum())} of "
                  f"{ulps.numel()} values differ), max abs err {err:.3g}",
                  flush=True)
            check(got.shape == (n, h // 2, w // 2, 32)
                  and got.dtype == torch.bfloat16, "stem output shape/type")
            check(int(ulps.max()) <= STEM_MAX_ULPS,
                  f"stem kernel within {STEM_MAX_ULPS} ulp of plain on "
                  f"({n}, {h}, {w}) {label}")
            del got, want, ulps
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
    return worst


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
    with contextlib.redirect_stdout(io.StringIO()) as det_lines:
        results = run_detect(cfg, npz, images, detector=detector)
    out = infer(canvases)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = nms_greedy_cuda.launches
    print(f"phase serving path: nms_greedy launches {launches}, stem_fused "
          f"launches {stem_fused_cuda.launches} (detect.fuse_stem="
          f"{cfg.detect.fuse_stem})", flush=True)
    for label, raw, dets in results:
        print(f"  run_detect {label} {raw.shape[1]}x{raw.shape[0]}: "
              f"{len(dets)} detections", flush=True)
    check(len(det_lines.getvalue().splitlines())
          == sum(len(r[2]) for r in results), "one line per detection")
    return {"launches": launches, "out": out, "canvases": canvases,
            "infer": infer}


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
    model, net_cpu = fold_bn(model, load_network_npz(npz, model),
                             eps=cfg.model.bn_eps)
    net_dev = copy.deepcopy(net_cpu).to(device)
    small = torch.rand((2, dim, dim, 3),
                       generator=torch.Generator().manual_seed(SEED + 1))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            ref = model.apply(net_cpu, small, compute_dtype=torch.float32)
            got = model.apply(net_dev, small.to(device),
                              compute_dtype=torch.float32).cpu()
            bf = model.apply(net_dev, small.to(device),
                             compute_dtype=torch.bfloat16).cpu()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
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
    t0 = time.perf_counter()
    metrics, printed = run_cli(eval_cli, argv)
    if device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"nms_greedy": nms_greedy_cuda.launches,
                "stem_fused": stem_fused_cuda.launches}
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
            "argv": argv, "seconds": seconds}


def check_fused_head(cfg, npz: str, cache_dir: str, device) -> None:
    """Batch 0 of the eval set through the fused-stem forward (the stem
    kernel on the card) against the unfused forward, in the serving dtype."""
    cache = load_cache(cache_dir, "test")
    images = next(Loader(cache, LoaderConfig(
        batch_size=EVAL_BATCH, canvas_dim=cfg.model.dim, max_boxes=64,
        drop_remainder=False, num_threads=4)).epoch(0, shuffle=False))[0]
    model = cfg.build_model()
    model, net = fold_bn(model, load_network_npz(npz, model),
                         eps=cfg.model.bn_eps)
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


def time_fusion(progs: dict, canvases, card: str) -> None:
    """The device-resident batch with the stem unfused and fused, in turns
    (off, pallas, pallas, off), with peak device memory; then the profile
    of one fused batch."""
    batch, dim = canvases.shape[0], canvases.shape[1]
    times = {fuse: [] for fuse in progs}
    peaks = dict.fromkeys(progs, 0)
    for fuse in ("off", "pallas", "pallas", "off"):
        infer_fn, net = progs[fuse]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times[fuse].append(statistics.median(
            cuda_ms(lambda: infer_fn(net, canvases), 5)))
        peaks[fuse] = max(peaks[fuse], torch.cuda.max_memory_allocated())
    for fuse, ms in times.items():
        mean = statistics.mean(ms)
        print(f"  [{card}] b{batch}@{dim} bf16 device-resident, "
              f"detect.fuse_stem={fuse}: {mean:.3f} ms/batch (medians of 5 "
              f"in two turns: {', '.join(f'{t:.3f}' for t in ms)}), "
              f"{batch / mean * 1e3:.1f} img/s, peak device memory "
              f"{peaks[fuse] / 2**30:.2f} GiB (both programs' weights "
              "resident)", flush=True)
    infer_fn, net = progs["pallas"]
    profile_batch(lambda: infer_fn(net, canvases), card + ", fused stem")


def stem_bound_ms(x: torch.Tensor, stem_layer) -> tuple:
    """Least time of the fused stem on ``x``: the larger of its bytes (the
    f32 input, weights and bias read once, the bf16 output written once)
    over HBM bandwidth and its multiply-adds (27 taps x 32 channels for each
    of the four pool phases of every pooled pixel) over the bf16 peak."""
    n, h, w, _ = x.shape
    pixels = n * (h // 2) * (w // 2)
    co = stem_layer.b.numel()
    nbytes = (x.numel() * 4 + stem_layer.w0.numel() * 4 + co * 4
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
                               w0=stem_layer.w0)

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


def time_eval(argv: list, n_images: int, card: str) -> None:
    """A second run of the same ``cli.eval`` (plans built): images/s of
    the whole path, host loader and mAP included."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_cli(eval_cli, argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(f"  [{card}] cli.eval, {n_images} images at batch {EVAL_BATCH}, "
          f"fused stem: {seconds:.3f} s = {n_images / seconds:.1f} img/s "
          "(cache load, host decode + letterbox, device, mAP)", flush=True)


def time_nms(shifted, valid, keep, iou_thresh: float, card: str) -> dict:
    """The kernel's device time (launch overhead kept out), its time per
    call from Python, the plain sweep's time per call (one CUDA-event pair
    around each call: ~1,300 small launches, so mostly host time), and the
    kernel's bound on these inputs."""
    n, k = valid.shape

    def kernel():
        return nms_greedy_cuda(shifted, valid, iou_thresh)

    ms = cuda_ms_queued(kernel, 200)
    call_ms = statistics.median(cuda_ms(kernel, 20))
    plain_ms = statistics.median(cuda_ms(
        lambda: nms_greedy_torch(shifted, valid, iou_thresh), 3))
    bound_ms, bound_by, nbytes, ops = nms_bound_ms(shifted, valid, keep)
    print(f"  [{card}] nms_greedy at ({n}, {k}): kernel {ms * 1e3:.2f} us on "
          f"the device ({call_ms * 1e3:.2f} us a call from Python), bound "
          f"{bound_ms * 1e3:.3f} us ({bound_by}: {nbytes} B, {ops} f32 ops), "
          f"plain sweep {plain_ms * 1e3:.1f} us, library none", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


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

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "darknet19_seed0.npz")
        t0 = time.perf_counter()
        random_weights(cfg, npz)
        print(f"weights: {cfg.model.model}/{cfg.model.inference} dim "
              f"{cfg.model.dim}, {os.path.getsize(npz) / 2**20:.1f} MiB npz "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        progs = serving_programs(npz)
        stem_err = compare_stem(device, progs["pallas"][1].conv_0)
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

        print(f"phase times [{card}]:", flush=True)
        time_path(cfg, npz, model, run, card)
        time_fusion(progs, run["canvases"], card)
        stem_times = time_stem(progs, run["canvases"], card)
        nms_times = time_nms(shifted, valid, keep, cfg.detect.nms_iou, card)
        time_eval(ev["argv"], EVAL_IMAGES, card)

    # launches: the eval path's run (this script's main path)
    print(json.dumps({"kernels": [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "yolojax_torch/csrc/nms_greedy.cu",
        "replaces": "yolojax/postprocess/pallas_nms.py:93",
        "launches": ev["launches"]["nms_greedy"],
        "max_abs_err": nms_err,
        **nms_times,
        "library_ms": None,
    }, {
        "name": "stem_fused",
        "route": "cuda",
        "source": "yolojax_torch/csrc/stem_fused.cu",
        "replaces": "yolojax/nn/pallas_stem.py:83",
        "launches": ev["launches"]["stem_fused"],
        "max_abs_err": stem_err,
        **stem_times,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
