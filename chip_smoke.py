#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``yolojax_torch``) on one CUDA card.

Usage, from the root of a checkout, on a machine with an H100 and ``nvcc``:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. identify the card (``nvidia-smi`` name and power limit) and the software;
2. build every CUDA kernel of the serving path from ``yolojax_torch/csrc``
   (``nvcc -Xptxas -v`` output is printed);
3. hold each kernel against its plain PyTorch version on the card;
4. drive the serving path as a user does (``build_detector`` and
   ``run_detect`` on YOLOv2 Darknet-19 at 416, full width, random weights
   from a seed), count the kernel launches of that run, check the path's
   NMS output against the plain sweep, and check the f32 forward on the
   card against the CPU on a small input;
5. time the path and the kernels on the card.

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

import numpy as np
import torch

from yolojax_torch.cli.detect import build_detector, build_serving, run_detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.kernels import build
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
# f32 operations of one IoU(i, j) > thr test, as the kernel computes it:
# 2 min, 2 max, 2 sub, 2 clamp, 1 mul, 1 add, 1 sub, 1 clamp, 1 div, 1 cmp
IOU_OPS = 14
AREA_OPS = 5  # 2 sub, 2 clamp, 1 mul per box
# f32 forward on the card vs the CPU, TF32 off: summation order only
FORWARD_RTOL = 1e-4


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
    res = build.build("nms_greedy", verbose=True)
    print(f"build nms_greedy: {res.seconds:.2f} s -> {res.path.name}"
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
    with contextlib.redirect_stdout(io.StringIO()) as det_lines:
        results = run_detect(cfg, npz, images, detector=detector)
    out = infer(canvases)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = nms_greedy_cuda.launches
    print(f"phase main path: nms_greedy launches {launches}", flush=True)
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
    max_err = compare_kernels(device, cfg.detect.nms_iou)

    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "darknet19_seed0.npz")
        t0 = time.perf_counter()
        random_weights(cfg, npz)
        print(f"weights: {cfg.model.model}/{cfg.model.inference} dim "
              f"{cfg.model.dim}, {os.path.getsize(npz) / 2**20:.1f} MiB npz "
              f"in {time.perf_counter() - t0:.1f} s", flush=True)
        run = drive_main_path(cfg, npz, device, BATCH)
        check(run["launches"] >= 2, "the main path launched the NMS kernel "
                                    "(run_detect's batch and the b128 batch)")
        shifted, valid, keep = check_main_path(cfg, run["out"], device)
        model = check_forward(cfg, npz, device, 96)
        print(f"phase times [{card}]:", flush=True)
        time_path(cfg, npz, model, run, card)
        nms_times = time_nms(shifted, valid, keep, cfg.detect.nms_iou, card)

    print(json.dumps({"kernels": [{
        "name": "nms_greedy",
        "route": "cuda",
        "source": "yolojax_torch/csrc/nms_greedy.cu",
        "replaces": "yolojax/postprocess/pallas_nms.py:93",
        "launches": run["launches"],
        "max_abs_err": max_err,
        **nms_times,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
