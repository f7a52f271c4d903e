"""The serving program (forward + decode + top-K + NMS on the device) and
batched validation over a cached phase -> host VOC/COCO mAP.

Port of ``yolojax/eval/evaluator.py``. Per batch: the host loader's
canvases go to the device, the serving program runs there (the fused-stem
and NMS kernels on the card), and only the fixed-shape outputs come back;
the host un-pads them into detection lists and scores them with
``eval/voc_map.py``. With ``int8`` the trunk runs quantized
(``quantize/ptq.py``), calibrated on the phase's first images.
``infer_override`` scores an exported artifact's program instead
(``fixed_batch``: its baked batch).

``data_parallel`` splits each batch over the process's CUDA devices, one
replica of the program on each (with one device it is the plain path);
``distributed`` under a process group has every process evaluate its
strided shard of the cache and all-gather the detection and ground-truth
rows, so every process scores the same global lists.
"""

from __future__ import annotations

import contextlib
import copy
import json
import logging
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.data.augment import letterbox_transform
from yolojax_torch.data.loader import Loader, LoaderConfig
from yolojax_torch.eval.voc_map import compute_coco_map, compute_map
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network, StemLayer
from yolojax_torch.nn.stem import fuse_stem
from yolojax_torch.parallel import distributed as dist_util
from yolojax_torch.postprocess.nms import postprocess_v1, postprocess_v2
from yolojax_torch.quantize.ptq import (
    QuantizedModel,
    apply_int8,
    quantize_model,
)
from yolojax_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

# The eval protocol's score floor: low enough to keep the PR tail mAP/AR
# integrate over.
EVAL_SCORE_THRESH = 0.005


def make_infer_fn(model: Model, *, score_thresh: float, iou_thresh: float,
                  top_k: int, use_pallas: str = "auto",
                  candidates: str = "auto",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  qm: Optional[QuantizedModel] = None,
                  ) -> Callable[[Network, torch.Tensor], Dict[str, torch.Tensor]]:
    """-> infer(net, images) -> {boxes, scores, classes, keep}, all fixed
    shape, on the images' device. images: (N, H, W, 3) in [0, 1].

    ``qm``: a :class:`QuantizedModel` on the images' device; the int8
    trunk (``apply_int8``) then runs instead of the forward, and ``net``
    is not read. ``infer`` runs in inference mode; ``infer.forward(net,
    images, qm=qm)`` is the same program outside it, for ``torch.export``
    (``yolojax_torch/serve``), ``infer.qm`` is ``qm`` and ``infer.model``
    is ``model``."""

    def forward(net: Network, images: torch.Tensor,
                qm: Optional[QuantizedModel] = qm) -> Dict[str, torch.Tensor]:
        if qm is not None:
            head = apply_int8(qm, images)
        else:
            head = model.apply(net, images, compute_dtype=compute_dtype)
        if model.kind == "v2":
            return postprocess_v2(
                head, model.anchors, score_thresh=score_thresh,
                iou_thresh=iou_thresh, top_k=top_k, use_pallas=use_pallas,
                candidates=candidates,
            )
        return postprocess_v1(
            head, model.grid, model.boxes_per_cell, model.num_classes,
            score_thresh=score_thresh, iou_thresh=iou_thresh, top_k=top_k,
            use_pallas=use_pallas, candidates=candidates,
        )

    infer = torch.inference_mode()(forward)
    infer.forward, infer.qm, infer.model = forward, qm, model
    return infer


def serving_weights(net: Network, device: torch.device,
                    dtype: torch.dtype) -> Network:
    """Move ``net`` to ``device`` (in place) with conv/dense kernels stored
    once in the compute dtype (conv kernels channels_last); biases stay
    f32. The forward casts kernels to the compute dtype anyway, so this
    only saves the per-call cast. A fused stem keeps its f32 weights: the
    stem kernel reads them as they are."""
    net = net.to(device).requires_grad_(False).eval()
    for layer in net.children():
        if isinstance(layer, StemLayer):
            continue
        w = layer.w.detach().to(dtype)
        if w.dim() == 4:
            w = w.contiguous(memory_format=torch.channels_last)
        layer.w = nn.Parameter(w, requires_grad=False)
    return net


def _dump_coco_json(path, detections, ground_truth, num_images,
                    num_classes, box_scale, class_names=None,
                    gt_difficult=None):
    """Write the eval set + detections as one COCO-format JSON for
    external cross-checking: ``gt`` loads into ``pycocotools.COCO()``,
    ``detections`` into ``COCO.loadRes()``. Boxes are converted from
    canvas-normalized (ymin, xmin, ymax, xmax) to COCO's pixel [x, y, w, h];
    category ids are 1-based per COCO convention."""

    def xywh(box):
        y0, x0, y1, x1 = (float(v) * box_scale for v in box)
        return [x0, y0, max(x1 - x0, 0.0), max(y1 - y0, 0.0)]

    names = list(class_names or [])
    gt = {
        "images": [{"id": i, "width": int(box_scale),
                    "height": int(box_scale)} for i in range(num_images)],
        "categories": [
            {"id": c + 1,
             "name": names[c] if c < len(names) else f"class_{c}"}
            for c in range(num_classes)
        ],
        # VOC difficult GT rides iscrowd=1: pycocotools then ignores it
        "annotations": [
            {"id": i + 1, "image_id": int(img), "category_id": int(cls) + 1,
             "bbox": (b := xywh(box)), "area": b[2] * b[3],
             "iscrowd": int(bool(gt_difficult[i])) if gt_difficult is not None
             else 0}
            for i, (img, cls, box) in enumerate(ground_truth)
        ],
    }
    results = [
        {"image_id": int(img), "category_id": int(cls) + 1,
         "bbox": xywh(box), "score": float(score)}
        for img, cls, score, box in detections
    ]
    with open(path, "w") as f:
        json.dump({"gt": gt, "detections": results}, f)
    log.info("eval: dumped COCO-format GT + %d detections -> %s",
             len(results), path)


def local_devices(device) -> List[torch.device]:
    """The devices of this process that a data-parallel program splits a
    batch over: every CUDA device for a CUDA ``device``, else ``device``
    alone. A process of a multi-process group owns its one device (one
    process per device), so it splits over nothing else."""
    device = torch.device(device)
    if device.type == "cuda" and dist_util.process_count() == 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def data_parallel_infer(infer, replicas):
    """``canvases -> dict of numpy``: each batch split into equal row
    blocks, block i run by ``infer(net_i, block, qm=qm_i)`` on
    ``replicas[i] = (device_i, net_i, qm_i)``, the outputs concatenated in
    order. Every block is dispatched before any result is read, so the
    devices run at once. The batch must split evenly; ``run.devices`` is
    the device count."""
    n = len(replicas)

    def run(canvases) -> Dict[str, np.ndarray]:
        x = torch.as_tensor(canvases)
        if x.shape[0] % n:
            raise ValueError(f"data-parallel serving needs batch % {n} == 0, "
                             f"got batch {x.shape[0]}")
        outs = []
        for (dev, net, qm), block in zip(replicas, x.chunk(n)):
            ctx = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                outs.append(infer(net, block.to(dev, torch.float32)
                                  .contiguous(), qm=qm))
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}

    run.devices = n
    return run


def replicate(net, qm, devices) -> list:
    """(device, net, qm) of the program on each of ``devices``: ``net``
    (already serving weights) copied, or ``qm`` moved."""
    out = []
    for dev in devices:
        out.append((dev, None if net is None else copy.deepcopy(net).to(dev),
                    None if qm is None else qm.to(dev)))
    return out


def _eval_loader(cache, batch_size: int, input_dim: int, stretch: bool,
                 shard_index: int = 0, shard_count: int = 1) -> Loader:
    return Loader(cache, LoaderConfig(
        batch_size=batch_size, canvas_dim=input_dim, max_boxes=64,
        stretch=stretch, drop_remainder=False, num_threads=8,
        shard_index=shard_index, shard_count=shard_count))


def _allgather_shards(detections, ground_truth, gt_difficult, num_images,
                      n_proc):
    """Every process's eval shard -> the global lists (yolojax's
    ``_allgather_shards``). Detections and ground truth are packed into
    f32 rows of 7 (GT rows carry the difficult flag), zero-padded to the
    largest count, and all-gathered; a local image id becomes ``local *
    n_proc + rank``, the image's index in the cache under the strided
    split."""
    rank = dist_util.process_index()
    # ids ride in f32 rows: above 2^24 integers lose precision
    if num_images * n_proc >= 2 ** 24:
        raise ValueError(
            f"distributed eval id space {num_images} x {n_proc} processes "
            f"exceeds float32 integer range (2^24); shard the eval set")

    def pack(rows, width):
        if not rows:
            return np.zeros((0, width), np.float32)
        return np.stack([np.concatenate([[float(r[0]) * n_proc + rank],
                                         np.asarray(r[1:-1], np.float32),
                                         np.asarray(r[-1], np.float32)])
                         for r in rows]).astype(np.float32)

    det = pack(detections, 7)  # gid, cls, score, box[4]
    gt = pack([(img, cls, float(diff), box)
               for (img, cls, box), diff in zip(ground_truth, gt_difficult)],
              7)                # gid, cls, difficult, box[4]
    counts = dist_util.all_gather_numpy(
        np.asarray([det.shape[0], gt.shape[0], num_images], np.int64))
    cap_d, cap_g = int(counts[:, 0].max()), int(counts[:, 1].max())

    def gather(arr, cap):
        # cap is a global max: every process takes the same branch
        pad = np.zeros((cap - arr.shape[0], 7), np.float32)
        return dist_util.all_gather_numpy(np.concatenate([arr, pad]))

    all_det = gather(det, cap_d) if cap_d else None
    all_gt = gather(gt, cap_g) if cap_g else None
    detections = [
        (int(r[0]), int(r[1]), float(r[2]), r[3:7])
        for p in range(n_proc) for r in all_det[p, : int(counts[p, 0])]
    ] if cap_d else []
    gt_rows = [
        r for p in range(n_proc) for r in all_gt[p, : int(counts[p, 1])]
    ] if cap_g else []
    ground_truth = [(int(r[0]), int(r[1]), r[3:7]) for r in gt_rows]
    gt_difficult = [bool(r[2]) for r in gt_rows]
    return detections, ground_truth, gt_difficult, int(counts[:, 2].sum())


def _live_program(model, net, cache, device, *, input_dim, batch_size,
                  stretch, fold, fuse_stem_impl, int8, calib_images,
                  calib_percentile, quant_bits, compute_dtype, score_thresh,
                  nms_iou, top_k, use_pallas, candidates, data_parallel):
    """The serving program of ``evaluate_model``'s settings on a copy of
    ``net``: canvases (numpy) -> dict of numpy arrays; with
    ``data_parallel`` and more than one local device, replicated on each
    (returns the program and its device count)."""
    device = resolve_device(device)
    if compute_dtype is None:
        compute_dtype = (torch.float32 if device.type == "cpu"
                         else torch.bfloat16)
    net = copy.deepcopy(net)
    if fold or int8:
        model, net = fold_bn(model, net)  # at 1e-5, as yolojax folds
        if not int8:  # int8 quantizes the trunk itself
            model, net = fuse_stem(model, net, impl=fuse_stem_impl)
    qm = None
    if int8:
        net = net.to(device).requires_grad_(False).eval()  # f32: quantized
        want = max(calib_images, 1)
        chunks = []
        for imgs, _, _, _ in _eval_loader(cache, batch_size, input_dim,
                                          stretch).epoch(0, shuffle=False):
            chunks.append(imgs)
            if sum(c.shape[0] for c in chunks) >= want:
                break
        calib = torch.from_numpy(np.concatenate(chunks)[:want]).to(device)
        qm = quantize_model(model, net, calib, percentile=calib_percentile,
                            bits=quant_bits)
    else:
        net = serving_weights(net, device, compute_dtype)
    infer = make_infer_fn(model, score_thresh=score_thresh,
                          iou_thresh=nms_iou, top_k=top_k,
                          use_pallas=use_pallas, candidates=candidates,
                          compute_dtype=compute_dtype, qm=qm)
    devices = local_devices(device) if data_parallel else [device]
    if len(devices) > 1:
        log.info("eval: data-parallel over %d local devices", len(devices))
        return data_parallel_infer(
            infer, replicate(None if int8 else net, qm, devices)), len(devices)

    def run(images: np.ndarray) -> Dict[str, np.ndarray]:
        x = torch.from_numpy(images).to(device)
        return {k: v.cpu().numpy() for k, v in infer(net, x).items()}

    return run, 1


def evaluate_model(
    model: Optional[Model],
    net: Optional[Network],
    cache,
    *,
    input_dim: int,
    batch_size: int = 32,
    score_thresh: float = EVAL_SCORE_THRESH,  # low: keep the PR tail
    nms_iou: float = 0.45,
    top_k: int = 256,
    map_iou: float = 0.5,
    use_pallas: str = "auto",
    candidates: str = "auto",
    compute_dtype: Optional[torch.dtype] = None,  # None: f32 CPU, bf16 card
    max_batches: Optional[int] = None,
    stretch: bool = False,
    fold: bool = True,
    fuse_stem_impl: str = "off",
    max_detections: int = 0,  # cap kept detections per image (0 = no cap)
    coco: bool = False,  # add COCO-style AP@[.50:.95] + size bins
    dump_path: Optional[str] = None,  # write COCO-format GT+results JSON
    class_names: Optional[Sequence[str]] = None,  # labels for the dump
    device=None,  # default: the CUDA card (raises without one)
    int8: bool = False,  # post-training int8 conv trunk (implies fold)
    calib_images: int = 8,  # int8 activation-calibration image count
    calib_percentile: float = 100.0,  # int8 |act| percentile (100 = absmax)
    quant_bits: int = 8,  # int8 code width (detect.quant_bits; <8 coarsens)
    data_parallel: Optional[bool] = None,  # None: all local devices
    distributed: bool = False,  # multi-process: shard the cache per process
    infer_override=None,  # callable(canvases) -> dict of numpy arrays
    fixed_batch: Optional[int] = None,  # the artifact's batch (pad to it)
    num_classes: Optional[int] = None,  # required when model is None
) -> Dict[str, float]:
    """Run detection over a cached phase and return VOC (and with
    ``coco``, COCO) metrics plus ``num_images`` and ``num_detections``.
    ``net`` is not changed: the fold, the stem fusion and the move to the
    device work on a copy.

    ``int8`` folds BN, fuses no stem, and quantizes the network on the
    first ``calib_images`` canvases of the phase (in cache order), as
    yolojax does. ``infer_override`` (an exported artifact's program, see
    ``cli/detect.py::load_artifact_detector``) replaces the model: its
    thresholds, top-K, NMS and precision are baked, ``model`` and ``net``
    may be None, and each batch is padded to ``fixed_batch``.

    ``data_parallel`` (None: when the process has more than one device)
    splits each batch over the local devices; int8 stays on one device
    unless it is True, and an artifact never splits (it owns its device).
    ``distributed=True`` under a process group of more than one process:
    every process evaluates its strided shard of the cache, the rows are
    all-gathered, and every process returns the same global metrics; ALL
    processes must call it together. With one process it is plain eval."""
    n_proc = dist_util.process_count()
    rank = dist_util.process_index()
    distributed = distributed and n_proc > 1
    n_cls = model.num_classes if model is not None else num_classes
    if n_cls is None:
        raise ValueError("num_classes is required when model is None")
    n_dev = 1
    if infer_override is not None:
        if distributed:
            raise ValueError("artifact eval is single-process (the baked "
                             "program has no shard axis); unset "
                             "eval.distributed")
        if fixed_batch:
            batch_size = fixed_batch  # loader batches must match the program
        run = infer_override
    else:
        if int8 and data_parallel is None:
            data_parallel = False  # int8 serving is latency-oriented
        run, n_dev = _live_program(
            model, net, cache, device, input_dim=input_dim,
            batch_size=batch_size, stretch=stretch, fold=fold,
            fuse_stem_impl=fuse_stem_impl, int8=int8,
            calib_images=calib_images, calib_percentile=calib_percentile,
            quant_bits=quant_bits, compute_dtype=compute_dtype,
            score_thresh=score_thresh, nms_iou=nms_iou, top_k=top_k,
            use_pallas=use_pallas, candidates=candidates,
            data_parallel=data_parallel is not False)
    loader = _eval_loader(cache, batch_size, input_dim, stretch,
                          rank if distributed else 0,
                          n_proc if distributed else 1)
    # cache indices in loader order (epoch 0, no shuffle, strided shard),
    # to find each image's difficult GT
    eval_order = np.arange(len(cache))
    if distributed:
        eval_order = eval_order[rank::n_proc]

    detections = []
    ground_truth = []
    gt_difficult = []  # aligned with ground_truth (VOC ignore semantics)
    img_id = 0
    for bi, (images, boxes, classes, valid) in enumerate(
            loader.epoch(0, shuffle=False)):
        if max_batches is not None and bi >= max_batches:
            break
        n_actual = images.shape[0]
        pad = (fixed_batch - n_actual if fixed_batch
               else (-n_actual) % n_dev)
        if pad > 0:
            # a short last batch: pad to the program's shape, drop the extras
            images = np.concatenate([images, np.zeros(
                (pad,) + images.shape[1:], images.dtype)])
        out = {k: v[:n_actual] for k, v in run(images).items()}
        images = images[:n_actual]
        # GT is already in canvas coords, consistent with detections; the
        # row-major nonzero keeps the (image, slot) order
        for k, g in zip(*(a.tolist() for a in np.nonzero(valid))):
            cx, cy, w, h = boxes[k, g]
            ground_truth.append(
                (img_id + k, int(classes[k, g]),
                 np.asarray([cy - h / 2, cx - w / 2,
                             cy + h / 2, cx + w / 2])))
        gt_difficult.extend([False] * (len(ground_truth) - len(gt_difficult)))
        # the difficult GT, which the loader's training view leaves out
        for k in range(images.shape[0]):
            ci = int(eval_order[bi * batch_size + k])
            _, cb, cc, cd = cache.example_eval(ci)
            if not cd.any():
                continue
            iw, ih = (int(v) for v in cache.sizes[ci])
            sx, sy, px, py = letterbox_transform(iw, ih, input_dim,
                                                 stretch=stretch)
            for b, c_ in zip(cb[cd], cc[cd]):
                cx = b[0] * sx + px
                cy = b[1] * sy + py
                w, h = b[2] * sx, b[3] * sy
                ground_truth.append(
                    (img_id + k, int(c_),
                     np.asarray([cy - h / 2, cx - w / 2,
                                 cy + h / 2, cx + w / 2])))
                gt_difficult.append(True)
        keep = out["keep"]
        if max_detections:
            # NMS output is score-sorted along the box axis: keep the first
            # max_detections kept entries per image
            keep = keep & (np.cumsum(keep, axis=1) <= max_detections)
        for k, d in zip(*(a.tolist() for a in np.nonzero(keep))):
            detections.append(
                (img_id + k, int(out["classes"][k, d]),
                 float(out["scores"][k, d]), out["boxes"][k, d]))
        img_id += images.shape[0]
    log.info("eval: %d images, %d detections, %d gt boxes%s",
             img_id, len(detections), len(ground_truth),
             f" (shard {rank}/{n_proc})" if distributed else "")
    if distributed:
        detections, ground_truth, gt_difficult, img_id = _allgather_shards(
            detections, ground_truth, gt_difficult, img_id, n_proc)
    if dump_path and rank == 0:
        _dump_coco_json(dump_path, detections, ground_truth, img_id,
                        n_cls, float(input_dim), class_names,
                        gt_difficult=gt_difficult)
    metrics = compute_map(detections, ground_truth, n_cls,
                          iou_thresh=map_iou, gt_difficult=gt_difficult)
    if coco:
        # boxes are canvas-normalized; scale areas to canvas pixels so the
        # COCO small/medium/large bins mean what they do in COCO
        metrics.update(compute_coco_map(detections, ground_truth, n_cls,
                                        box_scale=float(input_dim),
                                        gt_ignore=gt_difficult))
    metrics["num_images"] = img_id
    metrics["num_detections"] = len(detections)
    return metrics
