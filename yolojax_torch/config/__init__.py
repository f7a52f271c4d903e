"""Layered INI config, the dialect of ``yolojax/config/__init__.py``.

``-c`` takes several files (later override earlier) and ``section.key=value``
overrides beat both. Sections: ``[model]`` ``[cache]`` ``[queue]``
``[data_augmentation]`` ``[train]`` ``[optimizer]`` ``[detect]``
``[summary]`` ``[eval]``, parsed into typed dataclasses. Optimizer keys are
accepted in ``[train]`` too, and ``[summary]`` aliases the train-section
summary knobs. Unknown sections and keys warn instead of failing.
"""

from __future__ import annotations

import configparser
import dataclasses
import logging
import os
from typing import Dict, List, Sequence, Tuple

from yolojax_torch.data.augment import AugmentConfig
from yolojax_torch.data.loader import LoaderConfig
from yolojax_torch.train.losses import YoloV1LossConfig, YoloV2LossConfig
from yolojax_torch.train.step import OptimizerConfig

log = logging.getLogger(__name__)

# copy of yolojax.data.cache.VOC_NAMES (the names() fallback)
VOC_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
# COCO's 80 detection categories in Darknet's coco.names order (the same
# list as config/names/coco.txt): the names() fallback for 80 classes
COCO_NAMES = (
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "sofa", "pottedplant", "bed", "diningtable", "toilet", "tvmonitor",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model: str = "yolo2"           # yolo | yolo2 | yolo3
    inference: str = "darknet"     # builder name within the model package
    names_file: str = ""           # class-names list path
    num_classes: int = 20          # derived from names_file when present
    anchors: Tuple[Tuple[float, float], ...] = ()  # v2; () -> builder default
    boxes_per_cell: int = 2        # v1
    grid: int = 7                  # v1
    dim: int = 416                 # input dim (448 for v1)
    # loss lambdas (Darknet region/detection defaults)
    coord_scale: float = -1.0      # -1 -> per-kind default
    object_scale: float = -1.0
    noobject_scale: float = -1.0
    class_scale: float = -1.0
    iou_thresh: float = 0.6
    rescore: bool = True
    prior_scale: float = 0.0
    leaky_alpha: float = 0.1
    bn_eps: float = 1e-5
    compile_cache: str = ""        # yolojax's jit cache dir; unused here


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    basedir: str = "cache"
    # whitespace-separated entries "voc:<root>:<image_set>" or
    # "coco:<ann_json>:<image_dir>", per phase
    train: str = ""
    val: str = ""
    test: str = ""


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    logdir: str = "logdir"
    steps: int = 100_000
    save_steps: int = 1000
    keep_checkpoints: int = 5      # checkpoints kept (newest first)
    summary_steps: int = 20
    image_summary_steps: int = 0   # 0 disables box-drawn image dumps
    histogram_steps: int = 0       # 0 disables param/grad histograms
    eval_steps: int = 0            # run val-phase mAP every N steps (0 off)
    seed: int = 0
    multi_scale: bool = False
    multi_scale_min: int = 320
    multi_scale_max: int = 608
    multi_scale_every: int = 10
    compute_dtype: str = "bfloat16"
    remat: bool = False            # recompute the forward in the backward
    tensorboard: bool = False      # TensorBoard events beside the jsonl
    profile_steps: int = 0         # torch.profiler trace of step N
    profile_port: int = 0          # live profiler server: refused in torch
    debug_nans: bool = False       # autograd anomaly detection
    halt_on_nonfinite: bool = True # stop + forensic save on a NaN/inf loss
    # multi-device, one process per device (parallel/): the (data, model)
    # mesh over the processes (mesh_data 0: the processes left after
    # mesh_model), ZeRO-1 optimizer sharding over data, and the process
    # group's rendezvous (or JAX_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID)
    mesh_data: int = 0
    mesh_model: int = 1
    zero: bool = False
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    threshold: float = 0.3
    nms_iou: float = 0.4
    top_k: int = 256
    use_pallas: str = "auto"       # auto|always: CUDA kernel; never: plain
    candidates: str = "auto"       # top-k select: auto|exact|approx (exact)
    stretch: bool = False          # plain resize instead of letterbox
    use_int8: bool = False         # int8 PTQ conv trunk (quantize/ptq.py)
    use_ema: bool = False          # checkpoint dirs: the EMA weights
    calib_images: int = 8          # int8: images used for activation calib
    calib_percentile: float = 100.0  # int8: |act| percentile for scales
    quant_bits: int = 8            # int8 path code width
    fuse_stem: str = "off"         # fused conv0+pool: off|auto|pallas|xla
                                   # (auto, pallas: the CUDA stem kernel)


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    batch_size: int = 32
    map_iou: float = 0.5
    max_detections: int = 100
    data_parallel: str = "auto"    # auto|on|off: split over local devices
    distributed: bool = False      # multi-process eval: a shard per process

    def data_parallel_flag(self):
        """Map the INI string onto evaluate_model's tri-state arg."""
        v = self.data_parallel.strip().lower()
        if v in ("auto", ""):
            return None
        if v in ("1", "true", "yes", "on"):
            return True
        if v in ("0", "false", "no", "off"):
            return False
        raise ValueError(
            f"eval.data_parallel = {self.data_parallel!r}: expected "
            "auto, on, or off"
        )


@dataclasses.dataclass(frozen=True)
class YoloJaxConfig:
    model: ModelConfig = ModelConfig()
    cache: CacheConfig = CacheConfig()
    queue: LoaderConfig = LoaderConfig()
    augment: AugmentConfig = AugmentConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    train: TrainConfig = TrainConfig()
    detect: DetectConfig = DetectConfig()
    eval: EvalConfig = EvalConfig()

    def names(self) -> Tuple[str, ...]:
        """The class names: ``names_file``'s lines, else VOC's first
        ``num_classes`` (at most 20) or COCO's 80. Any other count without
        a names file raises: a silent cut to VOC's 20 would build a model
        of fewer classes than asked for."""
        if self.model.names_file and os.path.exists(self.model.names_file):
            with open(self.model.names_file) as f:
                return tuple(l.strip() for l in f if l.strip())
        n = self.model.num_classes
        if n == len(COCO_NAMES):
            return COCO_NAMES
        if n > len(VOC_NAMES):
            raise ValueError(
                f"model.num_classes={n} with no names file: the built-in "
                f"names are VOC's {len(VOC_NAMES)} and COCO's "
                f"{len(COCO_NAMES)}; set model.names_file")
        return VOC_NAMES[:n]

    def build_model(self):
        from yolojax_torch.models import get_model

        names = self.names()
        return get_model(
            self.model.model,
            self.model.inference,
            num_classes=len(names),
            anchors=self.model.anchors or None,
            boxes_per_cell=self.model.boxes_per_cell,
            grid=self.model.grid,
        )

    def loss_config(self):
        m = self.model

        def pick(v, d):
            return d if v < 0 else v

        if self.model.model == "yolo2":
            return YoloV2LossConfig(
                coord_scale=pick(m.coord_scale, 1.0),
                object_scale=pick(m.object_scale, 5.0),
                noobject_scale=pick(m.noobject_scale, 1.0),
                class_scale=pick(m.class_scale, 1.0),
                iou_thresh=m.iou_thresh,
                rescore=m.rescore,
                prior_scale=m.prior_scale,
            )
        return YoloV1LossConfig(
            coord_scale=pick(m.coord_scale, 5.0),
            object_scale=pick(m.object_scale, 1.0),
            noobject_scale=pick(m.noobject_scale, 0.5),
            class_scale=pick(m.class_scale, 1.0),
            rescore=m.rescore,
        )

    def cache_datasets(self, phase: str) -> List[dict]:
        spec = getattr(self.cache, phase, "")
        out = []
        for entry in spec.split():
            kind, rest = entry.split(":", 1)
            if kind == "voc":
                root, image_set = rest.rsplit(":", 1)
                out.append({"kind": "voc", "root": root, "image_set": image_set})
            elif kind == "coco":
                ann, img_dir = rest.rsplit(":", 1)
                out.append({"kind": "coco", "ann_json": ann, "image_dir": img_dir})
            else:
                raise ValueError(f"unknown dataset entry {entry!r}")
        return out


_SECTION_TYPES = {
    "model": ModelConfig,
    "cache": CacheConfig,
    "queue": LoaderConfig,
    "data_augmentation": AugmentConfig,
    "train": TrainConfig,
    "optimizer": OptimizerConfig,
    "detect": DetectConfig,
    "eval": EvalConfig,
}
_SECTION_FIELD = {"data_augmentation": "augment"}
# optimizer keys are accepted in [train] too
_TRAIN_OPTIMIZER_KEYS = {f.name: f
                         for f in dataclasses.fields(OptimizerConfig)}
# [summary] aliases onto the train-section knobs; explicit [train] keys win
_SUMMARY_KEYS = {
    "scalar": "summary_steps",
    "scalar_steps": "summary_steps",
    "summary_steps": "summary_steps",
    "histogram": "histogram_steps",
    "histogram_steps": "histogram_steps",
    "image": "image_summary_steps",
    "image_steps": "image_summary_steps",
    "image_summary_steps": "image_summary_steps",
}


def _coerce(field: dataclasses.Field, raw: str):
    t = field.type
    if t in ("bool", bool):
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if t in ("int", int):
        return int(float(raw))
    if t in ("float", float):
        return float(raw)
    if "Tuple[Tuple[float, float], ...]" in str(t):
        vals = [float(v) for v in raw.replace(",", " ").split()]
        if len(vals) % 2:
            raise ValueError(f"anchors need pairs, got {raw!r}")
        return tuple((vals[i], vals[i + 1]) for i in range(0, len(vals), 2))
    if "Tuple[int, ...]" in str(t):
        return tuple(int(float(v)) for v in raw.replace(",", " ").split())
    return raw


def load_config(
    paths: Sequence[str],
    overrides: Sequence[str] = (),
) -> YoloJaxConfig:
    """Load layered INI files (later override earlier) + CLI overrides of the
    form ``section.key=value``."""
    parser = configparser.ConfigParser(inline_comment_prefixes=(";", "#"))
    for p in paths:
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        parser.read(p)
    for ov in overrides:
        key, eq, value = ov.partition("=")
        section, dot, name = key.strip().partition(".")
        if not eq or not dot or not section or not name:
            raise ValueError(
                f"malformed override {ov!r}; expected section.key=value"
            )
        if section == "summary" and name in _SUMMARY_KEYS:
            section, name = "train", _SUMMARY_KEYS[name]
        if not parser.has_section(section):
            parser.add_section(section)
        parser.set(section, name, value.strip())

    if parser.has_section("summary"):
        for name, raw in parser.items("summary"):
            tgt = _SUMMARY_KEYS.get(name)
            if tgt is None:
                log.warning("unknown key summary.%s ignored", name)
                continue
            if not parser.has_section("train"):
                parser.add_section("train")
            if not parser.has_option("train", tgt):
                parser.set("train", tgt, raw)
        parser.remove_section("summary")

    kwargs: Dict[str, object] = {}
    opt_kwargs: Dict[str, object] = {}
    for section in parser.sections():
        if section not in _SECTION_TYPES:
            log.warning("unknown config section [%s] ignored", section)
            continue
        cls = _SECTION_TYPES[section]
        fields = {f.name: f for f in dataclasses.fields(cls)}
        sec_kwargs = {}
        for name, raw in parser.items(section):
            if section == "train" and name in _TRAIN_OPTIMIZER_KEYS:
                opt_kwargs[name] = _coerce(_TRAIN_OPTIMIZER_KEYS[name], raw)
                continue
            if name not in fields:
                log.warning("unknown key %s.%s ignored", section, name)
                continue
            sec_kwargs[name] = _coerce(fields[name], raw)
        if section == "optimizer":
            opt_kwargs.update(sec_kwargs)
        else:
            kwargs[_SECTION_FIELD.get(section, section)] = cls(**sec_kwargs)
    if opt_kwargs:
        kwargs["optimizer"] = OptimizerConfig(**opt_kwargs)
    return YoloJaxConfig(**kwargs)
