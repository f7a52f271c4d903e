"""Layered INI config, the dialect of ``yolojax/config/__init__.py``.

``-c`` takes several files (later override earlier) and ``section.key=value``
overrides beat both. The port parses the sections its entry points read,
``[model]``, ``[cache]``, ``[detect]`` and ``[eval]``, into typed
dataclasses. The other sections of the shared dialect (``[queue]``,
``[data_augmentation]``, ``[train]``, ``[optimizer]``, ``[summary]``) are
accepted and kept as raw strings in :attr:`YoloJaxConfig.unparsed` until the
slices that read them port their dataclasses, so every ``config/*.ini``
loads unchanged. Unknown sections and keys warn instead of failing.
"""

from __future__ import annotations

import configparser
import dataclasses
import logging
import os
from typing import Dict, List, Mapping, Sequence, Tuple

log = logging.getLogger(__name__)

# copy of yolojax.data.cache.VOC_NAMES (the names() fallback)
VOC_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model: str = "yolo2"           # yolo | yolo2
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
class DetectConfig:
    threshold: float = 0.3
    nms_iou: float = 0.4
    top_k: int = 256
    use_pallas: str = "auto"       # auto|always: CUDA kernel; never: plain
    candidates: str = "auto"       # top-k select: auto|exact|approx (exact)
    stretch: bool = False          # plain resize instead of letterbox
    use_int8: bool = False         # int8 conv trunk (not ported yet)
    use_ema: bool = False          # Orbax EMA weights (not ported yet)
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
    data_parallel: str = "auto"    # auto|on|off; only one device is ported
    distributed: bool = False      # multi-host eval (not ported yet)

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
    detect: DetectConfig = DetectConfig()
    eval: EvalConfig = EvalConfig()
    # sections accepted but not parsed yet: {section: {key: raw value}}
    unparsed: Mapping[str, Mapping[str, str]] = dataclasses.field(
        default_factory=dict)

    def names(self) -> Tuple[str, ...]:
        if self.model.names_file and os.path.exists(self.model.names_file):
            with open(self.model.names_file) as f:
                return tuple(l.strip() for l in f if l.strip())
        return VOC_NAMES[: self.model.num_classes]

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
    "detect": DetectConfig,
    "eval": EvalConfig,
}
_UNPARSED_SECTIONS = ("queue", "data_augmentation", "train", "optimizer",
                      "summary")


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
        if not parser.has_section(section):
            parser.add_section(section)
        parser.set(section, name, value.strip())

    kwargs: Dict[str, object] = {}
    unparsed: Dict[str, Dict[str, str]] = {}
    for section in parser.sections():
        if section in _UNPARSED_SECTIONS:
            unparsed[section] = dict(parser.items(section))
            continue
        if section not in _SECTION_TYPES:
            log.warning("unknown config section [%s] ignored", section)
            continue
        cls = _SECTION_TYPES[section]
        fields = {f.name: f for f in dataclasses.fields(cls)}
        sec_kwargs = {}
        for name, raw in parser.items(section):
            if name not in fields:
                log.warning("unknown key %s.%s ignored", section, name)
                continue
            sec_kwargs[name] = _coerce(fields[name], raw)
        kwargs[section] = cls(**sec_kwargs)
    return YoloJaxConfig(unparsed=unparsed, **kwargs)
