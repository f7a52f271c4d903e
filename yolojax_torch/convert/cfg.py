"""Darknet ``.cfg`` parser: build a port :class:`Model` from an official cfg
file (port of ``yolojax/convert/cfg.py``).

Supported sections: [net] [convolutional] [maxpool] [route] [reorg]
[connected] [dropout] [region] (v2 head metadata) [detection] (v1 head
metadata). [local] / [crop] (early v1 variants) and [softmax] / [cost] are
refused with a clear error.

Layer indexing: Darknet numbers layers without [net]; [region] and
[detection] are head metadata, not layers. Each Darknet layer maps to one
spec, except the first [connected], which inserts a ``FlattenSpec`` before
it (Darknet flattens implicitly); route targets are remapped to absolute
spec indices through that shift.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
    ReorgSpec,
    RouteSpec,
)


def parse_cfg_sections(path: str) -> List[Tuple[str, Dict[str, str]]]:
    """Darknet cfg -> ordered [(section, {key: value})]. Repeated sections
    stay separate (configparser cannot do this, hence a hand parser)."""
    sections: List[Tuple[str, Dict[str, str]]] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].split(";", 1)[0].strip()
            if not line:
                continue
            if line.startswith("[") and line.endswith("]"):
                sections.append((line[1:-1].strip().lower(), {}))
            elif "=" in line and sections:
                k, v = line.split("=", 1)
                sections[-1][1][k.strip()] = v.strip()
            # stray tokens outside a section are ignored (darknet does too)
    return sections


def _floats(s: str) -> Tuple[float, ...]:
    return tuple(float(x) for x in s.replace(",", " ").split())


def model_from_cfg(path: str):
    """Parse a Darknet cfg into a :class:`yolojax_torch.models.Model`."""
    from yolojax_torch.models import Model

    sections = parse_cfg_sections(path)
    if not sections or sections[0][0] not in ("net", "network"):
        raise ValueError(f"{path}: cfg must start with a [net] section")
    net = sections[0][1]
    dim = int(net.get("height", net.get("width", 416)))

    specs: List[Any] = []
    dk_to_spec: List[int] = []  # darknet layer index -> spec index
    head: Optional[Dict[str, str]] = None
    kind = None
    flattened = False

    for name, opts in sections[1:]:
        if name == "convolutional":
            bn = opts.get("batch_normalize", "0") == "1"
            act = opts.get("activation", "logistic")
            if act not in ("leaky", "linear"):
                raise ValueError(f"unsupported activation {act!r} in {path}")
            size = int(opts.get("size", 1))
            if opts.get("pad", "0") != "1" and size != 1:
                # darknet pad=0 means an explicit `padding=` (rare); only the
                # standard pad = size // 2 arithmetic is supported
                if int(opts.get("padding", 0)) != size // 2:
                    raise ValueError(
                        f"unsupported conv padding in {path}: size={size} "
                        f"pad={opts.get('pad')} padding={opts.get('padding')}")
            dk_to_spec.append(len(specs))
            specs.append(ConvSpec(int(opts["filters"]), size,
                                  stride=int(opts.get("stride", 1)),
                                  bn=bn, act=act))
        elif name == "maxpool":
            dk_to_spec.append(len(specs))
            specs.append(MaxPoolSpec(int(opts.get("size", 2)),
                                     int(opts.get("stride", 2))))
        elif name == "route":
            here = len(dk_to_spec)  # this route's darknet index
            refs = []
            for tok in opts["layers"].split(","):
                r = int(tok)
                refs.append(dk_to_spec[r if r >= 0 else here + r])
            dk_to_spec.append(len(specs))
            specs.append(RouteSpec(tuple(refs)))
        elif name == "reorg":
            dk_to_spec.append(len(specs))
            specs.append(ReorgSpec(int(opts.get("stride", 2))))
        elif name == "connected":
            if not flattened:
                specs.append(FlattenSpec())  # darknet flattens implicitly
                flattened = True
            act = opts.get("activation", "linear")
            if act in ("ramp", "logistic"):
                raise ValueError(f"unsupported dense activation {act!r}")
            dk_to_spec.append(len(specs))
            specs.append(DenseSpec(int(opts["output"]),
                                   act="leaky" if act == "leaky" else "linear"))
        elif name == "dropout":
            dk_to_spec.append(len(specs))
            specs.append(DropoutSpec(float(opts.get("probability", 0.5))))
        elif name == "region":  # v2 head metadata
            head, kind = opts, "v2"
        elif name == "detection":  # v1 head metadata
            head, kind = opts, "v1"
        elif name in ("local", "crop", "softmax", "cost"):
            raise ValueError(
                f"[{name}] layers are not supported (early-v1 variants); "
                f"use the standard yolo cfg")
        else:
            raise ValueError(f"unknown cfg section [{name}] in {path}")

    if kind == "v2":
        anchors = _floats(head.get("anchors", ""))
        num = int(head.get("num", len(anchors) // 2 or 5))
        classes = int(head.get("classes", 20))
        if len(anchors) < 2 * num:
            raise ValueError(
                f"[region] num={num} needs {2 * num} anchor values but the "
                f"anchors line has {len(anchors)} in {path}")
        pairs = tuple((anchors[2 * i], anchors[2 * i + 1])
                      for i in range(num))
        return Model("yolo2", "cfg", "v2", tuple(specs), classes,
                     _downsample(specs), anchors=pairs)
    if kind == "v1":
        classes = int(head.get("classes", 20))
        side = int(head.get("side", 7))
        num = int(head.get("num", 2))
        return Model("yolo", "cfg", "v1", tuple(specs), classes,
                     dim // side, boxes_per_cell=num, grid=side)
    raise ValueError(f"{path}: no [region] or [detection] head section")


def _downsample(specs) -> int:
    """The trunk's stride product, up to the first route (the reorg branch
    rejoins at 1/32)."""
    d = 1
    for s in specs:
        if isinstance(s, (ConvSpec, MaxPoolSpec)) and s.stride > 1:
            d *= s.stride
        if isinstance(s, RouteSpec):
            break
    return d
