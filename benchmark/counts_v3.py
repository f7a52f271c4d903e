"""The yardstick's arithmetic for YOLOv3 configurations: ``counts.py``'s
walk for the layer kinds YOLOv3 adds (shortcut, upsample, yolo), the
FLOPs an image and the bytes of the bf16 eval epilogue.

FLOPs are Darknet's "BFLOPs", multiply-adds x 2 of every conv:
yolov3.cfg at 608 is 140.69 GFLOP an image, at 416 65.86. A conv that a
shortcut follows runs the residual epilogue
(``conv_epilogue_residual_kernel``): 2 B read, 2 B of the residual read
and 2 B written a value, 6 B; every other conv the plain epilogue
(``conv_epilogue_kernel``), 4 B a value. Peaks are ``counts.py``'s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.counts import HBM_BYTES_PER_S, PEAK_BF16  # noqa: F401


def walk(config: dict, dim: int) -> List[dict]:
    """Per layer: its output (h, w, c), and for a conv its FLOPs an image,
    its output values an image and whether a shortcut follows it."""
    layers = config["layers"]
    h = w = int(dim)
    c = 3
    out: List[dict] = []
    for i, layer in enumerate(layers):
        kind = layer["type"]
        row = {"type": kind}
        if kind == "conv":
            s, k = layer["stride"], layer["size"]
            h = (h + 2 * (k // 2) - k) // s + 1
            w = (w + 2 * (k // 2) - k) // s + 1
            row["flops"] = 2.0 * h * w * c * layer["filters"] * k * k
            c = layer["filters"]
            row["values"] = h * w * c
            row["residual"] = (i + 1 < len(layers)
                               and layers[i + 1]["type"] == "shortcut")
        elif kind == "upsample":
            h, w = h * layer["stride"], w * layer["stride"]
        elif kind == "route":
            srcs = [out[r if r >= 0 else i + r]["hwc"]
                    for r in layer["layers"]]
            h, w = srcs[0][0], srcs[0][1]
            c = sum(t[2] for t in srcs)
        elif kind not in ("shortcut", "yolo"):
            raise ValueError(f"layer {i}: unknown type {kind!r}")
        row["hwc"] = (h, w, c)
        out.append(row)
    return out


def convs(config: dict, dim: int) -> Dict[int, dict]:
    return {i: r for i, r in enumerate(walk(config, dim))
            if r["type"] == "conv"}


def flops_per_image(config: dict, dim: int) -> float:
    return sum(r["flops"] for r in convs(config, dim).values())


def epilogue_bytes(config: dict, dim: int, residual: bool
                   ) -> Tuple[float, int]:
    """(bytes an image, launches a batch) of the residual epilogue
    (``residual``: 6 B a value of each conv a shortcut follows) or of the
    plain one (4 B a value of every other conv)."""
    rows = [r for r in convs(config, dim).values()
            if r["residual"] == residual]
    per_value = 6.0 if residual else 4.0
    return per_value * sum(r["values"] for r in rows), len(rows)
