"""The yardstick's arithmetic: operations an image, bytes a kernel must
move, and the card's peaks, all from a configuration's layer list.

The FLOP walk is a frozen copy of the port's ``utils/flops.py``
(multiply-adds x 2 of every conv, Darknet's "BFLOPs": Darknet-19 at 416
is 29.36 GFLOP an image, Tiny-YOLOv2 6.97), kept here so that a change to
the program cannot move the yardstick. Byte counts read each input byte
once and write each output byte once, whatever a kernel re-reads.

Peaks: NVIDIA H100 SXM5 data sheet, dense: bf16 989.4 TFLOP/s, int8
1978.9 TOP/s, HBM3 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_BF16 = 989.4e12
PEAK_INT8 = 1978.9e12
HBM_BYTES_PER_S = 3.35e12


def walk(config: dict, dim: int) -> List[dict]:
    """Per layer: its output (h, w, c), and for a conv its FLOPs an image
    and its output values an image."""
    h = w = int(dim)
    c = 3
    out: List[dict] = []
    for i, layer in enumerate(config["layers"]):
        kind = layer["type"]
        row = {"type": kind}
        if kind == "conv":
            s, k = layer["stride"], layer["size"]
            h, w = -(-h // s), -(-w // s)
            row["flops"] = 2.0 * h * w * c * layer["filters"] * k * k
            c = layer["filters"]
            row["values"] = h * w * c
        elif kind == "maxpool":
            h = (h - 1) // layer["stride"] + 1
            w = (w - 1) // layer["stride"] + 1
        elif kind == "reorg":
            s = layer["stride"]
            h, w, c = h // s, w // s, c * s * s
        elif kind == "route":
            srcs = [out[r if r >= 0 else i + r]["hwc"] for r in layer["layers"]]
            h, w = srcs[0][0], srcs[0][1]
            c = sum(t[2] for t in srcs)
        row["hwc"] = (h, w, c)
        out.append(row)
    return out


def convs(config: dict, dim: int) -> Dict[int, dict]:
    return {i: r for i, r in enumerate(walk(config, dim))
            if r["type"] == "conv"}


def flops_per_image(config: dict, dim: int) -> float:
    return sum(r["flops"] for r in convs(config, dim).values())


def int8_seconds_per_image(config: dict, dim: int) -> float:
    """The least time an image takes on the int8 program: the trunk's
    FLOPs at the int8 peak, the bf16 head's at the bf16 peak."""
    rows = convs(config, dim)
    head = max(rows)
    trunk = sum(r["flops"] for i, r in rows.items() if i != head)
    return trunk / PEAK_INT8 + rows[head]["flops"] / PEAK_BF16


def stem_fusable(config: dict) -> bool:
    """conv 3x3/1 then a 2x2/2 maxpool: what the fused stem replaces."""
    l0, l1 = config["layers"][:2]
    return (l0["type"] == "conv" and l0["size"] == 3 and l0["stride"] == 1
            and l1["type"] == "maxpool" and l1["size"] == 2
            and l1["stride"] == 2)


def conv_epilogue_bytes(config: dict, dim: int, fused_stem: bool) -> tuple:
    """(bytes an image, launches a batch) of the bf16 eval epilogue: 2 B
    read and 2 B written a conv output value, every conv but a fused
    stem's."""
    rows = convs(config, dim)
    skip = {0} if fused_stem and stem_fusable(config) else set()
    layers = [i for i in rows if i not in skip]
    return sum(4.0 * rows[i]["values"] for i in layers), len(layers)


def int8_requant_bytes(config: dict, dim: int, fused_stem: bool) -> tuple:
    """(bytes an image, launches a batch) of the int8 requant: 4 B read an
    int32 sum, 1 B written a code, every conv but the head. A fused stem
    reads the sums of its four pool phases and writes one code for
    them."""
    rows = convs(config, dim)
    head = max(rows)
    total = 0.0
    for i, r in rows.items():
        if i == head:
            continue
        if i == 0 and fused_stem and stem_fusable(config):
            codes = r["values"] / 4
            total += 4.0 * 4 * codes + codes
        else:
            total += 5.0 * r["values"]
    return total, len(rows) - 1


def bn_train_bytes(config: dict, dim: int) -> tuple:
    """(bytes an image, launches a step) of the bf16 train step's
    epilogue kernels: the batch statistics (two passes of 2 B a value, BN
    convs), ``conv_epilogue`` (2 B in, 2 B out), the backward's sums (g
    and y, 4 B) and its dy (g and y read, dy written, 6 B), every conv.
    Each sum launch is a ``channel_sums_kernel`` and a
    ``finalize_kernel``."""
    rows = convs(config, dim)
    bn = [i for i in rows if config["layers"][i]["bn"]]
    values = sum(r["values"] for r in rows.values())
    bn_values = sum(rows[i]["values"] for i in bn)
    total = 2 * 2.0 * bn_values + 4.0 * values + 4.0 * values + 6.0 * values
    sums = 2 * len(bn) + len(rows)
    return total, 2 * sums + 2 * len(rows)
