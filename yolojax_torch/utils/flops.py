"""Analytic FLOP counter for the spec-list models, and MFU against the
H100's peaks (port of ``yolojax/utils/flops.py``).

Walks the layer specs the forward executes with a shape simulator and
counts multiply-add FLOPs (2 x MACs, Darknet's "BFLOPs" convention:
Darknet-19 at 416 counts ~29.4 GFLOP an image). Elementwise work (BN,
leaky, pools, reorg) is left out, as Darknet leaves it out. Call it on the
unfused model: the walk does not know the fused stem's specs.

The peaks are the H100 SXM5's dense tensor-core rates from NVIDIA's data
sheet (bf16, int8, TF32) and its f32 rate outside the tensor cores. The
int8 trunk's MFU counts the bf16 head's FLOPs at the bf16 peak
(:func:`int8_mfu`); yolojax counts the whole int8 model at its int8 peak.
"""

from __future__ import annotations

from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
    ReorgSpec,
    RouteSpec,
)

# H100 SXM5 peaks, dense (NVIDIA H100 data sheet), operations per second
PEAK_BF16 = 989.4e12
PEAK_INT8 = 1978.9e12
PEAK_TF32 = 494.7e12
PEAK_F32 = 66.9e12


def _layer_flops(model, input_dim: int) -> list:
    """FLOPs of each spec, in order (0 for specs without a product)."""
    h = w = int(input_dim)
    c = 3
    outputs = []  # (h, w, c) per spec index, for routes
    per_spec = []
    flat = None
    for spec in model.specs:
        flops = 0.0
        if isinstance(spec, ConvSpec):
            h = -(-h // spec.stride)
            w = -(-w // spec.stride)
            flops = 2.0 * h * w * c * spec.out * spec.ksize * spec.ksize
            c = spec.out
        elif isinstance(spec, MaxPoolSpec):
            if spec.stride > 1:
                h //= spec.stride
                w //= spec.stride
        elif isinstance(spec, ReorgSpec):
            s = spec.stride
            h //= s
            w //= s
            c *= s * s
        elif isinstance(spec, RouteSpec):
            srcs = [outputs[i if i >= 0 else len(outputs) + i]
                    for i in spec.layers]
            h, w = srcs[0][0], srcs[0][1]
            c = sum(s[2] for s in srcs)
        elif isinstance(spec, FlattenSpec):
            flat = h * w * c
        elif isinstance(spec, DenseSpec):
            flops = 2.0 * (flat if flat is not None else c) * spec.out
            flat = spec.out
        elif not isinstance(spec, DropoutSpec):
            raise TypeError(f"no FLOP count for {spec!r}: pass the unfused "
                            "model")
        per_spec.append(flops)
        outputs.append((h, w, c))
    return per_spec


def model_flops_per_image(model, input_dim: int) -> float:
    """Forward-pass FLOPs (2 x MACs) for one image at ``input_dim``."""
    return sum(_layer_flops(model, input_dim))


def train_flops_per_image(model, input_dim: int) -> float:
    """Training-step FLOPs: forward + backward ~= 3x forward (activation
    gradients and weight gradients each cost about one forward)."""
    return 3.0 * model_flops_per_image(model, input_dim)


def mfu(images_per_sec: float, flops_per_image: float,
        peak: float = PEAK_BF16) -> float:
    """Model FLOPs utilization: achieved FLOP rate / peak."""
    return images_per_sec * flops_per_image / peak


def int8_mfu(images_per_sec: float, model, input_dim: int) -> float:
    """MFU of the int8 trunk with its bf16 head (the last conv): the
    seconds an image needs at the two peaks, trunk at int8 and head at
    bf16, over the seconds it took."""
    per_spec = _layer_flops(model, input_dim)
    head = max(i for i, s in enumerate(model.specs)
               if isinstance(s, (ConvSpec, DenseSpec)))
    ideal = ((sum(per_spec) - per_spec[head]) / PEAK_INT8
             + per_spec[head] / PEAK_BF16)
    return images_per_sec * ideal
