"""Post-training int8 quantization of the conv trunk (inference only).

Port of ``yolojax/quantize/ptq.py``, with its names. Scheme: symmetric
int8, per-output-channel weight scales, per-layer activation scales from a
calibration pass (abs-max or a percentile over a few batches). BN must be
folded first (``yolojax_torch.convert.fold``). Each conv or dense layer of
the trunk runs as an int8 x int8 -> int32 product (``quantize/int8_ops.py``:
im2col + ``torch._int_mm``) and one requant epilogue, dequant + bias +
leaky + requant to the next layer's int8 codes, which on the card is the
CUDA kernel of ``quantize/cuda_int8.py``. Max-pool and reorg run on int8
codes (positive scales keep their order); route dequantizes, concatenates
and requantizes at a fresh scale; the head (the last conv or dense) runs
in bf16 from its dequantized input.

The epilogue follows ``jax.jit(apply_int8)``, the graph yolojax serves,
not its eager arithmetic: XLA contracts the dequant and bias into one f32
FMA and divides by a baked scale as a multiply by its f32 reciprocal, and
so does the port, on the CPU and on the card. Its int8 codes equal
yolojax's bit for bit given the same :class:`QuantizedModel`
(``convert/interchange.py::quantized_from_jax`` carries one across);
calibration runs bf16 convs, so scales computed apart by the two packages
agree only within bf16 rounding.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from yolojax_torch.models import Model
from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
    Network,
    ReorgSpec,
    RouteSpec,
    _darknet_padding,
    conv2d,
    leaky_relu,
    max_pool,
    space_to_depth,
)
from yolojax_torch.nn.stem import NoOpSpec, StemSpec, pack_stem_kernel
from yolojax_torch.quantize.cuda_int8 import int8_requant_cuda
from yolojax_torch.quantize.int8_ops import (
    gemm_operand,
    int8_conv,
    int8_matmul,
    int8_max_pool,
    requant_codes,
)

class Int8Layer(NamedTuple):
    """What one int8 product and its epilogue need on the device: the
    GEMM's B^T (``int8_ops.gemm_operand``), the output width, and the
    epilogue's constants m = f32(in_scale) * w_scale, b and
    r = f32(1) / f32(scale)."""

    operand: torch.Tensor
    cout: int
    m: torch.Tensor
    b: torch.Tensor
    r: float


@dataclasses.dataclass(frozen=True)
class QuantizedModel:
    """A quantized network. ``qparams`` holds, per layer name, yolojax's
    arrays as tensors on one device: ``conv_<i>`` / ``dense_<i>`` ->
    ``w_q`` int8 (HWIO for a conv, (in, out) for a dense; HWIO's row-major
    flattening (k*k*Cin, Cout) is the product's B), ``w_scale`` and ``b``
    f32; the fused stem's ``conv_0`` -> ``wp_q`` (3, 3, 12, 4*Co) int8 and
    the scales and bias tiled four times; the head -> ``w`` f32 (OIHW for a
    conv, (out, in) for a dense) and ``b``. :meth:`to` moves it."""

    model: Model  # folded (bn=False everywhere)
    qparams: Dict[str, Dict[str, torch.Tensor]]
    act_scales: Tuple[float, ...]  # per-spec output scale (f32/qmax units)
    input_scale: float
    head_index: int  # spec index of the final conv/dense kept in bf16
    # Largest code magnitude: 127 for int8; 2^(b-1)-1 for a narrower grid
    # (codes still ship as int8 tensors).
    qmax: int = 127

    @property
    def device(self) -> torch.device:
        return next(iter(self.qparams[_pname(self.model, self.head_index)]
                         .values())).device

    def to(self, device) -> "QuantizedModel":
        return dataclasses.replace(self, qparams={
            name: {k: v.to(device) for k, v in lp.items()}
            for name, lp in self.qparams.items()})

    @functools.cached_property
    def layers(self) -> Dict[str, Int8Layer]:
        """The :class:`Int8Layer` of each int8 conv, dense and stem, made
        once (on the host, in f32) and kept on the device."""
        device = self.device
        out: Dict[str, Int8Layer] = {}
        in_scale = self.input_scale
        for i, spec in enumerate(self.model.specs):
            if isinstance(spec, StemSpec):
                lp = self.qparams["conv_0"]
                w = lp["wp_q"]
                out["conv_0"] = _int8_layer(
                    w.reshape(-1, w.shape[-1]), lp, in_scale,
                    self.act_scales[0], device)
                in_scale = self.act_scales[0]
            elif isinstance(spec, (ConvSpec, DenseSpec)):
                name = _pname(self.model, i)
                if i != self.head_index:
                    lp = self.qparams[name]
                    w = lp["w_q"]
                    out[name] = _int8_layer(
                        w.reshape(-1, w.shape[-1]), lp, in_scale,
                        self.act_scales[i], device)
                in_scale = self.act_scales[i]
            elif isinstance(spec, RouteSpec):
                in_scale = self.act_scales[i]
        return out


def _int8_layer(w2d: torch.Tensor, lp, in_scale: float, scale: float,
                device) -> Int8Layer:
    m = np.float32(in_scale) * lp["w_scale"].detach().cpu().numpy()
    return Int8Layer(gemm_operand(w2d.to(device)), w2d.shape[1],
                     torch.from_numpy(m).to(device),
                     lp["b"].to(device, torch.float32).contiguous(),
                     _reciprocal(scale))


def _reciprocal(scale: float) -> float:
    """f32(1) / f32(scale), an f32 value (see ``int8_ops.requant_codes``)."""
    return float(np.float32(1) / np.float32(scale))


def _quantizable_layers(model: Model) -> List[int]:
    return [i for i, s in enumerate(model.specs)
            if isinstance(s, (ConvSpec, DenseSpec))]


def _pname(model: Model, i: int) -> str:
    return (f"conv_{i}" if isinstance(model.specs[i], ConvSpec)
            else f"dense_{i}")


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _percentile(a: torch.Tensor, percentile: float) -> torch.Tensor:
    """``jnp.percentile(a, percentile)`` (linear interpolation between the
    two order statistics around q * (n - 1), in f32) of a flat f32 tensor.
    ``torch.quantile`` refuses inputs this large, so the two order
    statistics come from ``kthvalue``."""
    n = a.numel()
    q = np.float32(np.float32(percentile) / np.float32(100.0))
    pos = q * np.float32(n - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    lo, hi = min(max(lo, 0), n - 1), min(max(hi, 0), n - 1)
    w_hi = np.float32(pos - np.float32(np.floor(pos)))
    w_lo = np.float32(1) - w_hi
    v_lo = torch.kthvalue(a, lo + 1).values
    v_hi = v_lo if hi == lo else torch.kthvalue(a, hi + 1).values
    return v_lo * float(w_lo) + v_hi * float(w_hi)


def _ranges(specs, net: Network, imgs: torch.Tensor, percentile: float,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """The per-spec |activation| range of one chunk: convs and dense
    products in ``compute_dtype``, bias and leaky in f32, as yolojax's
    ``_ranges_fn`` walks them. [input range, spec 0, spec 1, ...]."""

    def _r(t: torch.Tensor) -> torch.Tensor:
        a = t.abs().float()
        if percentile >= 100.0:
            return a.max()
        return _percentile(a.reshape(-1), percentile)

    x = imgs.float()
    ranges = [_r(x)]
    outputs: List[torch.Tensor] = []
    for i, spec in enumerate(specs):
        if isinstance(spec, ConvSpec):
            layer = getattr(net, f"conv_{i}")
            y = conv2d(x, layer.w, spec.stride,
                       compute_dtype=compute_dtype).float() + layer.b.float()
            x = leaky_relu(y) if spec.act == "leaky" else y
        elif isinstance(spec, MaxPoolSpec):
            x = max_pool(x, spec.size, spec.stride)
        elif isinstance(spec, ReorgSpec):
            x = space_to_depth(x, spec.stride)
        elif isinstance(spec, RouteSpec):
            x = torch.cat([outputs[r if r >= 0 else i + r]
                           for r in spec.layers], dim=-1)
        elif isinstance(spec, FlattenSpec):
            x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
        elif isinstance(spec, DenseSpec):
            layer = getattr(net, f"dense_{i}")
            y = torch.nn.functional.linear(
                x.to(compute_dtype), layer.w.to(compute_dtype)).float()
            y = y + layer.b.float()
            x = leaky_relu(y) if spec.act == "leaky" else y
        elif isinstance(spec, DropoutSpec):
            pass
        else:
            raise NotImplementedError(f"int8 path: unsupported layer {spec}")
        outputs.append(x)
        ranges.append(_r(x))
    return torch.stack(ranges)


@torch.inference_mode()
def calibrate(
    model: Model,
    net: Network,
    images: torch.Tensor,
    *,
    compute_dtype: torch.dtype = torch.bfloat16,
    percentile: float = 100.0,
    chunk: int = 16,
    qmax: int = 127,
) -> Tuple[float, Tuple[float, ...]]:
    """Run a bf16 forward over calibration images (on their device, with
    ``net`` there too) recording each spec's output |activation| range.
    ``model`` must be BN-folded. Returns (input_scale, per-spec activation
    scales) with scale = max(range / qmax, 1e-8).

    ``percentile`` < 100 clips outliers: the scale covers that percentile
    of |activation|. The forward runs in ``chunk``-sized pieces and each
    range is the max over chunks. The clamp keeps an all-zero range
    (all-black frames) from dividing by zero in the requant."""
    n = images.shape[0]
    per_chunk = torch.stack([
        _ranges(model.specs, net, images[s:s + chunk], float(percentile),
                compute_dtype)
        for s in range(0, n, chunk)
    ]).cpu().numpy()
    ranges = per_chunk.max(axis=0)
    input_scale = max(float(ranges[0]) / qmax, 1e-8)
    return input_scale, tuple(max(float(r) / qmax, 1e-8) for r in ranges[1:])


def _jax_layout(layer, spec) -> np.ndarray:
    """A port weight as yolojax lays it out: conv OIHW -> HWIO, dense
    (out, in) -> (in, out)."""
    w = layer.w.detach().float().cpu()
    w = w.permute(2, 3, 1, 0) if isinstance(spec, ConvSpec) else w.t()
    return np.ascontiguousarray(w.numpy())


def quantize_model(
    model: Model,
    net: Network,
    calib_images: torch.Tensor,
    *,
    percentile: float = 100.0,
    bits: int = 8,
    device=None,
) -> QuantizedModel:
    """Quantize a BN-folded network (v2 conv trunk or v1 conv+dense
    stack). The last conv/dense (head) stays in bf16. Calibration runs on
    ``calib_images``' device (``net`` must be there); the result's tensors
    go to ``device`` (default: that device). ``bits`` < 8 coarsens the
    code grid to +-(2^(bits-1)-1) while still shipping int8 tensors. The
    weights are quantized with yolojax's numpy code."""
    if not 2 <= bits <= 8:
        raise ValueError(f"quant bits must be in [2, 8], got {bits}")
    device = (torch.device(device) if device is not None
              else calib_images.device)
    qmax = 2 ** (bits - 1) - 1
    q_idx = _quantizable_layers(model)
    head_index = q_idx[-1]
    input_scale, act_scales = calibrate(model, net, calib_images,
                                        percentile=percentile, qmax=qmax)
    qparams: Dict[str, Dict[str, torch.Tensor]] = {}
    for i in q_idx:
        name = _pname(model, i)
        layer = getattr(net, name)
        b = torch.from_numpy(layer.b.detach().float().cpu().numpy().copy())
        if i == head_index:
            qparams[name] = {"w": layer.w.detach().float().cpu().clone(),
                             "b": b}
            continue
        w = _jax_layout(layer, model.specs[i])
        # per-out-channel (conv: last axis; dense: out column) scales
        reduce_axes = tuple(range(w.ndim - 1))
        w_scale = np.maximum(np.abs(w).max(axis=reduce_axes), 1e-8) / qmax
        w_q = np.clip(np.round(w / w_scale), -qmax, qmax).astype(np.int8)
        qparams[name] = {
            "w_q": torch.from_numpy(w_q),
            "w_scale": torch.from_numpy(w_scale.astype(np.float32)),
            "b": b,
        }
    qm = QuantizedModel(model, qparams, act_scales, input_scale, head_index,
                        qmax)
    return qm.to(device)


def _requant(y: torch.Tensor, scale: float, qmax: int = 127) -> torch.Tensor:
    """yolojax's ``_requant`` as jitted XLA runs it: round(y * (1/scale))."""
    return requant_codes(y.float(), _reciprocal(scale), qmax)


def fuse_stem_int8(qm: QuantizedModel) -> QuantizedModel:
    """Fuse conv0 + the 2x2/2 max-pool of an int8-quantized model into one
    phase-packed conv (the int8 counterpart of ``nn/stem.py``). Bit-exact:
    the packed conv performs the same int8 x int8 -> int32 sums, and the
    requant-then-phase-max commutes with the unfused requant-then-pool
    because all four phases share conv0's activation scale.

    Returns ``qm`` unchanged when the opening pattern does not match (conv
    3x3 s1 leaky + pool 2x2 s2 + a conv, conv0 not the head)."""
    model = qm.model
    specs = model.specs
    if len(specs) < 3 or qm.head_index == 0:
        return qm
    c0, p1 = specs[0], specs[1]
    if not (isinstance(c0, ConvSpec) and c0.ksize == 3 and c0.stride == 1
            and c0.act == "leaky" and isinstance(p1, MaxPoolSpec)
            and p1.size == 2 and p1.stride == 2
            and isinstance(specs[2], ConvSpec)):
        return qm
    lp = qm.qparams["conv_0"]
    device = lp["w_q"].device
    wp_q = pack_stem_kernel(
        lp["w_q"].cpu().numpy().astype(np.float32)).astype(np.int8)
    new_qparams = dict(qm.qparams)
    new_qparams["conv_0"] = {
        "wp_q": torch.from_numpy(wp_q).to(device),
        "w_scale": lp["w_scale"].repeat(4),
        "b": lp["b"].repeat(4),
    }
    new_specs = (StemSpec(out=c0.out, impl="xla"),
                 NoOpSpec()) + tuple(specs[2:])
    return dataclasses.replace(
        qm,
        model=dataclasses.replace(model, specs=new_specs),
        qparams=new_qparams,
    )


def _head_input(x_q: torch.Tensor, in_scale: float) -> torch.Tensor:
    """The head's dequantized input, as yolojax forms it:
    (f32(codes) * in_scale) rounded to bf16."""
    return (x_q.float() * float(np.float32(in_scale))).to(torch.bfloat16)


@torch.inference_mode()
def apply_int8(qm: QuantizedModel, images: torch.Tensor, *,
               codes: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """int8 forward pass on the device of ``qm`` and ``images``.
    images (N, H, W, 3) float in [0, 1]. Returns the raw f32 head
    (N, H, W, A, 5+C) like ``Model.apply`` (v1: (N, F)).

    A 1x1 stride-1 conv is one (N*H*W, Cin) @ (Cin, Cout) product (its
    im2col is a view of its input), which is what yolojax's
    ``one_by_one="dot"`` computes, so the port has no such option.
    ``codes``: a list that receives each int8 tensor a requant produces,
    in order (the input, each conv, stem, route and dense of the trunk),
    for checks against yolojax."""
    model = qm.model
    layers = qm.layers
    record = codes.append if codes is not None else (lambda _: None)
    x_q = _requant(images, qm.input_scale, qm.qmax)
    record(x_q)
    in_scale = qm.input_scale
    outputs_q: List[Tuple[torch.Tensor, float]] = []  # (int8 tensor, scale)
    head = None
    for i, spec in enumerate(model.specs):
        if isinstance(spec, StemSpec):
            # fused conv0+pool: the packed int8 conv on the space-to-depth
            # grid, then the epilogue with the max over the four phases
            layer = layers["conv_0"]
            acc, shape = int8_conv(space_to_depth(x_q, 2),
                                   qm.qparams["conv_0"]["wp_q"], 1, (1, 1),
                                   (1, 1), operand=layer.operand)
            x_q = int8_requant_cuda(acc, layer.m, layer.b, layer.r, qm.qmax,
                                    True, phases=4).reshape(*shape, -1)
            record(x_q)
            in_scale = qm.act_scales[0]
        elif isinstance(spec, NoOpSpec):
            pass  # pool slot consumed by the stem; indices stay stable
        elif isinstance(spec, ConvSpec):
            name = f"conv_{i}"
            if i == qm.head_index:
                lp = qm.qparams[name]
                head = conv2d(_head_input(x_q, in_scale), lp["w"],
                              spec.stride, compute_dtype=torch.bfloat16
                              ).float() + lp["b"]
            else:
                layer = layers[name]
                k = qm.qparams[name]["w_q"].shape[0]
                acc, shape = int8_conv(
                    x_q, qm.qparams[name]["w_q"], spec.stride,
                    _darknet_padding(x_q.shape[1], k, spec.stride),
                    _darknet_padding(x_q.shape[2], k, spec.stride),
                    operand=layer.operand)
                x_q = int8_requant_cuda(
                    acc, layer.m, layer.b, layer.r, qm.qmax,
                    spec.act == "leaky").reshape(*shape, -1)
                record(x_q)
            in_scale = qm.act_scales[i]
        elif isinstance(spec, MaxPoolSpec):
            x_q = int8_max_pool(x_q, spec.size, spec.stride)
        elif isinstance(spec, ReorgSpec):
            x_q = space_to_depth(x_q, spec.stride)
        elif isinstance(spec, RouteSpec):
            parts = [outputs_q[r if r >= 0 else i + r] for r in spec.layers]
            f32 = torch.cat([p.float() * float(np.float32(s))
                             for p, s in parts], dim=-1)
            x_q = _requant(f32, qm.act_scales[i], qm.qmax)
            record(x_q)
            in_scale = qm.act_scales[i]
        elif isinstance(spec, FlattenSpec):
            x_q = x_q.permute(0, 3, 1, 2).reshape(x_q.shape[0], -1)
        elif isinstance(spec, DenseSpec):
            name = f"dense_{i}"
            if i == qm.head_index:
                lp = qm.qparams[name]
                head = torch.nn.functional.linear(
                    _head_input(x_q, in_scale),
                    lp["w"].to(torch.bfloat16)).float() + lp["b"]
            else:
                layer = layers[name]
                acc = int8_matmul(x_q, layer.operand, layer.cout)
                x_q = int8_requant_cuda(acc, layer.m, layer.b, layer.r,
                                        qm.qmax, spec.act == "leaky")
                record(x_q)
            in_scale = qm.act_scales[i]
        elif isinstance(spec, DropoutSpec):
            pass  # eval mode
        else:
            raise NotImplementedError(spec)
        outputs_q.append((x_q, in_scale))
    if model.kind == "v2":
        n, h, w, _ = head.shape
        return head.reshape(n, h, w, model.num_anchors, 5 + model.num_classes)
    return head
