"""Quantization-aware fine-tuning (QAT) for the int8 serving path.

Port of ``yolojax/quantize/qat.py``, with its names. Starting from trained,
BN-folded weights, the fine-tune inserts *fake-quant* ops at exactly the
points :func:`yolojax_torch.quantize.ptq.apply_int8` quantizes (the input,
every non-head conv/dense weight per output channel, every layer output
and route per layer), so the optimizer sees the deployment numerics;
straight-through estimators carry the gradients through the rounding.
Activation scales are frozen from a :func:`ptq.calibrate` pass; weight
scales follow the live ``max|w|`` each step, with no gradient through the
scale. :func:`reembed_folded` turns the tuned folded weights back into an
identity-BN network that every surface loads as an ``.npz``.

The arithmetic follows ``jax.jit`` of yolojax's functions on the CPU, not
its eager form (ROADMAP.md §3): XLA divides by a baked (Python float)
scale as a multiply by its f32 reciprocal, divides by a computed scale,
and contracts ``round(x / s) * s - x`` into one fused multiply-add. So a
float ``scale`` here is applied through ``f32(1) / f32(scale)``, a tensor
scale by division, and the product and difference are one exactly rounded
FMA (``int8_ops.fma_f32``, a float64 emulation run in chunks).

Everything runs in f32 (quantized values are exact small multiples of the
scale, which bf16 would corrupt): ``utils/device.py::full_f32`` turns TF32
off for the forward and backward of a step and restores the settings
afterwards.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from yolojax_torch.models import Model
from yolojax_torch.nn.layers import (
    ConvLayer,
    ConvSpec,
    DenseLayer,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
    Network,
    ReorgSpec,
    RouteSpec,
    conv2d,
    leaky_relu,
    max_pool,
    space_to_depth,
)
from yolojax_torch.quantize.int8_ops import fma_f32
from yolojax_torch.quantize.ptq import _quantizable_layers
from yolojax_torch.train.step import (
    Optimizer,
    OptimizerConfig,
    default_loss_cfg,
    global_norm,
    make_head_loss,
    prepare_images,
    step_seeds,
)
from yolojax_torch.utils.device import full_f32

# the FMA emulation's float64 temporaries are ~10 copies of what it
# rounds: take a layer's output this many values at a time
FMA_CHUNK = 1 << 25


def _grid_offset(c: torch.Tensor, scale: Union[float, torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """fma(c, scale, -x) rounded once to f32: a tensor scale broadcasts in
    one piece, a float one is taken :data:`FMA_CHUNK` values at a time."""
    if isinstance(scale, torch.Tensor):
        return fma_f32(c, scale, -x)
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    flat_c, flat_x, flat_out = (t.reshape(-1) for t in (c, x, out))
    for i in range(0, flat_out.numel(), FMA_CHUNK):
        flat_out[i:i + FMA_CHUNK] = fma_f32(flat_c[i:i + FMA_CHUNK], s,
                                            -flat_x[i:i + FMA_CHUNK])
    return out


def fake_quant(x: torch.Tensor, scale: Union[float, torch.Tensor],
               qmax: float = 127.0) -> torch.Tensor:
    """Quantize-dequantize onto the symmetric ``qmax``-code grid with a
    straight-through estimator: the value is ``x + (clip(round(x / scale),
    -qmax, qmax) * scale - x)`` (the last two operations one FMA), the
    gradient passes through as identity (also in the clipped tail).

    ``scale``: a Python float (a baked scale: ``x`` is multiplied by
    ``f32(1) / f32(scale)``) or a tensor broadcasting against ``x`` (a
    computed scale: ``x`` is divided by it); the scale takes no
    gradient."""
    if isinstance(scale, torch.Tensor):
        scale = scale.detach().float()
        t = x.detach() / scale
    else:
        scale = float(np.float32(scale))
        t = x.detach() * float(np.float32(1) / np.float32(scale))
    c = torch.clamp(torch.round(t), -float(qmax), float(qmax))
    return x + _grid_offset(c, scale, x.detach())


def weight_scale(w: torch.Tensor, qmax: float = 127.0) -> torch.Tensor:
    """Per-output-channel scale of a port kernel (conv OIHW, dense
    (out, in): the output is dim 0), the formula ``ptq.quantize_model``
    applies, shaped to broadcast against ``w``. The division by ``qmax``
    is the multiply by its f32 reciprocal that jitted XLA runs."""
    amax = w.detach().abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
    return (torch.clamp(amax, min=1e-8)
            * float(np.float32(1) / np.float32(qmax)))


def fake_quant_weight(w: torch.Tensor, qmax: float = 127.0) -> torch.Tensor:
    """Fake-quantize a conv/dense kernel per output channel, at the scale of
    the live weights (recomputed every call, no gradient through it): what
    :func:`fake_quant` computes for a tensor scale, with a cheaper exact
    FMA. The scale comes from max|w|, so |w| <= qmax * scale (to one
    rounding) and no code clips far: c * scale is exact in float64 (7 + 24
    bits) and so is its difference from w (both within a factor 2^10 of
    scale, on a grid of ulp(scale) / 4), so one rounding of the float64
    result to f32 is the FMA's rounding."""
    scale = weight_scale(w, qmax)
    wd = w.detach()
    c = torch.clamp(torch.round(wd / scale), -float(qmax), float(qmax))
    return w + (c.double() * scale.double() - wd.double()).float()


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each value with probability 1 - rate, drawn from ``generator``
    (not JAX's bits), and scale the kept ones by 1 / (1 - rate)."""
    if generator is None:
        raise ValueError("dropout in train mode needs a generator")
    keep = torch.rand(x.shape, generator=generator,
                      device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), device=x.device))


def qat_forward(
    model: Model,
    net: Network,
    images: torch.Tensor,
    input_scale: float,
    act_scales: Sequence[float],
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    qmax: float = 127.0,
    activations: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """Fake-quant forward of a BN-folded network, point for point as
    ``apply_int8`` quantizes, in f32 with TF32 off. Returns the head shaped
    like ``Model.apply`` (v2: (N, H, W, A, 5+C); v1: flat). Dropout in
    train mode draws from ``generator``. ``activations`` receives each
    fake-quantized layer output (the input, each conv, route and dense),
    in order, for checks against yolojax."""
    q_idx = _quantizable_layers(model)
    head_index = q_idx[-1]
    record = activations.append if activations is not None else (
        lambda _: None)
    with full_f32():
        x = fake_quant(images.float(), input_scale, qmax)
        record(x)
        outputs: List[torch.Tensor] = []
        head = None
        for i, spec in enumerate(model.specs):
            if isinstance(spec, ConvSpec):
                if spec.bn:
                    raise ValueError(
                        "qat_forward needs a BN-folded model (fold_bn "
                        f"first); spec {i} still has bn=True")
                layer = getattr(net, f"conv_{i}")
                w = layer.w.float()
                if i != head_index:
                    w = fake_quant_weight(w, qmax)
                y = conv2d(x, w, spec.stride, compute_dtype=torch.float32
                           ) + layer.b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y)
                if i == head_index:
                    head = y
                x = fake_quant(y, act_scales[i], qmax)
                record(x)
            elif isinstance(spec, MaxPoolSpec):
                # order-preserving on fake-quantized values, as the int8
                # path pools raw codes
                x = max_pool(x, spec.size, spec.stride)
            elif isinstance(spec, ReorgSpec):
                x = space_to_depth(x, spec.stride)
            elif isinstance(spec, RouteSpec):
                parts = [outputs[r if r >= 0 else i + r] for r in spec.layers]
                x = fake_quant(torch.cat(parts, dim=-1), act_scales[i], qmax)
                record(x)
            elif isinstance(spec, FlattenSpec):
                x = x.permute(0, 3, 1, 2).reshape(x.shape[0], -1)
            elif isinstance(spec, DenseSpec):
                layer = getattr(net, f"dense_{i}")
                w = layer.w.float()
                if i != head_index:
                    w = fake_quant_weight(w, qmax)
                y = torch.nn.functional.linear(x, w) + layer.b.float()
                if spec.act == "leaky":
                    y = leaky_relu(y)
                if i == head_index:
                    head = y
                x = fake_quant(y, act_scales[i], qmax)
                record(x)
            elif isinstance(spec, DropoutSpec):
                if train:
                    x = dropout(x, spec.rate, generator)
            else:
                raise NotImplementedError(f"qat path: unsupported layer {spec}")
            outputs.append(x)
    if model.kind == "v2":
        n, h, w_, _ = head.shape
        return head.reshape(n, h, w_, model.num_anchors,
                            5 + model.num_classes)
    return head


@dataclasses.dataclass
class QatState:
    """``step`` (steps taken), the folded network being tuned (its
    parameters are the trainables) and the optimizer state."""

    step: int
    net: Network
    opt_state: Dict[str, Any]

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.net.named_parameters())


def init_qat_state(net: Network, tx: Optimizer) -> QatState:
    net.requires_grad_(True)
    return QatState(0, net, tx.init(dict(net.named_parameters())))


def _apply(st: QatState, tx: Optimizer, loss: torch.Tensor,
           metrics: Dict[str, torch.Tensor], with_grads: bool):
    """Backward (TF32 off), the optimizer update in place, step + 1; the
    gradient dict under ``grads`` with ``with_grads``."""
    params = st.params()
    with full_f32():
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    with torch.no_grad():
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        updates, st.opt_state = tx.update(grads, st.opt_state, params)
        for k, p in params.items():
            p.add_(updates[k])
    if with_grads:
        metrics["grads"] = grads
    st.step += 1
    return st, metrics


def make_qat_step(
    model: Model,
    tx: Optimizer,
    input_scale: float,
    act_scales: Sequence[float],
    *,
    loss_cfg=None,
    aug_cfg=None,
    augment: bool = True,
    qmax: float = 127.0,
):
    """QAT fine-tune step ``fn(st, batch, seed, dim, with_grads=False) ->
    (st, metrics)`` over a folded model, on the batch's device. Same batch
    contract as ``train/step.py::make_train_step`` (canvas images + padded
    GT); the augmentation and dropout draw from generators seeded by
    ``step_seeds(seed, st.step)``, as the train step's do. ``metrics``: the
    loss terms, the raw gradients' ``grad_norm`` and, with ``with_grads``,
    the gradients under ``grads``."""
    from yolojax_torch.data.augment import AugmentConfig

    if loss_cfg is None:
        loss_cfg = default_loss_cfg(model)
    if aug_cfg is None:
        aug_cfg = AugmentConfig()
    act_scales = tuple(float(s) for s in act_scales)
    input_scale = float(input_scale)
    loss_from_head = make_head_loss(model, loss_cfg)

    def qat_step(st: QatState, batch, seed: int, dim: int,
                 with_grads: bool = False):
        images, gt_xywh, gt_class, gt_valid = batch
        device = images.device
        aug_seed, drop_seed = step_seeds(seed, st.step)
        images, gt_xywh, gt_valid = prepare_images(
            torch.Generator(device).manual_seed(aug_seed), images.float(),
            gt_xywh, gt_valid, dim, aug_cfg, augment)
        head = qat_forward(
            model, st.net, images, input_scale, act_scales, train=True,
            generator=torch.Generator(device).manual_seed(drop_seed),
            qmax=qmax)
        terms = loss_from_head(head, gt_xywh, gt_class, gt_valid)
        return _apply(st, tx, terms["total"], terms, with_grads)

    return qat_step


def make_qat_distill_step(
    model: Model,
    tx: Optimizer,
    input_scale: float,
    act_scales: Sequence[float],
    *,
    aug_cfg=None,
    augment: bool = True,
    qmax: float = 127.0,
):
    """Distillation-mode QAT step: minimize the MSE between the fake-quant
    head and the frozen f32 teacher's head on the same (augmented) batch.
    Returns ``fn(st, batch, teacher, seed, dim, with_grads=False) -> (st,
    metrics)`` with ``total``, ``distill_mse`` and ``grad_norm`` (and
    ``grads``, as :func:`make_qat_step`). ``teacher`` is a folded
    network whose tensors are not ``st.net``'s (a ``copy.deepcopy`` of it
    before the fine-tune starts, as ``cli/qat.py`` makes it)."""
    from yolojax_torch.data.augment import AugmentConfig

    if aug_cfg is None:
        aug_cfg = AugmentConfig()
    act_scales = tuple(float(s) for s in act_scales)
    input_scale = float(input_scale)

    def distill_step(st: QatState, batch, teacher: Network, seed: int,
                     dim: int, with_grads: bool = False):
        images, gt_xywh, _, gt_valid = batch
        device = images.device
        aug_seed, drop_seed = step_seeds(seed, st.step)
        images, _, _ = prepare_images(
            torch.Generator(device).manual_seed(aug_seed), images.float(),
            gt_xywh, gt_valid, dim, aug_cfg, augment)
        with torch.no_grad(), full_f32():
            target = teacher(images, compute_dtype=torch.float32)
        head = qat_forward(
            model, st.net, images, input_scale, act_scales, train=True,
            generator=torch.Generator(device).manual_seed(drop_seed),
            qmax=qmax)
        flat = head.reshape(head.shape[0], -1)
        loss = torch.mean((flat - target.reshape(flat.shape)) ** 2)
        return _apply(st, tx, loss, {"total": loss, "distill_mse": loss},
                      with_grads)

    return distill_step


def reembed_folded(registry_model: Model, folded: Network, *,
                   eps: float = 1e-5) -> Network:
    """Re-embed a BN-folded network as an unfolded one for
    ``registry_model`` (the ``bn=True`` spec list ``get_model`` returns),
    with identity BN: scale = 1, bias = b, mean = 0, var = 1 - eps, so that
    ``fold_bn`` and the eval-mode BN epilogue reproduce the folded (w, b)
    to within one f32 ulp. The result is a CPU network that
    ``save_network_npz`` writes as a standard ``.npz``."""
    layers = {}
    for i, spec in enumerate(registry_model.specs):
        name = f"conv_{i}"
        if isinstance(spec, ConvSpec) and hasattr(folded, name):
            src = getattr(folded, name)
            w = src.w.detach().float().cpu().clone()
            b = src.b.detach().float().cpu().clone()
            if spec.bn:
                out = w.shape[0]
                layers[name] = ConvLayer(
                    w, scale=torch.ones(out), bias=b, mean=torch.zeros(out),
                    # var + eps == 1.0 (to f32/f64 rounding) -> inv == 1
                    var=torch.full((out,), 1.0 - eps))
            else:
                layers[name] = ConvLayer(w, b=b)
        dname = f"dense_{i}"
        if hasattr(folded, dname):
            src = getattr(folded, dname)
            layers[dname] = DenseLayer(src.w.detach().float().cpu().clone(),
                                       src.b.detach().float().cpu().clone())
    return Network(registry_model.specs, layers)


@dataclasses.dataclass(frozen=True)
class QatConfig:
    """Fine-tune hyperparameters (flags of ``cli/qat.py``). Small LR, short
    horizon: QAT is a repair pass, not training."""

    steps: int = 200
    learning_rate: float = 1e-5
    grad_clip_norm: float = 1.0
    calib_batches: int = 1  # loader batches used for activation calibration


def make_qat_optimizer(cfg: QatConfig) -> Optimizer:
    """optax.chain(clip_by_global_norm, adam): the port's optax-equal
    optimizer with adam, the clip and no weight decay."""
    return Optimizer(OptimizerConfig(
        optimizer="adam", learning_rate=cfg.learning_rate,
        grad_clip_norm=cfg.grad_clip_norm, weight_decay=0.0))
