"""Weights and train-state interchange with yolojax's pytrees.

yolojax keeps trainables and BN running statistics as two nested dicts of
arrays, ``params = {"conv_<i>": {"w" (HWIO), "b" | "scale", "bias"},
"dense_<i>": {"w" (in, out), "b"}}`` and ``state = {"conv_<i>": {"mean",
"var"}}``; the ``.npz`` store (``convert/store.py``) is that layout
flattened. The port holds the same numbers in a :class:`Network`, named
``conv_<i>.w`` etc., with conv kernels OIHW and dense kernels (out, in).
The functions here convert exactly (transposes only) in both directions. A
model with a fused stem (``nn/stem.py``) carries ``conv_0 = {"wp" (3, 3,
12, 4*Co) packed HWIO, "b"}`` in both layouts, and its ``NoOpSpec`` slot
carries nothing.

:func:`train_state_from_jax` carries a whole yolojax ``TrainState`` (step,
params, BN state and the optax state of any optimizer ``make_optimizer``
builds) into the port's train state, so a run started in yolojax resumes in
the port; :func:`train_state_to_jax` goes back to yolojax's layouts.
:func:`quantized_from_jax` carries a yolojax int8 ``QuantizedModel``
(scales, codes and the bf16 head) into the port's, so both packages run
from identical scales.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from yolojax_torch.nn.layers import (
    ConvLayer,
    ConvSpec,
    DenseLayer,
    DenseSpec,
    Network,
    StemLayer,
)
from yolojax_torch.nn.stem import StemSpec


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _arr(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _weight_layers(model):
    """(pytree name, spec) of each spec that holds weights."""
    for i, spec in enumerate(model.specs):
        if isinstance(spec, (StemSpec, ConvSpec)):
            yield f"conv_{i}", spec
        elif isinstance(spec, DenseSpec):
            yield f"dense_{i}", spec


def tensors_from_jax(model, tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A params-shaped yolojax pytree (params, or an optimizer buffer of
    the same shape) -> {port parameter name: tensor}, kernels transposed.
    Layers the tree does not hold are left out."""
    out = {}
    for name, spec in _weight_layers(model):
        for key, leaf in tree.get(name, {}).items():
            t = _tensor(leaf)
            if key == "w" and isinstance(spec, ConvSpec):
                t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
            elif key == "w" and isinstance(spec, DenseSpec):
                t = t.T.contiguous()
            out[f"{name}.{key}"] = t
    return out


def tensors_to_jax(model, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, Any]:
    """The inverse of :func:`tensors_from_jax`: a numpy pytree."""
    tree: Dict[str, Any] = {}
    specs = dict(_weight_layers(model))
    for full, t in tensors.items():
        name, key = full.split(".")
        if key == "w" and isinstance(specs[name], ConvSpec):
            t = t.permute(2, 3, 1, 0)  # OIHW -> HWIO
        elif key == "w" and isinstance(specs[name], DenseSpec):
            t = t.T
        tree.setdefault(name, {})[key] = _arr(t)
    return tree


def network_from_state_dict(model, sd: Dict[str, torch.Tensor]) -> Network:
    """A :class:`Network` for ``model`` from a ``Network.state_dict()``-
    named dict of tensors (parameters and BN buffers)."""
    layers = {}
    for name, spec in _weight_layers(model):
        if isinstance(spec, StemSpec):
            layers[name] = StemLayer(sd[f"{name}.wp"], sd[f"{name}.b"])
        elif isinstance(spec, ConvSpec) and spec.bn:
            layers[name] = ConvLayer(
                sd[f"{name}.w"], scale=sd[f"{name}.scale"],
                bias=sd[f"{name}.bias"], mean=sd[f"{name}.mean"],
                var=sd[f"{name}.var"])
        elif isinstance(spec, ConvSpec):
            layers[name] = ConvLayer(sd[f"{name}.w"], b=sd[f"{name}.b"])
        else:
            layers[name] = DenseLayer(sd[f"{name}.w"], sd[f"{name}.b"])
    return Network(model.specs, layers)


def _bn_from_jax(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {f"{name}.{key}": _tensor(v)
            for name, st in state.items() for key, v in st.items()}


def _bn_to_jax(tensors: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for full, t in tensors.items():
        name, key = full.split(".")
        tree.setdefault(name, {})[key] = _arr(t)
    return tree


def params_from_jax(model, params: Dict[str, Any],
                    state: Dict[str, Any]) -> Network:
    """yolojax (params, state) pytrees of arrays -> a CPU :class:`Network`."""
    return network_from_state_dict(
        model, {**tensors_from_jax(model, params), **_bn_from_jax(state)})


def params_to_jax(model, net: Network
                  ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The inverse of :func:`params_from_jax`: numpy (params, state)."""
    return (tensors_to_jax(model, dict(net.named_parameters())),
            _bn_to_jax(bn_buffers(net)))


def bn_buffers(net: Network) -> Dict[str, torch.Tensor]:
    """The BN running statistics of ``net``: {``conv_<i>.mean``/``.var``}."""
    return {k: v for k, v in net.named_buffers()
            if k.endswith((".mean", ".var"))}


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

# optax state fields that hold a params-shaped tree, by the port's key
_BUFFER_FIELDS = ("trace", "mu", "nu", "ema_params", "acc_grads")
_COUNT_FIELDS = ("mini_step", "gradient_step")


def _collect(node, found: Dict[str, Any]) -> None:
    """Walk an optax state (namedtuples, tuples, dicts) and record its
    fields by name; the first ``count`` is the optimizer's update count
    (the adam and schedule counts advance together)."""
    if hasattr(node, "_fields"):
        items = zip(node._fields, node)
    elif isinstance(node, dict):
        items = node.items()
    elif isinstance(node, (list, tuple)):
        for v in node:
            _collect(v, found)
        return
    else:
        return
    for key, value in items:
        if key in _BUFFER_FIELDS or key in _COUNT_FIELDS or key == "count":
            found.setdefault(key, value)
        if key not in _BUFFER_FIELDS:
            _collect(value, found)


def train_state_from_jax(model, jax_state, tx):
    """A yolojax ``TrainState`` (``step``, ``params``, ``bn_state``,
    ``opt_state``) whose optimizer was built from the same
    ``OptimizerConfig`` as ``tx`` -> the port's
    :class:`~yolojax_torch.train.step.TrainState` on the CPU."""
    from yolojax_torch.train.step import TrainState

    net = params_from_jax(model, jax_state.params, jax_state.bn_state)
    opt = tx.init(dict(net.named_parameters()))
    found: Dict[str, Any] = {}
    _collect(jax_state.opt_state, found)
    for key in opt:
        if key in _BUFFER_FIELDS:
            opt[key] = tensors_from_jax(model, found[key])
        elif key == "count":
            opt[key] = int(np.asarray(found.get("count", 0)))
        else:
            opt[key] = int(np.asarray(found[key]))
    return TrainState(int(np.asarray(jax_state.step)), net, opt)


def train_state_to_jax(model, ts) -> Dict[str, Any]:
    """The port's train state in yolojax's layouts: a dict with ``step``,
    ``params``, ``bn_state`` and ``opt_state`` (the port's keys, each
    params-shaped buffer as a yolojax pytree)."""
    params, bn_state = params_to_jax(model, ts.net)
    opt = {key: (tensors_to_jax(model, v) if key in _BUFFER_FIELDS else v)
           for key, v in ts.opt_state.items()}
    return {"step": ts.step, "params": params, "bn_state": bn_state,
            "opt_state": opt}


# ---------------------------------------------------------------------------
# int8 quantized model
# ---------------------------------------------------------------------------


def quantized_from_jax(model, qm):
    """A yolojax ``QuantizedModel`` (numpy or jax arrays) -> the port's
    :class:`~yolojax_torch.quantize.ptq.QuantizedModel` on the CPU.
    ``model`` is the port's BN-folded model with yolojax's ``qm.model``
    specs; when ``qm`` carries the fused int8 stem (``conv_0`` holds
    ``wp_q``), the stem's specs replace the first two, as
    ``fuse_stem_int8`` places them. int8 kernels keep their layouts (HWIO,
    whose row-major flattening is the port's GEMM B, and (in, out)); the
    bf16 head's kernel goes to the port's (OIHW, or (out, in))."""
    import dataclasses

    from yolojax_torch.nn.stem import NoOpSpec
    from yolojax_torch.quantize.ptq import QuantizedModel

    qparams = {}
    for name, lp in qm.qparams.items():
        out = {k: _tensor(v) for k, v in lp.items()}
        if "w" in out:  # the head, kept in bf16
            w = out["w"]
            out["w"] = (w.permute(3, 2, 0, 1) if w.dim() == 4 else w.T
                        ).contiguous()
        qparams[name] = out
    if "wp_q" in qparams.get("conv_0", {}):
        c0 = model.specs[0]
        model = dataclasses.replace(model, specs=(
            StemSpec(out=c0.out, impl="xla"), NoOpSpec()) + tuple(
                model.specs[2:]))
    return QuantizedModel(model, qparams,
                          tuple(float(s) for s in qm.act_scales),
                          float(qm.input_scale), int(qm.head_index),
                          int(qm.qmax))
