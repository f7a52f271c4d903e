"""The serving program as a TensorFlow graph, written from the port's
folded weights.

yolojax exports its portable serving build (``cli/detect.py::
build_serving(portable=True)``: f32 compute, the plain NMS sweep, exact
top-K) by tracing it with ``jax2tf``. The port writes the same program in
``tf`` ops directly, so the TF formats (``serve/savedmodel.py``,
``serve/tflite.py``) need no converter: the forward (or the int8 trunk),
decode, top-K, the class shift and the greedy sweep. The port's CUDA
kernels cannot live in a TF graph; this is a CPU program, as yolojax's
portable build is.

* :func:`export_spec` pulls what the graph needs out of a BN-folded
  network, or a :class:`~yolojax_torch.quantize.ptq.QuantizedModel`, as
  plain numpy (conv kernels HWIO, dense kernels (in, out)). It imports no
  TensorFlow.
* :func:`build_tf_program` turns a spec into a ``tf.Module`` whose
  ``__call__(images)`` returns ``{boxes f32 (B, K, 4), scores f32 (B, K),
  classes int32 (B, K), keep bool (B, K)}``, the dtypes of yolojax's
  signature. The weights are ``tf.Variable`` s the module tracks.

The arithmetic follows the port's CPU program op by op:

* convs pad explicitly with Darknet's padding and run ``VALID``
  (YOLOv1's strided convs pad asymmetrically, which ``SAME`` does not
  say); pools run ``SAME``, which splits the padding low/high as Darknet
  does and never takes a padded value;
* reorg is ``tf.nn.space_to_depth``, whose channel order
  ``nn/layers.py::space_to_depth`` copies;
* the int8 trunk carries its codes as integer-valued f32. A product is a
  float64 conv or matmul of the codes, exact below 2^53 (f32 is not: 127^2
  * 9 * 1024 > 2^24); the dequant epilogue is one f32 FMA, as XLA
  contracts ``acc * m + b``, emulated in float64 as
  ``quantize/int8_ops.py::fma_f32`` does; requant multiplies by the f32
  reciprocal of the scale and rounds half to even; the head runs from bf16
  inputs and weights to a bf16 output.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
    ReorgSpec,
    RouteSpec,
    _darknet_padding,
)
from yolojax_torch.nn.stem import NoOpSpec, StemSpec
from yolojax_torch.postprocess.nms import CLASS_OFFSET

LEAKY_ALPHA = 0.1


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _hwio(w: np.ndarray) -> np.ndarray:
    """A port conv kernel OIHW -> HWIO; a dense (out, in) -> (in, out)."""
    w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
    return np.ascontiguousarray(w, np.float32)


def export_spec(model, net=None, qm=None) -> Dict:
    """Everything the TF program needs, as plain numpy and Python values.

    ``model`` and ``net``: a BN-folded model and its network (``net`` is not
    read when ``qm`` is given; ``qm.model`` is used then). Each entry of
    ``layers`` is one spec: ``{"op": "conv", "stride", "act", "w" (HWIO
    f32), "b"}``, ``{"op": "dense", "act", "w" (in, out), "b"}``,
    ``{"op": "pool", "size", "stride"}``, ``{"op": "reorg", "stride"}``,
    ``{"op": "route", "layers"}`` (absolute indices; with ``qm`` also its
    requant's ``r``), ``{"op":
    "flatten"}`` or ``{"op": "identity"}``. With ``qm`` an int8 conv or
    dense holds ``w_q`` (int8, HWIO / (in, out)), the epilogue's ``m`` and
    ``b`` (f32) and ``r`` (the f32 reciprocal of its output scale); the
    fused int8 stem is ``{"op": "stem", ...}`` with the packed ``w_q``; the
    head (``"head": True``) keeps ``w`` and ``b`` in f32; and ``int8``
    holds the input scale, the per-spec activation scales and ``qmax``."""
    from yolojax_torch.quantize.ptq import _reciprocal

    if qm is not None:
        model = qm.model
    spec: Dict = {"kind": model.kind, "num_classes": int(model.num_classes)}
    if model.kind == "v2":
        spec["anchors"] = [[float(a) for a in pair] for pair in model.anchors]
    else:
        spec["grid"] = int(model.grid)
        spec["boxes_per_cell"] = int(model.boxes_per_cell)
    int8_layers = qm.layers if qm is not None else {}
    if qm is not None:
        spec["int8"] = {"input_scale": float(qm.input_scale),
                        "input_r": _reciprocal(qm.input_scale),
                        "act_scales": [float(s) for s in qm.act_scales],
                        "qmax": int(qm.qmax)}
    layers = []
    for i, s in enumerate(model.specs):
        if isinstance(s, StemSpec):
            if qm is None:
                raise ValueError("a fused bf16 stem has no TF form: export "
                                 "with detect.fuse_stem=off")
            lay = int8_layers["conv_0"]
            layers.append({"op": "stem", "w_q": _np(qm.qparams["conv_0"]["wp_q"]),
                           "m": _np(lay.m), "b": _np(lay.b), "r": lay.r})
        elif isinstance(s, (ConvSpec, DenseSpec)):
            name = f"{'conv' if isinstance(s, ConvSpec) else 'dense'}_{i}"
            entry = {"op": "conv" if isinstance(s, ConvSpec) else "dense",
                     "act": s.act}
            if isinstance(s, ConvSpec):
                if s.bn:
                    raise ValueError("export_spec needs a BN-folded model")
                entry["stride"] = int(s.stride)
            if qm is None:
                layer = getattr(net, name)
                entry.update(w=_hwio(_np(layer.w).astype(np.float32)),
                             b=_np(layer.b).astype(np.float32))
            elif i == qm.head_index:
                lp = qm.qparams[name]
                entry.update(head=True, w=_hwio(_np(lp["w"])),
                             b=_np(lp["b"]).astype(np.float32))
            else:
                lay = int8_layers[name]
                entry.update(w_q=_np(qm.qparams[name]["w_q"]), m=_np(lay.m),
                             b=_np(lay.b), r=lay.r)
            layers.append(entry)
        elif isinstance(s, MaxPoolSpec):
            layers.append({"op": "pool", "size": int(s.size),
                           "stride": int(s.stride)})
        elif isinstance(s, ReorgSpec):
            layers.append({"op": "reorg", "stride": int(s.stride)})
        elif isinstance(s, RouteSpec):
            entry = {"op": "route",
                     "layers": [r if r >= 0 else i + r for r in s.layers]}
            if qm is not None:
                entry["r"] = _reciprocal(qm.act_scales[i])
            layers.append(entry)
        elif isinstance(s, FlattenSpec):
            layers.append({"op": "flatten"})
        elif isinstance(s, (DropoutSpec, NoOpSpec)):
            layers.append({"op": "identity"})  # eval mode
        else:
            raise TypeError(f"unknown layer spec: {s!r}")
    spec["layers"] = layers
    return spec


def build_tf_program(spec: Dict, *, score_thresh: float, iou_thresh: float,
                     top_k: int):
    """The serving program of ``spec`` (:func:`export_spec`) as a
    ``tf.Module``: ``__call__(images (B, dim, dim, 3) f32 in [0, 1])`` ->
    ``{boxes, scores, classes, keep}``; ``head(images)`` -> the raw f32
    head, (B, H, W, A, 5+C) for v2, (B, S*S*(C+5B)) for v1. For an int8
    spec, ``head(images, codes=[])`` appends the codes of every requant in
    the order ``quantize/ptq.py::apply_int8(codes=)`` records them."""
    import tensorflow as tf

    int8: Optional[Dict] = spec.get("int8")

    def darknet_pad(x, k: int, stride: int):
        ph = _darknet_padding(int(x.shape[1]), k, stride)
        pw = _darknet_padding(int(x.shape[2]), k, stride)
        if not any(ph + pw):
            return x
        return tf.pad(x, [[0, 0], list(ph), list(pw), [0, 0]])

    def conv(x, w, stride: int):
        return tf.nn.conv2d(darknet_pad(x, int(w.shape[0]), stride), w,
                            strides=stride, padding="VALID")

    def leaky(y):
        return tf.where(y >= 0, y, tf.constant(LEAKY_ALPHA, y.dtype) * y)

    def fma_f32(a, m, b):
        """fmaf(a, m, b) for f32 tensors (``int8_ops.fma_f32``)."""
        p = tf.cast(a, tf.float64) * tf.cast(m, tf.float64)
        bd = tf.cast(b, tf.float64)
        s = p + bd
        bv = s - p
        e = (p - (s - bv)) + (bd - bv)
        t = tf.cast(s, tf.float32)
        up = tf.cast(t, tf.float64) > s
        inf = tf.fill(tf.shape(t), tf.constant(np.inf, tf.float32))
        hi = tf.where(up, t, tf.math.nextafter(t, inf))
        lo = tf.where(up, tf.math.nextafter(t, -inf), t)
        mid = (s - tf.cast(lo, tf.float64)) == (tf.cast(hi, tf.float64) - s)
        return tf.where(mid & (e != 0), tf.where(e > 0, hi, lo), t)

    def requant(y, r: float):
        q = tf.round(y * tf.constant(r, tf.float32))  # half to even
        return tf.clip_by_value(q, -float(int8["qmax"]), float(int8["qmax"]))

    def epilogue(acc64, layer, act: str):
        y = fma_f32(tf.cast(acc64, tf.float32), layer["m"], layer["b"])
        if act == "leaky":
            y = leaky(y)
        return requant(y, layer["r"])

    def bf16(x):
        return tf.cast(tf.cast(x, tf.bfloat16), tf.float32)

    class Program(tf.Module):
        def __init__(self):
            super().__init__(name="yolojax_torch_serving")
            # int8 codes stay int8 in the variables and are widened per call
            self.weights = [
                {k: tf.Variable(v, trainable=False, name=f"{k}_{i}")
                 for k, v in layer.items() if isinstance(v, np.ndarray)}
                for i, layer in enumerate(spec["layers"])]

        def head(self, images, codes=None):
            x = tf.convert_to_tensor(images, tf.float32)
            return (self._int8_head(x, [] if codes is None else codes)
                    if int8 is not None else self._f32_head(x))

        def _f32_head(self, x):
            outputs = []
            for layer, var in zip(spec["layers"], self.weights):
                op = layer["op"]
                if op in ("conv", "dense"):
                    y = (conv(x, var["w"], layer["stride"]) if op == "conv"
                         else tf.matmul(x, var["w"]))
                    y = y + var["b"]
                    x = leaky(y) if layer["act"] == "leaky" else y
                else:
                    x = self._shape_op(layer, x, outputs)
                outputs.append(x)
            return self._head_shape(x)

        def _int8_head(self, x, codes):
            scales = int8["act_scales"]
            x = requant(x, int8["input_r"])
            codes.append(x)
            in_scale = int8["input_scale"]
            outputs = []  # (codes, scale) of each spec
            for i, (layer, var) in enumerate(zip(spec["layers"], self.weights)):
                op = layer["op"]
                if op == "stem":
                    # the packed conv on the space-to-depth grid, then the
                    # max over the four phase groups of channels
                    acc = tf.nn.conv2d(
                        tf.pad(tf.cast(tf.nn.space_to_depth(x, 2), tf.float64),
                               [[0, 0], [1, 1], [1, 1], [0, 0]]),
                        tf.cast(var["w_q"], tf.float64), 1, "VALID")
                    q = epilogue(acc, layer, "leaky")
                    c = int(q.shape[-1]) // 4
                    x = tf.reduce_max(tf.reshape(
                        q, [-1] + q.shape[1:3].as_list() + [4, c]), axis=3)
                    codes.append(x)
                    in_scale = scales[i]
                elif op in ("conv", "dense") and layer.get("head"):
                    hx = bf16(x * tf.constant(in_scale, tf.float32))
                    w = bf16(var["w"])
                    y = (conv(hx, w, layer["stride"]) if op == "conv"
                         else tf.matmul(hx, w))
                    x = bf16(y) + var["b"]
                    in_scale = scales[i]
                elif op in ("conv", "dense"):
                    w = tf.cast(var["w_q"], tf.float64)
                    x64 = tf.cast(x, tf.float64)
                    acc = (conv(x64, w, layer["stride"]) if op == "conv"
                           else tf.matmul(x64, w))
                    x = epilogue(acc, layer, layer["act"])
                    codes.append(x)
                    in_scale = scales[i]
                elif op == "route":
                    x = requant(tf.concat(
                        [q * tf.constant(s, tf.float32)
                         for q, s in (outputs[r] for r in layer["layers"])],
                        axis=-1), layer["r"])
                    codes.append(x)
                    in_scale = scales[i]
                else:  # codes pool, reorg and flatten exactly as f32 values
                    x = self._shape_op(layer, x, [q for q, _ in outputs])
                outputs.append((x, in_scale))
            return self._head_shape(x)

        @staticmethod
        def _shape_op(layer, x, outputs):
            op = layer["op"]
            if op == "pool":
                return tf.nn.max_pool2d(x, layer["size"], layer["stride"],
                                        "SAME")
            if op == "reorg":
                return tf.nn.space_to_depth(x, layer["stride"])
            if op == "route":
                return tf.concat([outputs[r] for r in layer["layers"]], -1)
            if op == "flatten":
                return tf.reshape(tf.transpose(x, [0, 3, 1, 2]),
                                  [tf.shape(x)[0], -1])
            if op == "identity":
                return x
            raise ValueError(f"unknown op {op!r}")

        @staticmethod
        def _head_shape(x):
            if spec["kind"] != "v2":
                return x
            a = len(spec["anchors"])
            return tf.reshape(x, [-1] + x.shape[1:3].as_list()
                              + [a, 5 + spec["num_classes"]])

        def __call__(self, images):
            head = self.head(images)
            corners, scores = (_decode_v2 if spec["kind"] == "v2"
                               else _decode_v1)(head)
            return _run_nms(corners, scores)

    def _decode_v2(head):
        """``ops/boxes.py::decode_v2`` on (B, M, 5+C), M = H*W*A cells in
        (h, w, a) order; the grid offsets are constants."""
        _, h, w, a, _ = head.shape.as_list()
        t = tf.reshape(head, [-1, h * w * a, 5 + spec["num_classes"]])
        cell = np.arange(h * w * a) // a
        grid = np.stack([cell % w, cell // w], -1).astype(np.float32)
        scale = np.asarray([w, h], np.float32)
        anc = np.tile(np.asarray(spec["anchors"], np.float32), (h * w, 1))
        xy = (tf.sigmoid(t[..., 0:2]) + grid) / scale
        wh = tf.constant(anc) * tf.exp(t[..., 2:4]) / scale
        conf = tf.sigmoid(t[..., 4])
        probs = tf.nn.softmax(t[..., 5:], axis=-1)
        return _corners(xy, wh), conf[..., None] * probs

    def _decode_v1(flat):
        """``ops/boxes.py::decode_v1`` (sqrt-space w, h) on the flat head,
        as (B, M, 4) corners and (B, M, C) scores, M = S*S*B."""
        s, b, c = spec["grid"], spec["boxes_per_cell"], spec["num_classes"]
        probs = tf.reshape(flat[:, :s * s * c], [-1, s * s, 1, c])
        conf = tf.reshape(flat[:, s * s * c:s * s * (c + b)], [-1, s * s, b, 1])
        raw = tf.reshape(flat[:, s * s * (c + b):], [-1, s * s * b, 4])
        cell = np.arange(s * s * b) // b
        cxy = np.stack([cell % s, cell // s], -1).astype(np.float32)
        xy = (raw[..., 0:2] + cxy) / np.float32(s)
        wh = tf.square(raw[..., 2:4])
        return _corners(xy, wh), tf.reshape(conf * probs, [-1, s * s * b, c])

    def _corners(xy, wh):
        half = wh * 0.5
        return tf.stack([xy[..., 1] - half[..., 1], xy[..., 0] - half[..., 0],
                         xy[..., 1] + half[..., 1], xy[..., 0] + half[..., 0]],
                        axis=-1)

    def _run_nms(corners, scores):
        """Top-K candidates (ties: the lower index first, as ``lax.top_k``),
        the class shift, then the greedy sweep as a ``tf.while_loop``."""
        m, c = int(scores.shape[1]), int(scores.shape[2])
        k = min(top_k, m * c)
        top_scores, top_idx = tf.math.top_k(tf.reshape(scores, [-1, m * c]), k)
        classes = top_idx % c
        boxes = tf.gather(corners, top_idx // c, batch_dims=1)
        valid = top_scores > tf.constant(score_thresh, tf.float32)
        shifted = boxes + (tf.cast(classes, tf.float32) * CLASS_OFFSET)[..., None]
        overlap = _iou_matrix(shifted) > tf.constant(iou_thresh, tf.float32)
        idx = tf.range(k)

        def body(i, keep):
            earlier = (idx < i)[None, :] & keep
            sup = tf.reduce_any(earlier & tf.gather(overlap, i, axis=1), axis=1)
            new = tf.gather(valid, i, axis=1) & ~sup
            return i + 1, tf.where((idx == i)[None, :], new[:, None], keep)

        _, keep = tf.while_loop(lambda i, _: i < k, body,
                                (tf.constant(0), tf.zeros_like(valid)))
        return {"boxes": boxes, "scores": top_scores, "classes": classes,
                "keep": keep}

    def _iou_matrix(b):
        """``ops/boxes.py::iou_matrix`` of (B, K, 4) corners, same op order
        and the 1e-10 clamp."""
        y0, x0, y1, x1 = tf.unstack(b, axis=-1)
        area = tf.maximum(y1 - y0, 0.0) * tf.maximum(x1 - x0, 0.0)
        ih = tf.maximum(tf.minimum(y1[:, :, None], y1[:, None, :])
                        - tf.maximum(y0[:, :, None], y0[:, None, :]), 0.0)
        iw = tf.maximum(tf.minimum(x1[:, :, None], x1[:, None, :])
                        - tf.maximum(x0[:, :, None], x0[:, None, :]), 0.0)
        inter = ih * iw
        union = area[:, :, None] + area[:, None, :] - inter
        return inter / tf.maximum(union, 1e-10)

    return Program()
