"""TFLite export: the serving program as one flatbuffer for edge hosts.

Port of ``yolojax/serve/tflite.py``. The program is the TF graph of
``serve/tf_graph.py`` (forward, decode, top-K, class shift, the greedy
sweep as a ``while`` loop), converted with TFLite builtins only: every op
it uses is a builtin (``CONV_2D``, ``MAX_POOL_2D``, ``SPACE_TO_DEPTH``,
``TOPK_V2``, ``GATHER``, ``WHILE``, ...), so the file runs under a plain
interpreter with no Flex delegate, and an op that would need one fails the
conversion instead of the first call.

Two deliberate differences from yolojax, each a ``ValueError`` raised
before anything is written:

- ``mode="stablehlo"``: the port has no StableHLO program to embed (it
  writes TF ops, not ``jax2tf``'s serialization), and TensorFlow 2.21's
  converter refuses yolojax's op-set mix anyway ("StableHLO Ops set can not
  be specified with other Ops set together");
- an int8 spec: yolojax's int8 TFLite export fails to convert
  ("failed to legalize operation 'tfl.pad'"), and the int8 program's
  float64 products and ``nextafter`` are not builtins. The int8 program
  exports as a SavedModel.

Outputs are told apart by (dtype, rank), not by the converter's tensor
names: boxes f32 rank 3, scores f32 rank 2, classes int32, keep bool.
"""

from __future__ import annotations

import json
from typing import Any, Dict

META_SUFFIX = ".json"
MODES = ("graph", "stablehlo")


def _signature_outputs(out_details, batch, top_k):
    """Map TFLite output tensors to the serving dict keys by (dtype, rank).

    Returns {key: tensor_index}. Raises if the model does not expose
    exactly the serving quartet (a conversion that dropped or fused an
    output must fail loudly, not mis-assign)."""
    import numpy as np

    mapping = {}
    for d in out_details:
        dt, rank = np.dtype(d["dtype"]), len(d["shape"])
        if dt == np.float32 and rank == 3:
            key = "boxes"
        elif dt == np.float32 and rank == 2:
            key = "scores"
        elif dt in (np.int32, np.int64):
            key = "classes"
        elif dt == np.bool_:
            key = "keep"
        else:
            raise ValueError(
                f"unexpected TFLite output {d['name']} dtype={dt} "
                f"shape={d['shape']}")
        if key in mapping:
            raise ValueError(f"duplicate TFLite output for {key!r}")
        mapping[key] = d["index"]
    missing = {"boxes", "scores", "classes", "keep"} - set(mapping)
    if missing:
        raise ValueError(f"TFLite model is missing outputs: {sorted(missing)}")
    return mapping


def check_exportable(mode: str, int8: bool) -> None:
    """Raise ``ValueError`` for what the port does not export as TFLite:
    an unknown or ``stablehlo`` ``mode``, or an ``int8`` program."""
    if mode not in MODES:
        raise ValueError(f"unknown tflite conversion mode {mode!r}")
    if mode == "stablehlo":
        raise ValueError(
            "--tflite-mode stablehlo is not supported: the port writes its "
            "program as TF ops and has no StableHLO program to embed; use "
            "--tflite-mode graph")
    if int8:
        raise ValueError(
            "int8 TFLite export is not supported: the int8 program's float64 "
            "products are not TFLite builtins; export it with --format "
            "savedmodel, or export the f32 program as TFLite")


def save_tflite(path: str, spec: Dict[str, Any], *, batch: int, dim: int,
                meta: Dict[str, Any], score_thresh: float, iou_thresh: float,
                top_k: int, mode: str = "graph") -> Dict[str, Any]:
    """Write the program of ``spec`` (``tf_graph.export_spec``) as
    ``path`` (.tflite) plus a ``path + ".json"`` metadata sidecar (the
    artifact header, ``conversion`` and ``payload_bytes``)."""
    check_exportable(mode, bool(spec.get("int8")))
    import tensorflow as tf

    from yolojax_torch.serve.tf_graph import build_tf_program

    module = build_tf_program(spec, score_thresh=score_thresh,
                              iou_thresh=iou_thresh, top_k=top_k)
    cf = tf.function(module.__call__, autograph=False, input_signature=[
        tf.TensorSpec([batch, dim, dim, 3], tf.float32, name="images")
    ]).get_concrete_function()
    converter = tf.lite.TFLiteConverter.from_concrete_functions([cf], module)
    converter.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS]
    blob = converter.convert()
    with open(path, "wb") as f:
        f.write(blob)

    meta = dict(meta, batch=int(batch), dim=int(dim), format="tflite",
                conversion=mode, payload_bytes=len(blob))
    with open(path + META_SUFFIX, "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_tflite(path: str):
    """Load an exported .tflite; returns (meta, serve_fn) where
    ``serve_fn(images_f32)`` runs the flatbuffer under the TFLite
    interpreter and returns the serving dict as numpy arrays. For tests
    and CLI round trips: an edge host embeds the interpreter itself."""
    import numpy as np
    import tensorflow as tf

    with open(path + META_SUFFIX) as f:
        meta = json.load(f)
    interp = tf.lite.Interpreter(model_path=path)
    interp.allocate_tensors()
    (inp,) = interp.get_input_details()
    outs = _signature_outputs(interp.get_output_details(),
                              meta["batch"], meta.get("top_k"))

    def serve_fn(images):
        interp.set_tensor(inp["index"], np.asarray(images, np.float32))
        interp.invoke()
        return {k: interp.get_tensor(i) for k, i in outs.items()}

    return meta, serve_fn
