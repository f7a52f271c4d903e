"""TF SavedModel export: the serving program for TF Serving hosts.

Port of ``yolojax/serve/savedmodel.py``. yolojax traces its portable
serving build with ``jax2tf``; the port writes the same program in TF ops
from its own folded weights (``serve/tf_graph.py``), so a TF host serves
it with neither package installed. The ``serving_default`` signature takes
an f32 ``images`` canvas batch of the fixed export shape and returns
``{boxes, scores, classes, keep}`` with yolojax's dtypes;
``class_names()`` returns the label list; ``yolojax_meta.json`` in the
SavedModel directory carries the artifact header. The weights are
variables of the module, so they land in ``variables/`` and
``saved_model.pb`` stays small.

The format is plain TF: yolojax's ``load_savedmodel`` serves the port's
export and :func:`load_savedmodel` serves yolojax's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

META_FILENAME = "yolojax_meta.json"


def save_savedmodel(path: str, spec: Dict[str, Any], *, batch: int, dim: int,
                    meta: Dict[str, Any], score_thresh: float,
                    iou_thresh: float, top_k: int) -> Dict[str, Any]:
    """Write the program of ``spec`` (``tf_graph.export_spec``) as a TF
    SavedModel at ``path`` for a fixed ``(batch, dim, dim, 3)`` input.
    Returns the final metadata (also written to
    ``<path>/yolojax_meta.json``)."""
    import tensorflow as tf

    from yolojax_torch.serve.tf_graph import build_tf_program

    module = build_tf_program(spec, score_thresh=score_thresh,
                              iou_thresh=iou_thresh, top_k=top_k)
    names_t = tf.constant([str(n) for n in meta.get("names", [])],
                          dtype=tf.string)

    @tf.function(autograph=False, input_signature=[
        tf.TensorSpec([batch, dim, dim, 3], tf.float32, name="images")])
    def serve(images):
        return {k: tf.identity(v, name=k) for k, v in module(images).items()}

    @tf.function(autograph=False, input_signature=[])
    def class_names():
        return {"names": tf.identity(names_t, name="names")}

    module.serve = serve
    module.class_names = class_names
    tf.saved_model.save(
        module, path,
        signatures={"serving_default": serve, "class_names": class_names})

    meta = dict(meta, batch=int(batch), dim=int(dim), platforms=["cpu"],
                format="savedmodel")
    with open(os.path.join(path, META_FILENAME), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_savedmodel(path: str):
    """Load an exported SavedModel; returns (meta, serve_fn) where
    ``serve_fn(images_f32)`` runs the graph under TF and returns the
    serving dict as numpy arrays. For tests and CLI round trips: a TF
    Serving host loads the directory itself."""
    import tensorflow as tf

    with open(os.path.join(path, META_FILENAME)) as f:
        meta = json.load(f)
    mod = tf.saved_model.load(path)

    def serve_fn(images):
        out = mod.serve(tf.constant(images, tf.float32))
        return {k: v.numpy() for k, v in out.items()}

    return meta, serve_fn
