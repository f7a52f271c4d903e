"""TFLite export of the port (``yolojax_torch/serve/tflite.py``) against
yolojax on the same weights.

Each export goes through ``python -m yolojax_torch.cli.export --device cpu
--format tflite`` and runs under the plain ``tf.lite.Interpreter``, which
has no Flex delegate here: a Select-TF op would fail at
``allocate_tensors``, so serving at all shows the file is TFLite builtins
only. It serves what yolojax's live portable program serves within
yolojax's TFLite bounds (``tests/e2e/test_cli.py::test_36``: keep equal;
classes, boxes and scores on the kept rows at 1e-3). A constant canvas
pins the tie order of ``TOPK_V2``; ``--tflite-mode stablehlo`` and an int8
program are refused before anything is written. Last, both formats are
plain TF: each package's SavedModel loader serves the other's export."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax_torch.serve.savedmodel import load_savedmodel, save_savedmodel
from yolojax_torch.serve.tf_graph import export_spec
from yolojax_torch.serve.tflite import load_tflite, save_tflite

from .test_torch_ptq import images
from .test_torch_savedmodel import (
    MODELS,
    NMS_IOU,
    THRESH,
    TIE_IOU,
    assert_detections,
    check_ties,
    jax_portable,
    make_weights,
    run_export,
    tie_weights,
)

tf = pytest.importorskip("tensorflow")


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=sorted(MODELS))
def exported(request, tmp_path_factory):
    """One model's weights exported through the CLI at batch 1."""
    key = request.param
    tmp = str(tmp_path_factory.mktemp(key))
    w = make_weights(key, 3, tmp)
    out = os.path.join(tmp, "model.tflite")
    line = run_export(["-c", w["ini"], "--weights", w["npz"], "--out", out,
                       "--format", "tflite", "--batch", "1",
                       "--device", "cpu"])
    return dict(w, key=key, out=out, line=line)


def test_tflite_matches_yolojax(exported):
    """The CLI's .tflite under the plain interpreter against yolojax's
    live portable program on the same weights and canvas."""
    c = MODELS[exported["key"]]
    out = exported["out"]
    size = os.path.getsize(out)
    assert exported["line"] == (
        f"{out}: {c.model}/{c.inference} dim={c.dim} batch=1 format=tflite "
        f"conversion=graph {size / 1e6:.1f} MB")
    with open(out + ".json") as f:
        sidecar = json.load(f)
    assert sidecar["conversion"] == "graph"
    assert sidecar["payload_bytes"] == size
    meta, serve_fn = load_tflite(out)
    assert meta["format"] == "tflite" and meta["batch"] == 1
    assert meta["names"][0] == "class0"
    x = images(c.images_seed, 1, c.dim)
    want = {k: np.asarray(v) for k, v in jax.device_get(jax_portable(
        exported["jm"], c.top_k, thresh=c.thresh, nms_iou=c.nms_iou)(
            exported["params"], {}, jnp.asarray(x))).items()}
    got = serve_fn(x)
    assert got["classes"].dtype == np.int32 and got["keep"].dtype == np.bool_
    assert_detections(got, want, atol=1e-3, rtol=1e-3, kept_only=True)
    assert got["keep"].any()


def test_tflite_constant_canvas_tie_order(tmp_path):
    """TFLite's ``TOPK_V2`` takes tied scores lower index first too: a
    constant canvas where most scores tie gives yolojax's classes, boxes
    and keep mask."""
    w = tie_weights(str(tmp_path))
    path = str(tmp_path / "ties.tflite")
    save_tflite(path, export_spec(w["tm"], w["net"]), batch=1, dim=128,
                meta={"names": ["a", "b", "c"]}, score_thresh=THRESH,
                iou_thresh=TIE_IOU, top_k=32)
    check_ties(w, load_tflite(path)[1])


@pytest.mark.parametrize("what", ["stablehlo", "int8"])
def test_tflite_refusals_write_nothing(what, tmp_path):
    """``--tflite-mode stablehlo`` and an int8 program raise a
    ``ValueError`` naming the way out, before any file is written."""
    w = make_weights("tiny_v2", 3, str(tmp_path))
    out = str(tmp_path / "model.tflite")
    extra, match = {
        "stablehlo": (["--tflite-mode", "stablehlo"], "--tflite-mode graph"),
        "int8": (["--allow-synthetic-calib", "detect.use_int8=1"],
                 "--format savedmodel"),
    }[what]
    with pytest.raises(ValueError, match=match):
        run_export(["-c", w["ini"], "--weights", w["npz"], "--out", out,
                    "--format", "tflite", "--device", "cpu", *extra])
    assert not os.path.exists(out) and not os.path.exists(out + ".json")
    spec = {"int8": {"qmax": 127}} if what == "int8" else {}
    with pytest.raises(ValueError, match=match):
        save_tflite(out, spec, batch=1, dim=64, meta={}, score_thresh=THRESH,
                    iou_thresh=0.45, top_k=32,
                    mode="stablehlo" if what == "stablehlo" else "graph")
    assert not os.path.exists(out)


def test_each_loader_serves_the_others_export(tmp_path):
    """Both formats are plain TF: yolojax's ``load_savedmodel`` serves the
    port's export and the port's serves yolojax's (``jax2tf``), with equal
    keep masks."""
    from yolojax.serve import savedmodel as jax_savedmodel

    w = make_weights("tiny_v2", 9, str(tmp_path))
    meta = {"names": ["a", "b", "c"], "stretch": False}
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    save_savedmodel(port_dir, export_spec(w["tm"], w["net"]), batch=2,
                    dim=64, meta=meta, score_thresh=THRESH,
                    iou_thresh=NMS_IOU, top_k=32)
    jinfer = jax_portable(w["jm"], 32)
    jax_savedmodel.save_savedmodel(jax_dir, jinfer, w["params"], {},
                                   batch=2, dim=64, meta=meta)
    x = images(10, 2, 64)
    want = {k: np.asarray(v) for k, v in
            jax.device_get(jinfer(w["params"], {}, jnp.asarray(x))).items()}
    for what, loader, path in (
            ("yolojax loads the port's", jax_savedmodel.load_savedmodel,
             port_dir),
            ("the port loads yolojax's", load_savedmodel, jax_dir)):
        loaded, serve_fn = loader(path)
        assert loaded["names"] == ["a", "b", "c"], what
        assert_detections(serve_fn(x), want, atol=1e-5, rtol=1e-4)
