"""The port's int8 serving on the CPU: ``make_infer_fn(qm=)`` and
``evaluate_model(int8=True)`` against yolojax's on the same weights and
cache, the detect CLI's int8 build (calibration canvases, the synthetic
fallback), the ``--stdin`` stream's ordering, and
``python -m yolojax_torch.cli.detect --stdin detect.use_int8=1`` in a
process that never imports jax."""

import json
import logging
import os
import subprocess
import sys
import textwrap
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.data import cache as jax_cache
from yolojax.eval.evaluator import evaluate_model as jax_evaluate_model
from yolojax.eval.evaluator import make_infer_fn as jax_make_infer_fn
from yolojax.quantize import ptq as jax_ptq
from yolojax_torch.cli import detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.interchange import quantized_from_jax
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data.cache import build_cache, load_cache
from yolojax_torch.eval import evaluator
from yolojax_torch.eval.evaluator import evaluate_model, make_infer_fn
from yolojax_torch.models import get_model
from yolojax_torch.ops.boxes import decode_v2, iou_matrix
from yolojax_torch.postprocess.nms import CLASS_OFFSET
from yolojax_torch.quantize import ptq

from .test_torch_ptq import folded_pair, images
from .util import write_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, TOP_K, NMS_IOU, THRESH = 32, 8, 0.45, 0.005
# tiny-v2 @ 32 (one cell, 100 candidates) whose eight best scores are
# spread wider than the int8 head's error (asserted below)
SEED = 25


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Folded tiny-v2 weights (box offsets x0.05 so boxes sit near their
    anchors), their ``.npz``, an INI, a 4-image VOC cache at the canvas
    size, and yolojax's QuantizedModel on two canvases."""
    tmp = tmp_path_factory.mktemp("int8")
    raw = []
    tm, net, jm, params = folded_pair("yolo2", "tiny", 20, DIM, SEED, raw)
    gain = np.tile(np.r_[np.full(4, 0.05), np.ones(21)], 5).astype(np.float32)
    params["conv_14"]["w"] = params["conv_14"]["w"] * gain
    with torch.no_grad():
        net.conv_14.w.mul_(torch.from_numpy(gain)[:, None, None, None])
    npz = str(tmp / "tiny.npz")
    save_network_npz(npz, get_model("yolo2", "tiny", 20), raw[0])
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=4, size=(DIM, DIM), seed=SEED)
    cache_dir = str(tmp / "cache")
    build_cache(cache_dir, "test", [{"kind": "voc", "root": voc,
                                     "image_set": "test"}])
    ini = tmp / "tiny.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[cache]\nbasedir = {cache_dir}\ntest = voc:{voc}:test\n"
        f"[detect]\nthreshold = {THRESH}\nnms_iou = {NMS_IOU}\n"
        f"top_k = {TOP_K}\nuse_int8 = 1\ncalib_images = 2\n"
        "[eval]\nbatch_size = 2\n")
    calib = images(SEED, 2, DIM)
    jqm = jax_ptq.quantize_model(jm, params, jnp.asarray(calib))
    return {"tm": tm, "net": net, "jm": jm, "params": params, "npz": npz,
            "ini": str(ini), "tmp": tmp, "cache_dir": cache_dir,
            "calib": calib, "jqm": jqm, "qm": quantized_from_jax(tm, jqm)}


def test_make_infer_fn_int8_matches_jax(served):
    """The int8 serving program from one QuantizedModel: equal classes and
    keep masks, scores and boxes within the bf16 head's error. The seed's
    margins exceed that error, so equal keep masks are a fair demand."""
    x = images(SEED + 1, 2, DIM)
    kw = dict(score_thresh=THRESH, iou_thresh=NMS_IOU, top_k=TOP_K,
              use_pallas="never", candidates="exact")
    jinfer = jax_make_infer_fn(served["jm"], qm=served["jqm"],
                               compute_dtype=jnp.float32, **kw)
    want = jax.device_get(jinfer({}, {}, jnp.asarray(x)))
    infer = make_infer_fn(served["tm"], qm=served["qm"], **kw)
    got = {k: v.numpy() for k, v in infer(None, torch.from_numpy(x)).items()}

    # the margins: twice the score error stays below the smallest gap
    # between consecutive top-(K+1) scores of the port's own decode, and
    # twice the IoU error below the smallest |IoU - thr| of any pair
    score_err = np.abs(got["scores"] - want["scores"]).max()
    scores = decode_v2(ptq.apply_int8(served["qm"], torch.from_numpy(x)),
                       served["tm"].anchors)["scores"].reshape(2, -1).numpy()
    top = -np.sort(-scores, axis=1)[:, :TOP_K + 1]
    assert np.diff(-top, axis=1).min() > 2 * score_err
    ious = [iou_matrix(t, t).numpy() for t in (
        torch.from_numpy(o["boxes"] + (o["classes"] * CLASS_OFFSET)[..., None])
        for o in (want, got))]
    off_diag = ~np.eye(TOP_K, dtype=bool)[None].repeat(2, 0)
    iou_err = np.abs(ious[1] - ious[0]).max()
    assert np.abs(ious[0] - NMS_IOU)[off_diag].min() > 2 * iou_err

    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    # the head within HEAD_RTOL of its max (tests/test_torch_ptq.py)
    # moves scores and boxes by ~1e-4 here
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0,
                               atol=1e-3)
    assert got["keep"].any()


def test_evaluate_model_int8_matches_jax(served, tmp_path):
    """``evaluate_model(int8=True)``: it calibrates on the phase's first
    ``calib_images`` canvases, as yolojax's does (the port is handed
    yolojax's scales for those same canvases), and then detects what
    yolojax detects: the same detections within the head's error and the
    same metrics within 1e-3. Calibrated by itself, its mAP stays within
    0.05 of yolojax's."""
    kw = dict(input_dim=DIM, batch_size=2, nms_iou=NMS_IOU, top_k=TOP_K,
              use_pallas="never", candidates="exact", int8=True,
              calib_images=2)
    jm, params = served["jm"], served["params"]
    jdump, tdump = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    want = jax_evaluate_model(
        jm, params, {}, jax_cache.load_cache(served["cache_dir"], "test"),
        compute_dtype=jnp.float32, data_parallel=False, dump_path=jdump, **kw)
    seen = []

    def jax_scales(model, net, calib, percentile, bits):
        seen.append(calib.numpy())
        return quantized_from_jax(model, jax_ptq.quantize_model(
            jm, params, jnp.asarray(calib.numpy()), percentile=percentile,
            bits=bits))

    cache = load_cache(served["cache_dir"], "test")
    with mock.patch.object(evaluator, "quantize_model", jax_scales):
        got = evaluate_model(served["tm"], served["net"], cache,
                             device="cpu", dump_path=tdump, **kw)
    assert seen[0].shape == (2, DIM, DIM, 3)
    assert got["num_images"] == want["num_images"] == 4
    assert got["num_detections"] == want["num_detections"] > 0
    for key in ("map", "num_detections"):
        assert abs(got[key] - want[key]) <= 1e-3, key
    with open(jdump) as f:
        jd = json.load(f)["detections"]
    with open(tdump) as f:
        td = json.load(f)["detections"]
    for a, b in zip(jd, td):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        assert abs(a["score"] - b["score"]) < 1e-3
        np.testing.assert_allclose(a["bbox"], b["bbox"], atol=0.05)
    own = evaluate_model(served["tm"], served["net"], cache, device="cpu",
                         **kw)
    assert abs(own["map"] - want["map"]) <= 0.05
    assert type(served["net"].conv_0).__name__ == "ConvLayer"


def test_build_serving_int8_calibration(served, caplog):
    """With canvases the int8 detector calibrates on them; without, on a
    seeded synthetic batch (the same one on every build), with a warning;
    ``detect.fuse_stem`` puts the int8 stem in, bit for bit, so the fused
    build answers as the unfused one does."""
    x = images(SEED + 2, 2, DIM)
    outs = {}
    for label, calib, over in (("canvases", list(served["calib"]), []),
                               ("synthetic", None, []),
                               ("synthetic-fused", None,
                                ["detect.fuse_stem=xla"])):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="detect"):
            infer = detect.build_detector(load_config([served["ini"]], over),
                                          served["npz"], calib,
                                          device="cpu")[2]
        warned = "synthetic inputs" in caplog.text
        assert warned == (calib is None), label
        outs[label] = infer(x)
    # two builds calibrate on the same seeded batch; the stem is bit-exact
    for key, v in outs["synthetic"].items():
        np.testing.assert_array_equal(outs["synthetic-fused"][key], v)
    qm = ptq.quantize_model(served["tm"], served["net"],
                            torch.from_numpy(served["calib"]))
    want = make_infer_fn(served["tm"], qm=qm, score_thresh=THRESH,
                         iou_thresh=NMS_IOU, top_k=TOP_K)(
        None, torch.from_numpy(x))
    for key, v in want.items():
        np.testing.assert_array_equal(outs["canvases"][key], v.numpy())


def test_lazy_detector_keeps_input_order(served, monkeypatch):
    """Frames buffer until ``calib_images`` arrive; an error deferred while
    they buffer answers after the frames before it; once built, frames and
    errors answer at once. The build sees the buffered canvases."""
    built, events = [], []

    def fake_build(cfg, weights, calib, device=None):
        built.append([float(c) for c in calib])
        return ["n"], DIM, lambda canvases: None

    monkeypatch.setattr(detect, "build_detector", fake_build)
    cfg = load_config([served["ini"]], ["detect.calib_images=3"])
    det = detect.LazyDetector(cfg, served["npz"], events.append)
    assert det.calib_target == 3 and det.infer is None
    det.defer(lambda: events.append("err0"))  # nothing buffered: at once
    det.add_frame(1.0, "a")
    det.defer(lambda: events.append("err1"))
    det.add_frame(2.0, "b")
    assert events == ["err0"] and det.pending_frames == 2
    det.add_frame(3.0, "c")  # the third frame builds and drains
    det.defer(lambda: events.append("err2"))
    det.add_frame(4.0, "d")
    det.flush()
    assert events == ["err0", "a", "err1", "b", "c", "err2", "d"]
    assert built == [[1.0, 2.0, 3.0]] and det.infer is not None
    short = detect.LazyDetector(cfg, served["npz"], events.append)
    short.add_frame(5.0, "e")
    short.flush()  # a short stream calibrates on what arrived
    assert built[-1] == [5.0] and events[-1] == "e"


def test_stdin_int8_stream_without_jax(served):
    """``--stdin`` with ``detect.use_int8=1 detect.calib_images=2`` on three
    readable paths and one unreadable one: one block per path, in input
    order, the buffering warning on stderr, and no jax module loaded."""
    import cv2

    tmp = served["tmp"]
    paths = []
    for i in range(3):
        p = str(tmp / f"s{i}.png")
        cv2.imwrite(p, np.random.RandomState(i).randint(
            0, 256, (40 + 10 * i, 50, 3), np.uint8))
        paths.append(p)
    paths.insert(1, str(tmp / "missing.png"))
    argv = ["detect", "-c", served["ini"], "--weights", served["npz"],
            "--stdin", "--device", "cpu", "detect.use_int8=1",
            "detect.calib_images=2"]
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = {argv!r}
        runpy.run_module("yolojax_torch.cli.detect", run_name="__main__")
        loaded = [m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "yolojax")]
        assert not loaded, loaded
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          input="\n".join(paths) + "\n", capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "buffers the first 2 frames" in proc.stderr
    blocks = proc.stdout.split("\n\n")[:-1]
    assert len(blocks) == 4
    names = [os.path.basename(p) for p in paths]
    assert blocks[1] == "missing.png: ERROR unreadable"
    for block, name in zip(blocks, names):
        assert block and all(line.startswith(f"{name}: ")
                             for line in block.splitlines())
