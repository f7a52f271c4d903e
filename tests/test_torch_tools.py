"""The port's host tools against yolojax's on the same inputs: the FLOP
counter and MFU (``utils/flops.py``), anchor k-means (``data/anchors.py``,
``cli.kmeans_anchors``), the augmentation demo, the camera loop
(``cli.detect_camera``) against ``cli.detect --stdin``, TensorBoard events
from ``cli.train`` and the ``python -m yolojax_torch`` dispatcher."""

import contextlib
import glob
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from yolojax.data import anchors as jax_anchors
from yolojax.data.cache import load_cache as jax_load_cache
from yolojax.models import get_model as jax_get_model
from yolojax.utils import flops as jax_flops
from yolojax_torch.cli import detect as detect_cli
from yolojax_torch.cli.detect_camera import camera_loop
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data import anchors
from yolojax_torch.data.cache import build_cache, load_cache
from yolojax_torch.data.loader import write_ppm
from yolojax_torch.models import get_model
from yolojax_torch.utils import flops

from .util import write_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 64


def _run(main, argv):
    """``main()`` with ``argv``; returns what it printed."""
    saved = sys.argv
    sys.argv = ["cli", *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            main()
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A seeded tiny-v2 ``.npz``, an INI and a cached synthetic VOC train
    phase with difficult objects."""
    tmp = tmp_path_factory.mktemp("tools")
    model = get_model("yolo2", "tiny", 20)
    npz = str(tmp / "w.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(3),
                                            DIM))
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=12, size=(96, 64), seed=5,
                        boxes_per_image=(1, 5), difficult_frac=0.3)
    ini = tmp / "t.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\ntrain = voc:{voc}:trainval\n"
        "[queue]\nbatch_size = 4\ncanvas_dim = 64\nmax_boxes = 8\n"
        "[detect]\nthreshold = 0.005\ntop_k = 32\n")
    cfg = load_config([str(ini)])
    build_cache(cfg.cache.basedir, "train", cfg.cache_datasets("train"),
                cfg.names())
    return {"tmp": tmp, "npz": npz, "ini": str(ini), "cfg": cfg}


# ---------------------------------------------------------------------------
# FLOPs and MFU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,inference", [
    ("yolo", "yolo"), ("yolo", "tiny"), ("yolo2", "darknet"),
    ("yolo2", "tiny")])
@pytest.mark.parametrize("dim", [320, 416, 448])
def test_flops_equal_yolojax(name, inference, dim):
    model, jmodel = get_model(name, inference, 20), jax_get_model(
        name, inference, 20)
    assert (flops.model_flops_per_image(model, dim)
            == jax_flops.model_flops_per_image(jmodel, dim))
    assert (flops.train_flops_per_image(model, dim)
            == jax_flops.train_flops_per_image(jmodel, dim))


def test_mfu_uses_h100_peaks():
    """Darknet-19 at 416 counts ~29.4 GFLOP (Darknet's figure); MFU is
    over the H100's dense bf16 peak, and the int8 MFU counts the bf16
    head at the bf16 peak and the trunk at the int8 peak."""
    model = get_model("yolo2", "darknet", 20)
    per_image = flops.model_flops_per_image(model, 416)
    assert 29.3e9 < per_image < 29.5e9
    assert flops.mfu(1000.0, per_image) == 1000.0 * per_image / 989.4e12
    assert flops.mfu(1.0, 1.0, flops.PEAK_F32) == 1.0 / 66.9e12
    head = 2.0 * 13 * 13 * 1024 * 125  # the 1x1 head conv
    want = 1000.0 * ((per_image - head) / 1978.9e12 + head / 989.4e12)
    assert np.isclose(flops.int8_mfu(1000.0, model, 416), want, rtol=1e-12)
    assert (flops.int8_mfu(1000.0, model, 416)
            > flops.mfu(1000.0, per_image, flops.PEAK_INT8))


# ---------------------------------------------------------------------------
# anchors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,seed,n", [(1, 0, 40), (5, 0, 300), (9, 3, 500),
                                      (4, 1, 4)])
def test_kmeans_anchors_bit_equal(k, seed, n):
    """Same k-means++ draws and median updates as yolojax, bit for bit;
    ``n == k`` boxes and coinciding boxes take the degenerate branches."""
    rng = np.random.RandomState(seed + 100)
    wh = np.exp(rng.normal(0.5, 0.8, (n, 2)))
    wh[: n // 5] = wh[0]  # coinciding shapes
    wh[-1] = (0.0, 1.0)  # dropped: not positive
    if n == k:
        wh = np.concatenate([wh, wh[:1]])
    got, got_iou = anchors.kmeans_anchors(wh, k, seed=seed)
    want, want_iou = jax_anchors.kmeans_anchors(wh, k, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert got_iou == want_iou
    with pytest.raises(ValueError, match="at least"):
        anchors.kmeans_anchors(wh[:k - 1] if k > 1 else wh[:0], k)


@pytest.mark.parametrize("stretch", [False, True], ids=["letterbox",
                                                        "stretch"])
def test_cache_box_shapes_and_cli_equal_yolojax(ws, stretch):
    """The port's cache (read by both packages) gives yolojax's box shapes
    (difficult objects left out), and ``cli.kmeans_anchors`` prints
    yolojax's two lines."""
    from cli.kmeans_anchors import main as jax_main
    from yolojax_torch.cli.kmeans_anchors import main

    base = ws["cfg"].cache.basedir
    got = anchors.cache_box_shapes(load_cache(base, "train"), DIM,
                                   stretch=stretch)
    want = jax_anchors.cache_box_shapes(jax_load_cache(base, "train"), DIM,
                                        stretch=stretch)
    assert got.shape[0] > 10
    np.testing.assert_array_equal(got, want)
    argv = ["-c", ws["ini"], "--num", "3", "--seed", "2"] + (
        ["--stretch"] if stretch else [])
    printed = _run(main, argv)
    assert printed == _run(jax_main, argv)
    lines = printed.splitlines()
    assert len(lines) == 2 and lines[1].startswith("anchors = ")


# ---------------------------------------------------------------------------
# the augmentation demo
# ---------------------------------------------------------------------------


def test_demo_writes_png(ws, tmp_path):
    import cv2

    from yolojax_torch.cli.demo_data_augmentation import main

    out = str(tmp_path / "grid.png")
    printed = _run(main, ["-c", ws["ini"], "--out", out, "--rows", "2",
                          "--cols", "3", "--device", "cpu"])
    assert printed.strip() == f"wrote {out} (2x3 augmented samples)"
    grid = cv2.imread(out)
    assert grid.shape == (2 * DIM, 3 * DIM, 3) and grid.any()


# ---------------------------------------------------------------------------
# the camera loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clip(ws):
    """A 5-frame MJPG clip written with cv2 (as tests/e2e/test_cli.py
    writes one) and its frames as cv2 decodes them, in RGB."""
    import cv2

    path = str(ws["tmp"] / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5,
                             (96, 64))
    rng = np.random.RandomState(0)
    for _ in range(5):
        writer.write(rng.randint(0, 255, (64, 96, 3), np.uint8))
    writer.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    assert len(frames) == 5
    return path, frames


def _stdin_lines(cfg, npz, frames, tmp):
    """``cli.detect --stdin`` on the frames written as PPM files."""
    paths = []
    for i, frame in enumerate(frames):
        paths.append(str(tmp / f"frame_{i + 1:06d}.ppm"))
        write_ppm(paths[-1], frame)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        detect_cli.run_stream(cfg, npz, lines=[p + "\n" for p in paths],
                              device="cpu")
    return out.getvalue()


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_camera_loop_equals_detect_stdin(ws, clip, int8, tmp_path):
    """``cli.detect_camera`` headless on the clip writes one PNG a frame up
    to ``--max-frames``; the loop's detections on the clip's frames equal
    ``cli.detect --stdin`` on the same frames (int8: both calibrate on the
    first two)."""
    import cv2

    from yolojax_torch.cli.detect_camera import main

    extra = ["detect.use_int8=1", "detect.calib_images=2"] if int8 else []
    out_dir = str(tmp_path / "frames")
    _run(main, ["-c", ws["ini"], "--weights", ws["npz"], "--video", clip[0],
                "--out-dir", out_dir, "--max-frames", "3", "--device", "cpu",
                *extra])
    names = sorted(os.listdir(out_dir))
    assert names == [f"frame_{i:06d}.png" for i in (1, 2, 3)]
    assert cv2.imread(os.path.join(out_dir, names[0])).shape == (64, 96, 3)

    cfg = load_config([ws["ini"]], extra)
    lines = []

    def sink(n, frame, dets):
        assert frame is clip[1][n - 1]
        for name, _, score, (x0, y0, x1, y1) in dets:
            lines.append(f"frame_{n:06d}.ppm: {name} {score:.3f} "
                         f"[{x0:.0f}, {y0:.0f}, {x1:.0f}, {y1:.0f}]")
        lines.append("")
        return False

    served = camera_loop(cfg, ws["npz"], iter(clip[1]), sink, device="cpu")
    assert served == 5 and len(lines) > 5
    assert "\n".join(lines) + "\n" == _stdin_lines(cfg, ws["npz"], clip[1],
                                                   tmp_path)
    # --max-frames counts frames still buffered for calibration
    stops = []
    assert camera_loop(cfg, ws["npz"], iter(clip[1]),
                       lambda n, f, d: stops.append(n), max_frames=1,
                       device="cpu") == 1


def test_camera_refuses_a_batch8_artifact(ws, clip, tmp_path):
    import yolojax_torch.cli.export as export_cli
    from yolojax_torch.cli.detect_camera import main

    art = str(tmp_path / "b8.yjts")
    _run(export_cli.main, ["-c", ws["ini"], "--weights", ws["npz"], "--out",
                           art, "--batch", "8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="exported with batch 8"):
        _run(main, ["-c", ws["ini"], "--artifact", art, "--video", clip[0],
                    "--out-dir", str(tmp_path / "f"), "--device", "cpu"])
    assert not os.path.exists(tmp_path / "f")  # refused before the capture


# ---------------------------------------------------------------------------
# TensorBoard and the dispatcher
# ---------------------------------------------------------------------------


def test_train_tensorboard_writes_loss_scalar(ws, tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    from yolojax_torch.cli import train as train_cli

    cfg = load_config([ws["ini"]], [
        f"train.logdir={tmp_path}", "train.steps=2", "train.summary_steps=1",
        "train.save_steps=100", "train.tensorboard=1",
        "train.compute_dtype=float32", "optimizer.optimizer=sgd"])
    train_cli.train(cfg, device="cpu")
    logdir = tmp_path / "yolo2_tiny"
    assert glob.glob(str(logdir / "events.out.tfevents.*"))
    acc = EventAccumulator(str(logdir))
    acc.Reload()
    total = acc.Scalars("total")
    assert [e.step for e in total] == [1, 2]
    with open(logdir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [np.float32(r["total"]) for r in rows] == [
        np.float32(e.value) for e in total]


def test_dispatcher(ws):
    from yolojax_torch.__main__ import COMMANDS, main
    from yolojax.__main__ import COMMANDS as JAX_COMMANDS

    assert COMMANDS == JAX_COMMANDS
    assert main(["--help"]) == 0 and main([]) == 2 and main(["nope"]) == 2
    argv = ["-c", ws["ini"], "--num", "2"]
    from yolojax_torch.cli.kmeans_anchors import main as kmeans

    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert main(["kmeans-anchors", *argv]) == 0
    assert out.getvalue() == _run(kmeans, argv)
    blocked = ("import sys, runpy; sys.modules['jax'] = None; "
               "sys.modules['yolojax'] = None; sys.argv = ['x'] + sys.argv[1:]"
               "; runpy.run_module('yolojax_torch', run_name='__main__')")
    for args, code in ((["--help"], 0), ([], 2), (["frobnicate"], 2)):
        proc = subprocess.run([sys.executable, "-c", blocked, *args],
                              cwd=REPO, capture_output=True, text=True,
                              env=dict(os.environ, PYTHONPATH=REPO),
                              timeout=120)
        assert proc.returncode == code, proc.stderr
    assert "parse-darknet" in proc.stderr or "unknown command" in proc.stderr
