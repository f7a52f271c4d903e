"""The port's export and serving entry points on the CPU:
``cli.export`` (header fields as yolojax writes them, its refusals),
``cli.detect --artifact`` (``--image`` and ``--stdin``) and ``cli.eval
--artifact`` against the same program served from ``--weights``, and the
HTTP daemon ``cli.serve`` (the behaviour of yolojax's
``tests/e2e/test_http_serve.py`` but its data-parallel cases, on an
ephemeral port)."""

import concurrent.futures
import dataclasses
import io
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from yolojax_torch.cli import detect
from yolojax_torch.cli.serve import build_server
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.cache import build_cache
from yolojax_torch.data.loader import write_ppm
from yolojax_torch.models import get_model

from .util import run_cli, write_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 64


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read().decode())


def _png(rgb):
    import cv2

    return cv2.imencode(".png", cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))[1] \
        .tobytes()


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A seeded tiny-v2 ``.npz`` (20 VOC classes), an INI, five request
    images (PNG bytes) and a cached synthetic VOC ``test`` phase of six
    images."""
    tmp = tmp_path_factory.mktemp("serve")
    model = get_model("yolo2", "tiny", 20, anchors=((1.0, 1.0), (2.5, 1.5)))
    npz = str(tmp / "w.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(3),
                                            DIM))
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=6, size=(80, 60), seed=2)
    build_cache(str(tmp / "cache"), "test",
                [{"kind": "voc", "root": voc, "image_set": "test"}])
    ini = tmp / "serve.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        "anchors = 1.0,1.0 2.5,1.5\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\n"
        "[detect]\nthreshold = 0.005\ntop_k = 32\n[eval]\nbatch_size = 4\n")
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 255, (90, 120, 3), np.uint8) for _ in range(5)]
    paths = []
    for i, im in enumerate(imgs):
        paths.append(str(tmp / f"img{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(_png(im))
    return {"tmp": tmp, "npz": npz, "ini": str(ini), "imgs": imgs,
            "blobs": [_png(im) for im in imgs], "paths": paths,
            "cfg": load_config([str(ini)])}


def _export(ws, name, *extra):
    out = str(ws["tmp"] / name)
    argv = ["-c", ws["ini"], "--weights", ws["npz"], "--out", out,
            "--device", "cpu", *extra]
    import yolojax_torch.cli.export as export_cli

    sys_argv = sys.argv
    sys.argv = ["export", *argv]
    try:
        meta = export_cli.main()
    finally:
        sys.argv = sys_argv
    return out, meta


@pytest.fixture(scope="module")
def artifacts(ws):
    """Three CPU artifacts: f32 batch 2, f32 batch 1, int8 batch 4
    calibrated on two of the images."""
    return {
        "b2": _export(ws, "b2.yjts", "--batch", "2")[0],
        "b1": _export(ws, "b1.yjts")[0],
        "int8": _export(ws, "int8.yjts", "--batch", "4", "detect.use_int8=1",
                        "--calib-image", ws["paths"][0],
                        "--calib-image", ws["paths"][1])[0],
    }


# ---------------------------------------------------------------------------
# cli.export
# ---------------------------------------------------------------------------


def test_export_header_matches_yolojax(ws, monkeypatch, capsys):
    """The same config and weights through yolojax's ``cli/export.py`` and
    the port's: the same header keys with the same values (the payloads
    differ in kind, so only their sizes' presence is compared)."""
    from yolojax.serve import MAGIC as JAX_MAGIC

    from yolojax_torch.serve import MAGIC

    jax_out = str(ws["tmp"] / "m.yjsa")
    run_cli("cli.export", ["-c", ws["ini"], "--weights", ws["npz"],
                           "--out", jax_out, "--batch", "2"], monkeypatch)
    port_out, _ = _export(ws, "hdr.yjts", "--batch", "2")

    def header(path, magic):
        with open(path, "rb") as f:
            assert f.read(len(magic)) == magic
            n = int.from_bytes(f.read(4), "little")
            return json.loads(f.read(n))

    want, got = header(jax_out, JAX_MAGIC), header(port_out, MAGIC)
    assert sorted(got) == sorted(want) == sorted([
        "names", "model", "threshold", "nms_iou", "top_k", "stretch", "int8",
        "batch", "dim", "platforms", "payload_bytes"])
    for k in want:
        if k != "payload_bytes":
            assert got[k] == want[k], k
    assert got["payload_bytes"] > 0
    assert "platforms=cpu" in capsys.readouterr().out


def test_export_refusals(ws):
    """int8 without ``--calib-image`` is refused (unless
    ``--allow-synthetic-calib``), as is ``--batch 0``; of the TF formats
    (``tests/test_torch_savedmodel.py``, ``tests/test_torch_tflite.py``),
    TFLite refuses yolojax's ``stablehlo`` mode and an int8 program, naming
    the way out, and writes nothing."""
    with pytest.raises(SystemExit):
        _export(ws, "x.yjts", "detect.use_int8=1")
    with pytest.raises(SystemExit):
        _export(ws, "x.yjts", "--batch", "0")
    for extra, way_out in (
            (["--tflite-mode", "stablehlo"], "--tflite-mode graph"),
            (["detect.use_int8=1", "--allow-synthetic-calib"],
             "--format savedmodel")):
        with pytest.raises(ValueError, match=way_out):
            _export(ws, "x.tflite", "--format", "tflite", *extra)
        assert not os.path.exists(ws["tmp"] / "x.tflite")
    out, meta = _export(ws, "synthetic.yjts", "detect.use_int8=1",
                        "--allow-synthetic-calib")
    assert meta["int8"] is True and os.path.getsize(out) > 0


# ---------------------------------------------------------------------------
# cli.detect --artifact and cli.eval --artifact
# ---------------------------------------------------------------------------


def _detect(argv, monkeypatch, capsys, stdin=None):
    if stdin is not None:
        monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    monkeypatch.setattr(sys, "argv", ["detect", *argv])
    detect.main()
    return capsys.readouterr().out


def test_detect_artifact_matches_weights(ws, artifacts, monkeypatch, capsys):
    """Three images through the batch-2 artifact (one padded batch) print
    the lines the live program prints from ``--weights`` (the same f32
    program on the CPU: equal keep sets and boxes)."""
    images = [a for p in ws["paths"][:3] for a in ("--image", p)]
    live = _detect(["-c", ws["ini"], "--weights", ws["npz"], "--device",
                    "cpu", *images], monkeypatch, capsys)
    art = _detect(["-c", ws["ini"], "--artifact", artifacts["b2"],
                   "--device", "cpu", *images], monkeypatch, capsys)
    assert art == live and len(live.splitlines()) > 3


def test_detect_artifact_stdin(ws, artifacts, monkeypatch, capsys):
    """``--stdin`` with the batch-1 artifact answers as ``--weights``
    does, an unreadable path in order; a batch-2 artifact is refused."""
    lines = f"{ws['paths'][0]}\n{ws['tmp'] / 'missing.png'}\n" \
            f"{ws['paths'][1]}\n"
    live = _detect(["-c", ws["ini"], "--weights", ws["npz"], "--device",
                    "cpu", "--stdin"], monkeypatch, capsys, lines)
    art = _detect(["-c", ws["ini"], "--artifact", artifacts["b1"],
                   "--device", "cpu", "--stdin"], monkeypatch, capsys, lines)
    assert art == live
    assert art.split("\n\n")[1] == "missing.png: ERROR unreadable"
    with pytest.raises(SystemExit, match="--batch 1"):
        _detect(["-c", ws["ini"], "--artifact", artifacts["b2"],
                 "--device", "cpu", "--stdin"], monkeypatch, capsys, lines)
    with pytest.raises(SystemExit):  # both sources at once
        _detect(["-c", ws["ini"], "--artifact", artifacts["b1"],
                 "--weights", ws["npz"], "--image", ws["paths"][0]],
                monkeypatch, capsys)


def test_eval_artifact_matches_weights(ws, artifacts, monkeypatch, capsys):
    """``cli.eval --artifact`` (six images through the batch-2 and the
    batch-4 program, whose last batch is padded) reports the metrics of
    ``cli.eval --weights`` at the same threshold, the eval floor (yolojax's
    test_33 parity)."""
    out = {}
    for key, argv in (("weights", ["--weights", ws["npz"]]),
                      ("b2", ["--artifact", artifacts["b2"]]),
                      ("int8", ["--artifact", artifacts["int8"]])):
        run_cli("yolojax_torch.cli.eval",
                ["-c", ws["ini"], "--device", "cpu", "--coco", *argv],
                monkeypatch)
        out[key] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["b2"] == out["weights"]
    assert out["weights"]["num_images"] == out["int8"]["num_images"] == 6
    assert out["weights"]["num_detections"] > 0
    assert 0.0 <= out["int8"]["map"] <= 1.0


# ---------------------------------------------------------------------------
# the HTTP daemon
# ---------------------------------------------------------------------------


def _start(cfg, **kw):
    httpd, batcher = build_server(cfg, "127.0.0.1", 0, device="cpu", **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, batcher, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd, batcher):
    httpd.shutdown()
    httpd.server_close()
    batcher.close()


@pytest.fixture(scope="module")
def server(ws):
    httpd, batcher, base = _start(ws["cfg"], weights=ws["npz"], batch=4,
                                  window_ms=100)
    yield {"base": base, "batcher": batcher}
    _stop(httpd, batcher)


def _direct(cfg, npz, raw, batch=4):
    """What the direct detect path answers for ``raw`` in a batch."""
    names, dim, infer = detect.build_detector(cfg, npz, device="cpu")
    canvas, tf = letterbox_host(raw, dim, stretch=False)
    filler = np.full((dim, dim, 3), 0.5, np.float32)
    out = infer(np.stack([canvas.numpy()] + [filler] * (batch - 1)))
    return detect._extract(out, 0, tf, raw.shape, names)


def _assert_same(got, want):
    assert len(got) == len(want) > 0, (got, want)
    for g, (name, cls, score, box) in zip(got, want):
        assert g["name"] == name and g["class"] == cls
        assert g["score"] == pytest.approx(score, abs=1e-4)
        assert g["box"] == pytest.approx(list(box), abs=0.02)


def test_healthz(server):
    status, body = _get(server["base"] + "/healthz")
    assert status == 200
    assert body["status"] == "ok" and body["dim"] == DIM
    assert body["batch"] == 4 and body["names"][:2] == ["aeroplane",
                                                        "bicycle"]
    assert body["backend"] == "cpu" and body["devices"] == 1


def test_detect_parity_with_direct_path(ws, server):
    """The HTTP answer equals the direct ``build_detector`` + ``_extract``
    path on the same image (same program, letterbox and un-letterbox),
    up to the JSON rounding; a PPM body (decoded without cv2) answers as
    the PNG of the same pixels does."""
    _, body = _post(server["base"] + "/detect", ws["blobs"][0])
    assert body["image"] == {"width": 120, "height": 90}
    assert 1 <= body["batch_fill"] <= 4
    _assert_same(body["detections"],
                 _direct(ws["cfg"], ws["npz"], ws["imgs"][0]))
    ppm = str(ws["tmp"] / "img0.ppm")
    write_ppm(ppm, ws["imgs"][0])
    with open(ppm, "rb") as f:
        _, body_ppm = _post(server["base"] + "/detect", f.read())
    assert body_ppm["detections"] == body["detections"]


def test_concurrent_requests_share_batches(ws, server):
    before = server["batcher"].stats()
    with concurrent.futures.ThreadPoolExecutor(5) as pool:
        results = list(pool.map(
            lambda b: _post(server["base"] + "/detect", b), ws["blobs"]))
    assert all(status == 200 for status, _ in results)
    for _, body in results:
        assert "detections" in body and 1 <= body["batch_fill"] <= 4
    stats = server["batcher"].stats()
    assert stats["images"] - before["images"] == 5
    assert stats["batches"] - before["batches"] < 5  # some shared a batch
    assert stats["errors"] == 0


def test_pipelined_server_matches_single_inflight(ws, server):
    """``pipeline_depth=2``: concurrent bursts still get their own answers
    (batches may complete out of order), equal to the depth-1 server's."""
    httpd, batcher, base = _start(ws["cfg"], weights=ws["npz"], batch=2,
                                  window_ms=20, pipeline_depth=2)
    try:
        status, health = _get(base + "/healthz")
        assert status == 200 and health["pipeline_depth"] == 2
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            results = list(pool.map(lambda b: _post(base + "/detect", b),
                                    ws["blobs"]))
        assert all(s == 200 for s, _ in results)
        for (_, b_p), blob in zip(results, ws["blobs"]):
            _, b_1 = _post(server["base"] + "/detect", blob)
            got, want = b_p["detections"], b_1["detections"]
            assert len(got) == len(want)
            for g, w in zip(got, want):
                assert g["name"] == w["name"]
                assert g["score"] == pytest.approx(w["score"], abs=1e-4)
        assert batcher.stats()["errors"] == 0
    finally:
        _stop(httpd, batcher)


def test_int8_server_with_calib_dir(ws, tmp_path):
    """int8 daemon: ``--calib-dir`` supplies calibration images at start
    (files that do not decode are skipped); it answers what the direct
    int8 path calibrated on the same canvases answers."""
    calib = tmp_path / "calib"
    calib.mkdir()
    for i in range(3):
        write_ppm(str(calib / f"{i}.ppm"), ws["imgs"][i])
    (calib / "notes.txt").write_text("non-image files must be skipped")
    cfg = dataclasses.replace(ws["cfg"], detect=dataclasses.replace(
        ws["cfg"].detect, use_int8=True, calib_images=4))
    httpd, batcher, base = _start(cfg, weights=ws["npz"], batch=2,
                                  window_ms=50, calib_dir=str(calib))
    try:
        status, body = _post(base + "/detect", ws["blobs"][3])
        assert status == 200
        status, health = _get(base + "/healthz")
        assert health["batch"] == 2 and health["stats"]["errors"] == 0
    finally:
        _stop(httpd, batcher)
    canvases = [letterbox_host(im, DIM)[0] for im in ws["imgs"][:3]]
    names, dim, infer = detect.build_detector(cfg, ws["npz"], canvases,
                                              device="cpu")
    raw = ws["imgs"][3]
    canvas, tf = letterbox_host(raw, dim)
    filler = np.full((dim, dim, 3), 0.5, np.float32)
    out = infer(np.stack([canvas.numpy(), filler]))
    _assert_same(body["detections"],
                 detect._extract(out, 0, tf, raw.shape, names))


def test_calib_dir_without_images_fails_fast(ws, tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    cfg = dataclasses.replace(ws["cfg"], detect=dataclasses.replace(
        ws["cfg"].detect, use_int8=True))
    with pytest.raises(SystemExit, match="no image files"):
        build_server(cfg, "127.0.0.1", 0, weights=ws["npz"],
                     calib_dir=str(empty), device="cpu")


def test_data_parallel_not_ported(ws):
    """``--data-parallel`` is ported: on a host with one device the daemon
    serves on it (``devices`` 1 in /healthz and /stats) and answers as the
    direct path does; with ``--artifact`` it is refused (an artifact owns
    its device). The test keeps its name; tests/test_torch_parallel_eval.py
    splits over two replicas."""
    httpd, batcher, base = _start(ws["cfg"], weights=ws["npz"], batch=4,
                                  window_ms=1, data_parallel=True)
    try:
        _, health = _get(base + "/healthz")
        status, got = _post(base + "/detect", ws["blobs"][0])
        _, stats = _get(base + "/stats")
    finally:
        _stop(httpd, batcher)
    assert health["devices"] == stats["devices"] == 1
    assert health["batch"] == 4 and status == 200
    _assert_same(got["detections"], _direct(ws["cfg"], ws["npz"],
                                            ws["imgs"][0]))
    with pytest.raises(SystemExit, match="needs --weights"):
        build_server(ws["cfg"], "127.0.0.1", 0, artifact="m.yjts",
                     data_parallel=True, device="cpu")


def test_artifact_server_matches_artifact_detect(ws, artifacts):
    """``--artifact`` (the int8 batch-4 artifact): the daemon takes the
    baked batch, refuses another, and answers each of five concurrent
    requests as ``load_artifact_detector`` + ``_extract`` does."""
    with pytest.raises(SystemExit, match="conflicts"):
        build_server(ws["cfg"], "127.0.0.1", 0, artifact=artifacts["int8"],
                     batch=3, device="cpu")
    httpd, batcher, base = _start(ws["cfg"], artifact=artifacts["int8"],
                                  window_ms=50)
    try:
        _, health = _get(base + "/healthz")
        assert health["batch"] == 4
        with concurrent.futures.ThreadPoolExecutor(5) as pool:
            results = list(pool.map(lambda b: _post(base + "/detect", b),
                                    ws["blobs"]))
        (names, dim, infer, batch), _ = detect.load_artifact_detector(
            artifacts["int8"], "cpu")
        for (status, body), raw in zip(results, ws["imgs"]):
            assert status == 200
            canvas, tf = letterbox_host(raw, dim)
            filler = np.full((dim, dim, 3), 0.5, np.float32)
            out = infer(np.stack([canvas.numpy()] + [filler] * (batch - 1)))
            _assert_same(body["detections"],
                         detect._extract(out, 0, tf, raw.shape, names))
        stats = batcher.stats()
        assert stats["images"] == 5 and stats["errors"] == 0
    finally:
        _stop(httpd, batcher)


def test_error_paths(server, ws):
    """An undecodable body is a 400 that reaches no batch, an unknown path
    a 404; a good request after them is served and counted."""
    base = server["base"]
    _, before = _get(base + "/stats")
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(base + "/detect", b"this is not an image")
    assert e.value.code == 400 and "undecodable" in e.value.read().decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nope")
    assert e.value.code == 404
    status, stats = _get(base + "/stats")
    assert status == 200 and stats["images"] == before["images"]
    assert _post(base + "/detect", ws["blobs"][0])[0] == 200
    _, stats = _get(base + "/stats")
    assert stats["images"] == before["images"] + 1
    assert stats["errors"] == before["errors"]


def test_daemon_lifecycle_sigterm(ws):
    """The real CLI in a subprocess with jax and yolojax blocked: READY
    after the warm-up, serves a request, exits 0 with the final stats on
    SIGTERM (what a container runtime sends)."""
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["yolojax"] = None
        sys.argv = ["serve", "-c", {ws['ini']!r}, "--weights",
                    {ws['npz']!r}, "--port", "0", "--batch", "2",
                    "--device", "cpu"]
        runpy.run_module("yolojax_torch.cli.serve", run_name="__main__")
    """)
    proc = subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        base = None
        deadline = time.time() + 300
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                raise AssertionError("daemon exited before READY")
            if line.startswith("READY "):
                base = line.split()[1].strip()
                break
        assert base, "daemon never printed READY"
        status, body = _post(base + "/detect", ws["blobs"][0])
        assert status == 200 and "detections" in body
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert "final stats" in out and "'images': 1" in out
