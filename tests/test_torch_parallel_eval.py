"""Eval over processes and devices, and ``--data-parallel`` serving, on the
CPU.

* ``eval.distributed=1`` on two ``gloo`` ranks (``evaluate_model`` and
  ``cli.eval`` with ``--dump``): every rank evaluates its strided shard,
  the rows are all-gathered, and the metrics and the detection lists equal
  yolojax's ``evaluate_model`` on the same weights in one process;
* ``eval.data_parallel``: each batch split over two replicas (two CPU
  "devices" stand in for a host's cards) gives the plain metrics, and the
  defaults are yolojax's (int8 stays on one device unless asked);
* ``cli.detect --data-parallel`` and ``cli.serve --data-parallel``: with
  one device a warning and the plain program; with two, the batch split
  and ``devices`` reported.
"""

import io
import json
import logging
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from yolojax_torch.cli import detect as detect_cli
from yolojax_torch.cli import eval as eval_cli
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.data.cache import build_cache, load_cache
from yolojax_torch.eval import evaluator
from yolojax_torch.eval.evaluator import evaluate_model
from yolojax_torch.models import get_model
from yolojax_torch.parallel import launch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_torch_eval.py's seeds and scales, on tiny v2
DIM, BATCH, N_IMAGES, TOP_K, NMS_IOU = 64, 4, 6, 256, 0.45
WEIGHTS_SEED, DATA_SEED = 31, 41
KW = dict(input_dim=DIM, batch_size=BATCH, nms_iou=NMS_IOU, top_k=TOP_K,
          use_pallas="never", candidates="exact", fuse_stem_impl="xla",
          max_detections=0, map_iou=0.1)
SPAWN_TIMEOUT = 180


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ws(tmp_path_factory):
    """A synthetic VOC test phase at the canvas size, its cache, a tiny v2
    ``.npz`` drawn as tests/test_torch_eval.py draws its Darknet-19 (boxes
    near their anchors, every candidate above the floor) and an INI."""
    from yolojax.convert.store import save_params_npz
    from yolojax.models import get_model as jax_get_model

    from .test_torch_layers import random_jax_weights
    from .util import write_synthetic_voc

    tmp = tmp_path_factory.mktemp("parallel_eval")
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=N_IMAGES, size=(DIM, DIM),
                        seed=DATA_SEED, difficult_frac=0.3)
    params, state = random_jax_weights(jax_get_model("yolo2", "tiny", 20),
                                       DIM, seed=WEIGHTS_SEED)
    gain = np.tile(np.r_[np.full(4, 0.05), np.full(21, 0.25)], 5)
    head = max(params, key=lambda k: int(k.split("_")[1]))
    params[head]["w"] = (params[head]["w"] * gain).astype(np.float32)
    npz = str(tmp / "tiny_v2.npz")
    save_params_npz(npz, params, state)
    ini = tmp / "eval.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\ntest = voc:{voc}:test\n"
        f"[detect]\nnms_iou = {NMS_IOU}\ntop_k = {TOP_K}\n"
        f"[eval]\nbatch_size = {BATCH}\nmap_iou = 0.1\n"
        "max_detections = 0\n")
    build_cache(str(tmp / "cache"), "test",
                [{"kind": "voc", "root": voc, "image_set": "test"}])
    return {"ini": str(ini), "npz": npz, "tmp": tmp,
            "cache_dir": str(tmp / "cache")}


def _net(npz):
    model = get_model("yolo2", "tiny", 20)
    return model, load_network_npz(npz, model)


def _distributed_rank(rank, npz, cache_dir, ini, dump):
    """``evaluate_model(distributed=True)`` and ``cli.eval
    eval.distributed=1 --dump`` on this rank."""
    model, net = _net(npz)
    direct = evaluate_model(model, net, load_cache(cache_dir, "test"),
                            distributed=True, device="cpu",
                            compute_dtype=torch.float32, **KW)
    argv = ["-c", ini, "--weights", npz, "--device", "cpu", "--dump", dump,
            "eval.distributed=1", "detect.use_pallas=never",
            "detect.fuse_stem=xla", "train.coordinator=127.0.0.1:1",
            "train.num_processes=2", f"train.process_id={rank}"]
    saved = sys.argv
    sys.argv = ["eval", *argv]
    try:
        with redirect_stdout(io.StringIO()) as out:
            cli = eval_cli.main()
    finally:
        sys.argv = saved
    return direct, cli, out.getvalue()


@pytest.fixture(scope="module")
def jax_reference(ws):
    """yolojax's one-process ``evaluate_model`` (metrics and dump)."""
    import jax.numpy as jnp

    from yolojax.convert.store import load_params_npz
    from yolojax.data import cache as jax_cache
    from yolojax.eval.evaluator import evaluate_model as jax_evaluate_model
    from yolojax.models import get_model as jax_get_model

    dump = str(ws["tmp"] / "jax_dump.json")
    metrics = jax_evaluate_model(
        jax_get_model("yolo2", "tiny", 20), *load_params_npz(ws["npz"]),
        jax_cache.load_cache(ws["cache_dir"], "test"),
        compute_dtype=jnp.float32, data_parallel=False, dump_path=dump,
        **KW)
    with open(dump) as f:
        return metrics, json.load(f)


@pytest.fixture(scope="module")
def distributed(ws):
    dump = str(ws["tmp"] / "port_dump.json")
    got = launch.run(_distributed_rank, 2,
                     args=(ws["npz"], ws["cache_dir"], ws["ini"], dump),
                     device="cpu", timeout=SPAWN_TIMEOUT)
    with open(dump) as f:
        return got, json.load(f)


def _close(got, want, tol=1e-6):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), k
        else:
            assert abs(g - w) <= tol, (k, g, w)


def test_distributed_eval_matches_yolojax(distributed, jax_reference):
    """Both ranks return yolojax's one-process metrics, directly and
    through the CLI; only the primary prints."""
    (r0, r1), _ = distributed
    want, _ = jax_reference
    assert want["num_images"] == N_IMAGES and want["num_detections"] > 0
    for direct, cli, _ in (r0, r1):
        _close(direct, want)
        _close(cli, want)
    assert json.loads(r0[2].splitlines()[-1])["num_images"] == N_IMAGES
    assert r1[2] == ""


def test_distributed_detections_match_yolojax(distributed, jax_reference):
    """The gathered detection and GT lists (global ids = the cache
    index) are yolojax's, row for row once sorted."""
    _, got = distributed
    _, want = jax_reference

    def rows(dump, key):
        return sorted((d["image_id"], d["category_id"],
                       round(d.get("score", 0.0), 5),
                       tuple(round(v, 3) for v in d["bbox"]))
                      for d in dump[key]) if key == "detections" else sorted(
            (a["image_id"], a["category_id"], a["iscrowd"],
             tuple(round(v, 3) for v in a["bbox"]))
            for a in dump["gt"]["annotations"])

    for key in ("detections", "gt"):
        g, w = rows(got, key), rows(want, key)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert a[:2] == b[:2]
            np.testing.assert_allclose(a[2:3] + a[3], b[2:3] + b[3],
                                       atol=2e-3)
    assert len(got["gt"]["images"]) == N_IMAGES


def test_distributed_id_space_is_checked():
    with pytest.raises(ValueError, match="2\\^24"):
        evaluator._allgather_shards([], [], [], 2 ** 23, 2)


def test_distributed_on_one_process_is_plain_eval(ws):
    model, net = _net(ws["npz"])
    cache = load_cache(ws["cache_dir"], "test")
    a = evaluate_model(model, net, cache, device="cpu",
                       compute_dtype=torch.float32, **KW)
    b = evaluate_model(model, net, cache, distributed=True, device="cpu",
                       compute_dtype=torch.float32, **KW)
    assert a == b


@pytest.mark.parametrize("int8,data_parallel,split", [
    (False, True, True), (False, None, True), (False, False, False),
    (True, None, False), (True, True, True)])
def test_data_parallel_eval(ws, monkeypatch, int8, data_parallel, split):
    """Two CPU replicas stand in for a host's two cards: the batch split
    gives the one-device metrics (padded to the device count). yolojax's
    defaults: auto splits, int8 stays whole unless asked, off never."""
    calls = []
    real = evaluator.replicate
    monkeypatch.setattr(evaluator, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)
    monkeypatch.setattr(evaluator, "replicate",
                        lambda *a: calls.append(a) or real(*a))
    model, net = _net(ws["npz"])
    cache = load_cache(ws["cache_dir"], "test")
    kw = dict(KW, batch_size=3, int8=int8, calib_images=2)  # 3 -> pad 1
    want = evaluate_model(model, net, cache, device="cpu",
                          compute_dtype=torch.float32, data_parallel=False,
                          **kw)
    got = evaluate_model(model, net, cache, device="cpu",
                         compute_dtype=torch.float32,
                         data_parallel=data_parallel, **kw)
    assert bool(calls) == split
    _close(got, want)


def test_one_device_data_parallel_is_plain(ws):
    """On a host with one device (the CPU here, one card on an H100
    machine) ``data_parallel=True`` runs the plain program."""
    model, net = _net(ws["npz"])
    cache = load_cache(ws["cache_dir"], "test")
    kw = dict(device="cpu", compute_dtype=torch.float32, **KW)
    assert evaluate_model(model, net, cache, data_parallel=True, **kw) == \
        evaluate_model(model, net, cache, **kw)


def _images(ws, n=3):
    import cv2

    paths = []
    for i in range(n):
        p = str(ws["tmp"] / f"dp{i}.png")
        cv2.imwrite(p, np.random.RandomState(i).randint(0, 256, (50, 70, 3),
                                                        np.uint8))
        paths.append(p)
    return paths


@pytest.mark.parametrize("devices", [1, 2])
def test_detect_data_parallel(ws, monkeypatch, capsys, caplog, devices):
    """``cli.detect --data-parallel`` prints what the plain run prints;
    with one device it says so, with two it splits the (rounded-up)
    batch."""
    monkeypatch.setattr(detect_cli, "local_devices",
                        lambda device: [torch.device("cpu")] * devices)
    paths = _images(ws)
    base = ["detect", "-c", ws["ini"], "--weights", ws["npz"],
            "--device",
            "cpu", "detect.threshold=0.005", "eval.batch_size=3"]
    images = [a for p in paths for a in ("--image", p)]
    printed = []
    for extra in ([], ["--data-parallel"]):
        monkeypatch.setattr(sys, "argv", base + images + extra)
        with caplog.at_level(logging.INFO, logger="detect"):
            detect_cli.main()
        printed.append(capsys.readouterr().out)
    assert printed[0] and printed[1] == printed[0]
    said = ("only 1 local device" if devices == 1
            else "data-parallel over 2 local devices")
    assert said in caplog.text
    monkeypatch.setattr(sys, "argv", base + ["--stdin", "--data-parallel"])
    with pytest.raises(SystemExit):
        detect_cli.main()
    names, dim, infer = detect_cli.build_detector(
        load_config([ws["ini"]]), ws["npz"], device="cpu",
        data_parallel=True)
    if devices == 2:
        with pytest.raises(ValueError, match="batch % 2 == 0"):
            infer(np.zeros((3, dim, dim, 3), np.float32))


@pytest.mark.parametrize("devices", [1, 2])
def test_serve_data_parallel(ws, monkeypatch, devices):
    """``cli.serve --data-parallel``: ``devices`` in /healthz and /stats,
    the batch rounded up to a device multiple, answers equal to the plain
    daemon's."""
    import threading
    import urllib.request

    from yolojax_torch.cli.serve import build_server

    monkeypatch.setattr(detect_cli, "local_devices",
                        lambda device: [torch.device("cpu")] * devices)
    cfg = load_config([ws["ini"]], ["detect.threshold=0.005"])
    with open(_images(ws, 1)[0], "rb") as f:
        body = f.read()
    answers = []
    for dp in (False, True):
        httpd, batcher = build_server(cfg, "127.0.0.1", 0,
                                      weights=ws["npz"],
                                      batch=3, window_ms=1.0,
                                      data_parallel=dp, device="cpu")
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        base = "http://127.0.0.1:%d" % httpd.server_address[1]
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
                health = json.load(r)
            req = urllib.request.Request(base + "/detect", data=body)
            with urllib.request.urlopen(req, timeout=60) as r:
                answers.append(json.load(r)["detections"])
            with urllib.request.urlopen(base + "/stats", timeout=30) as r:
                stats = json.load(r)
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(10)
        want = devices if dp else 1
        assert health["devices"] == stats["devices"] == want
        assert health["batch"] == (4 if dp and devices == 2 else 3)
        assert stats["images"] == 1
    assert answers[0] and answers[1] == answers[0]
