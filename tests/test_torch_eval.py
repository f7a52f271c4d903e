"""The eval slice on the CPU: the port's VOC/COCO metrics and
``evaluate_model`` against yolojax's on the same detections, cache and
weights, and ``python -m yolojax_torch.cli.cache`` / ``cli.eval`` driven
in process."""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.convert.store import load_params_npz, save_params_npz
from yolojax.data import cache as jax_cache
from yolojax.eval import voc_map as jax_voc_map
from yolojax.eval.evaluator import evaluate_model as jax_evaluate_model
from yolojax.eval.evaluator import make_infer_fn as jax_make_infer_fn
from yolojax.models import get_model as jax_get_model
from yolojax.nn.stem import fuse_stem as jax_fuse_stem
from yolojax.ops.boxes import decode_v2 as jax_decode_v2
from yolojax.ops.boxes import iou_matrix as jax_iou_matrix
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.data.cache import build_cache, load_cache
from yolojax_torch.data.loader import Loader, LoaderConfig
from yolojax_torch.eval import voc_map
from yolojax_torch.eval.evaluator import evaluate_model, make_infer_fn
from yolojax_torch.models import get_model
from yolojax_torch.nn.stem import fuse_stem
from yolojax_torch.ops.boxes import decode_v2, iou_matrix
from yolojax_torch.postprocess.nms import CLASS_OFFSET

from .test_torch_layers import random_jax_weights
from .util import run_cli, write_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, BATCH, N_IMAGES, TOP_K, NMS_IOU = 64, 4, 6, 256, 0.45
THRESH = 0.005  # the eval protocol's score floor (EVAL_SCORE_THRESH)
# Seeds whose top-256 scores and IoUs stay clear of ties by more than the
# port-vs-yolojax numeric error (asserted in test_eval_seed_keeps_margins),
# so equal detection lists are a fair demand, as in test_torch_slice.py.
WEIGHTS_SEED, DATA_SEED = 31, 41


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def assert_metrics_equal(got, want, tol=0.0):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, float) and math.isnan(w):
            assert isinstance(g, float) and math.isnan(g), key
        elif tol:
            assert abs(g - w) <= tol, (key, g, w)
        else:
            assert g == w, (key, g, w)


# ---------------------------------------------------------------------------
# the metrics alone, on one set of detection and GT lists
# ---------------------------------------------------------------------------


def random_lists(seed, n_images=12, num_classes=5, empty_class=3,
                 crowded_image=0):
    """GT with ~30% difficult objects and none of ``empty_class``;
    detections: jittered copies of the GT (hits at several IoUs), random
    boxes (misses) and some of the empty class; ``crowded_image`` gets more
    than 100 detections, so AR@100's cap cuts."""
    rng = np.random.RandomState(seed)
    classes = [c for c in range(num_classes) if c != empty_class]

    def box(cy, cx, h, w):
        return np.asarray([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2])

    gts, difficult, dets = [], [], []
    for img in range(n_images):
        for _ in range(rng.randint(0, 5)):
            cy, cx = rng.uniform(0.2, 0.8, 2)
            h, w = rng.uniform(0.05, 0.6, 2)
            c = int(rng.choice(classes))
            gts.append((img, c, box(cy, cx, h, w)))
            difficult.append(bool(rng.rand() < 0.3))
            for _ in range(rng.randint(0, 3)):
                j = rng.normal(0, 0.05, 4) * np.r_[h, w, h, w]
                dets.append((img, c, float(rng.rand()), gts[-1][2] + j))
        n_rand = 120 if img == crowded_image else rng.randint(0, 8)
        for _ in range(n_rand):
            c = int(rng.randint(num_classes))  # the empty class too
            dets.append((img, c, float(rng.rand()),
                         box(*rng.uniform(0.1, 0.9, 2),
                             *rng.uniform(0.02, 0.5, 2))))
    return dets, gts, np.asarray(difficult)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_voc_and_coco_metrics_match_jax(seed):
    dets, gts, difficult = random_lists(seed)
    assert difficult.any() and len(dets) > 100
    for kw in ({}, {"gt_difficult": difficult}, {"iou_thresh": 0.3,
                                                 "eleven_point": False}):
        got = voc_map.compute_map(dets, gts, 5, **kw)
        want = jax_voc_map.compute_map(dets, gts, 5, **kw)
        assert "ap_3" not in got  # the empty class is out of the mean
        assert_metrics_equal(got, want)
    for kw in ({}, {"gt_ignore": difficult}, {"box_scale": 416.0}):
        got = voc_map.compute_coco_map(dets, gts, 5, **kw)
        want = jax_voc_map.compute_coco_map(dets, gts, 5, **kw)
        assert_metrics_equal(got, want)
    assert voc_map.voc_ap(np.array([0.5, 1.0]), np.array([1.0, 0.5])) == \
        jax_voc_map.voc_ap(np.array([0.5, 1.0]), np.array([1.0, 0.5]))


def test_metrics_of_an_empty_set_match_jax():
    assert_metrics_equal(voc_map.compute_map([], [], 3),
                         jax_voc_map.compute_map([], [], 3))
    assert_metrics_equal(voc_map.compute_coco_map([], [], 3),
                         jax_voc_map.compute_coco_map([], [], 3))


# ---------------------------------------------------------------------------
# the slice end to end: cache -> loader -> fused-stem forward -> NMS -> mAP
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """A synthetic VOC set (images at the canvas size, so both packages'
    canvases are the decoded pixels), its cache, a Darknet-19 ``.npz`` and
    an INI naming both."""
    tmp = tmp_path_factory.mktemp("eval")
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=N_IMAGES, size=(DIM, DIM),
                        seed=DATA_SEED, difficult_frac=0.3)
    jm = jax_get_model("yolo2", "darknet", 20)
    params, state = random_jax_weights(jm, DIM, seed=WEIGHTS_SEED)
    # boxes near their anchors and every candidate above the floor, as in
    # tests/test_torch_slice.py
    gain = np.tile(np.r_[np.full(4, 0.05), np.full(21, 0.25)], 5)
    params["conv_30"]["w"] = (params["conv_30"]["w"] * gain).astype(np.float32)
    npz = str(tmp / "darknet19.npz")
    save_params_npz(npz, params, state)
    ini = tmp / "eval.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = darknet\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\ntest = voc:{voc}:test\n"
        f"[detect]\nnms_iou = {NMS_IOU}\ntop_k = {TOP_K}\n"
        f"[eval]\nbatch_size = {BATCH}\n")
    cache = build_cache(str(tmp / "cache"), "test",
                        [{"kind": "voc", "root": voc, "image_set": "test"}])
    assert cache.difficult.any()
    return {"ini": str(ini), "npz": npz, "tmp": tmp, "cache_dir":
            str(tmp / "cache")}


def _jax_fused(npz):
    jm = jax_get_model("yolo2", "darknet", 20)
    fm, fp, fs = jax_fold_bn(jm, *load_params_npz(npz))
    return jax_fuse_stem(fm, fp, fs, impl="xla")


def test_eval_seed_keeps_margins(eval_setup):
    """Twice the largest score error (port vs yolojax, fused f32 forward)
    stays below the smallest gap between consecutive top-K scores, and
    twice the largest IoU error below the smallest |IoU - thr|, on the
    eval set's own canvases: a mismatch in the end-to-end test is then a
    fault, not a near-tie."""
    cache = load_cache(eval_setup["cache_dir"], "test")
    canvases = np.concatenate([b[0] for b in Loader(cache, LoaderConfig(
        batch_size=BATCH, canvas_dim=DIM, drop_remainder=False,
        num_threads=2)).epoch(0, shuffle=False)])
    assert canvases.shape == (N_IMAGES, DIM, DIM, 3)
    fm, fp, fs = _jax_fused(eval_setup["npz"])
    head = np.asarray(jax.jit(lambda p, s, x: fm.apply(
        p, s, x, compute_dtype=jnp.float32)[0])(fp, fs, canvases))
    tm0 = get_model("yolo2", "darknet", 20)
    tm, tnet = fuse_stem(*fold_bn(tm0, load_network_npz(eval_setup["npz"],
                                                          tm0)), impl="xla")
    with torch.no_grad():
        thead = tm.apply(tnet, torch.from_numpy(canvases),
                         compute_dtype=torch.float32)
    n = N_IMAGES
    jscores = np.asarray(jax_decode_v2(jnp.asarray(head), fm.anchors)
                         ["scores"]).reshape(n, -1)
    tscores = decode_v2(thead, tm.anchors)["scores"].numpy().reshape(n, -1)
    score_err = np.abs(tscores - jscores).max()
    top = -np.sort(-jscores, axis=1)[:, :TOP_K + 1]
    assert np.diff(-top, axis=1).min() > 2 * score_err
    want = jax.device_get(jax_make_infer_fn(
        fm, score_thresh=THRESH, iou_thresh=NMS_IOU, top_k=TOP_K,
        use_pallas="never", candidates="exact",
        compute_dtype=jnp.float32)(fp, fs, jnp.asarray(canvases)))
    assert want["scores"].min() > THRESH  # every candidate is valid
    with torch.no_grad():
        got = make_infer_fn(tm, score_thresh=THRESH, iou_thresh=NMS_IOU,
                            top_k=TOP_K, use_pallas="never",
                            candidates="exact", compute_dtype=torch.float32)(
            tnet, torch.from_numpy(canvases))
    np.testing.assert_array_equal(got["classes"].numpy(), want["classes"])
    shifted = want["boxes"] + (want["classes"] * CLASS_OFFSET)[..., None]
    iou = np.asarray(jax_iou_matrix(jnp.asarray(shifted),
                                    jnp.asarray(shifted)))
    ts = got["boxes"] + (got["classes"].float() * CLASS_OFFSET)[..., None]
    iou_err = np.abs(iou_matrix(ts, ts).numpy() - iou).max()
    off_diag = ~np.eye(TOP_K, dtype=bool)[None].repeat(n, 0)
    assert np.abs(iou - NMS_IOU)[off_diag].min() > 2 * iou_err


# Random weights put boxes near the anchors, larger than the synthetic GT:
# at map_iou 0.1 some detections are hits, so the AP sums are not all zero.
@pytest.mark.parametrize("max_detections,coco,map_iou", [(0, False, 0.1),
                                                         (100, True, 0.5)])
def test_evaluate_model_matches_jax(eval_setup, max_detections, coco,
                                    map_iou):
    kw = dict(input_dim=DIM, batch_size=BATCH, nms_iou=NMS_IOU, top_k=TOP_K,
              use_pallas="never", candidates="exact", fuse_stem_impl="xla",
              max_detections=max_detections, coco=coco, map_iou=map_iou)
    jm = jax_get_model("yolo2", "darknet", 20)
    params, state = load_params_npz(eval_setup["npz"])
    want = jax_evaluate_model(
        jm, params, state,
        jax_cache.load_cache(eval_setup["cache_dir"], "test"),
        compute_dtype=jnp.float32, data_parallel=False, **kw)
    tm = get_model("yolo2", "darknet", 20)
    net = load_network_npz(eval_setup["npz"], tm)
    got = evaluate_model(tm, net, load_cache(eval_setup["cache_dir"], "test"),
                         compute_dtype=torch.float32, device="cpu", **kw)
    assert got["num_images"] == want["num_images"] == N_IMAGES
    assert got["num_detections"] == want["num_detections"] > 0
    if max_detections:
        assert got["num_detections"] == N_IMAGES * max_detections
    else:
        assert got["map"] > 0  # some hits, not only misses
    assert_metrics_equal(got, want, tol=1e-6)
    assert type(net.conv_0).__name__ == "ConvLayer"  # the caller's net kept


def test_cli_cache_and_eval(eval_setup, monkeypatch, capsys):
    """``cli.cache`` writes what yolojax's cache writes; ``cli.eval`` with
    the stem kernel's setting (its plain version on the CPU) prints the
    per-class APs, the mAP and COCO lines and a strict-JSON metrics line
    that agrees with its ``--dump``."""
    tmp = eval_setup["tmp"]
    cache_dir = str(tmp / "cli_cache")
    run_cli("yolojax_torch.cli.cache",
            ["-c", eval_setup["ini"], f"cache.basedir={cache_dir}"],
            monkeypatch)
    out = capsys.readouterr().out
    assert f"test: {N_IMAGES} images" in out
    ref = jax_cache.load_cache(eval_setup["cache_dir"], "test")
    got = load_cache(cache_dir, "test")
    for field in ("paths", "sizes", "offsets", "boxes", "classes",
                  "difficult"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))

    dump = str(tmp / "dump.json")
    run_cli("yolojax_torch.cli.eval",
            ["-c", eval_setup["ini"], "--weights", eval_setup["npz"],
             "--device", "cpu", "--coco", "--dump", dump,
             f"cache.basedir={cache_dir}", "detect.fuse_stem=pallas"],
            monkeypatch)
    lines = capsys.readouterr().out.splitlines()
    metrics = json.loads(lines[-1])
    assert metrics["num_images"] == N_IMAGES
    assert any(line.startswith("mAP@0.5: ") for line in lines)
    assert any(line.startswith("COCO AP@[.50:.95]: ") for line in lines)
    assert sum(line.startswith("AP ") for line in lines) == sum(
        k[3:].isdigit() for k in metrics if k.startswith("ap_"))
    assert all(v is None or math.isfinite(v) for v in metrics.values())
    with open(dump) as f:
        dumped = json.load(f)
    assert len(dumped["detections"]) == metrics["num_detections"] > 0
    assert len(dumped["gt"]["images"]) == N_IMAGES


@pytest.mark.parametrize("override", [
    "detect.use_int8=1", "eval.data_parallel=on", "eval.distributed=1",
    "detect.use_ema=1",
])
def test_cli_eval_unported_settings_raise(eval_setup, monkeypatch, capsys,
                                          override):
    """Each case of a setting the eval CLI once refused: ``use_int8`` now
    runs and must report metrics; ``eval.data_parallel=on`` (one device)
    and ``eval.distributed=1`` (one process) run as plain eval and must
    report its metrics; ``use_ema`` on an ``.npz`` still raises (the test
    keeps its name so each case keeps its identity)."""
    argv = ["-c", eval_setup["ini"], "--weights", eval_setup["npz"],
            "--device", "cpu", override]
    if override != "detect.use_ema=1":  # ported: the eval runs
        run_cli("yolojax_torch.cli.eval", argv, monkeypatch)
        metrics = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert metrics["num_images"] == N_IMAGES
        assert 0.0 <= metrics["map"] <= 1.0
        if override != "detect.use_int8=1":
            run_cli("yolojax_torch.cli.eval", argv[:-1], monkeypatch)
            plain = json.loads(capsys.readouterr().out.splitlines()[-1])
            assert metrics == plain
        return
    # EMA weights are read from training checkpoints, never from an .npz
    with pytest.raises(ValueError):
        run_cli("yolojax_torch.cli.eval", argv, monkeypatch)


def test_cli_eval_refuses_artifacts_and_bad_flags(eval_setup, monkeypatch):
    """``--artifact`` is ported (tests/test_torch_serve_cli.py scores one):
    a yolojax ``.yjsa`` is refused with the route to a port artifact, and
    ``--weights`` with ``--artifact`` is a usage error; a bad
    ``eval.data_parallel`` value is refused."""
    from yolojax.serve import MAGIC as JAX_MAGIC

    yjsa = eval_setup["tmp"] / "m.yjsa"
    blob = b'{"platforms": ["cpu"]}'
    yjsa.write_bytes(JAX_MAGIC + len(blob).to_bytes(4, "little") + blob)
    with pytest.raises(ValueError, match="yolojax_torch.cli.export"):
        run_cli("yolojax_torch.cli.eval",
                ["-c", eval_setup["ini"], "--artifact", str(yjsa),
                 "--device", "cpu"], monkeypatch)
    with pytest.raises(SystemExit):
        run_cli("yolojax_torch.cli.eval",
                ["-c", eval_setup["ini"], "--artifact", str(yjsa),
                 "--weights", eval_setup["npz"], "--device", "cpu"],
                monkeypatch)
    cfg = load_config([eval_setup["ini"]], ["eval.data_parallel=maybe"])
    with pytest.raises(ValueError, match="data_parallel"):
        cfg.eval.data_parallel_flag()
    assert load_config([eval_setup["ini"]], ["eval.data_parallel=off"]) \
        .eval.data_parallel_flag() is False


@pytest.fixture(scope="module")
def bn_eps_setup(tmp_path_factory):
    """A tiny-v2 ``.npz`` whose running variances lie in [5e-4, 2e-3],
    where the BN fold's eps matters (at 1e-3 conv_0's folded weights move
    by ~40% of their max), a four-image cache and an INI that sets
    ``[model] bn_eps = 0.001``."""
    tmp = tmp_path_factory.mktemp("bn_eps")
    model = get_model("yolo2", "tiny", 20)
    gen = torch.Generator().manual_seed(31)
    net = model.init(gen, DIM)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "var"):
                layer.var.uniform_(5e-4, 2e-3, generator=gen)
                layer.mean.normal_(0.0, 0.01, generator=gen)
                layer.scale.uniform_(0.02, 0.05, generator=gen)
    from yolojax_torch.convert.store import save_network_npz

    npz = str(tmp / "w.npz")
    save_network_npz(npz, model, net)
    voc = str(tmp / "voc")
    write_synthetic_voc(voc, n_images=4, size=(DIM, DIM), seed=5)
    build_cache(str(tmp / "cache"), "test",
                [{"kind": "voc", "root": voc, "image_set": "test"}])
    ini = tmp / "t.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        "bn_eps = 0.001\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\n"
        "[detect]\nthreshold = 0.005\ntop_k = 64\n[eval]\nbatch_size = 4\n")
    return {"npz": npz, "ini": str(ini)}


@pytest.mark.parametrize("entry", ["build_serving", "cli.eval"])
def test_bn_eps_setting_leaves_the_fold_at_1e5(bn_eps_setup, entry,
                                              monkeypatch, capsys):
    """yolojax parses ``[model] bn_eps`` but its detect and eval fold BN at
    ``fold_bn``'s default 1e-5; so does the port: ``build_serving``'s
    folded weights equal yolojax's 1e-5 fold bit for bit, and ``cli.eval``
    reports yolojax's ``cli/eval.py`` metrics on the same ``.npz``."""
    npz, ini = bn_eps_setup["npz"], bn_eps_setup["ini"]
    jm = jax_get_model("yolo2", "tiny", 20)
    _, want, _ = jax_fold_bn(jm, *load_params_npz(npz))
    if entry == "build_serving":
        from yolojax_torch.cli.detect import build_serving
        from yolojax_torch.convert.interchange import params_to_jax

        cfg = load_config([ini])
        assert cfg.model.bn_eps == 1e-3
        _, _, _, net, _ = build_serving(cfg, npz, device="cpu")
        folded = cfg.build_model()
        got, _ = params_to_jax(fold_bn(folded, load_network_npz(
            npz, folded))[0], net)
        for name, layer in want.items():
            for k, v in layer.items():
                np.testing.assert_array_equal(got[name][k], np.asarray(v),
                                              err_msg=name)
        return
    out = {}
    for key, module in (("jax", "cli.eval"), ("port", "yolojax_torch.cli.eval")):
        extra = ["--device", "cpu"] if key == "port" else []
        run_cli(module, ["-c", ini, "--weights", npz, *extra], monkeypatch)
        out[key] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["port"]["num_detections"] == out["jax"]["num_detections"] > 0
    assert_metrics_equal(out["port"], out["jax"], tol=1e-6)
