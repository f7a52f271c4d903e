"""YOLOv3 in the port (``models/yolo3.py``; no yolojax counterpart): the
forward and post-process against the benchmark's plain reference
(``benchmark/reference/yolo3.py``) at the published widths on seeded
weights, the residual epilogue's plain version, the Darknet cfg and
weights files, the names fallback, and the entry points that refuse it."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import detect as ref_detect
from benchmark.reference import network as ref_net
from benchmark.reference import yolo3 as ref_v3
from yolojax_torch.cli import detect as detect_cli
from yolojax_torch.config import COCO_NAMES, load_config
from yolojax_torch.convert.cfg import model_from_cfg
from yolojax_torch.convert.darknet import (
    load_darknet_weights,
    save_darknet_weights,
)
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import network_from_state_dict
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.models import get_model
from yolojax_torch.nn.layers import (
    ConvSpec,
    DropoutSpec,
    Network,
    ShortcutSpec,
    conv_epilogue_torch,
    residual_convs,
)
from yolojax_torch.ops.boxes import decode_v3
from yolojax_torch.postprocess.nms import postprocess_v3
from yolojax_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads(
    (ROOT / "benchmark/configs/yolo3-coco-608.json").read_text())
INI = ["model.model=yolo3", "model.num_classes=80", "model.dim=64",
       "detect.fuse_stem=off", "detect.threshold=0.005"]

# f32: the port and the reference run the same float32 operations up to
# summation order (measured 0: the same conv calls on the CPU)
F32_RTOL = 1e-4
# bf16: each conv's operands and outputs round to 8 significant bits, and
# the relative gap grows through 75 convs and 23 residual adds to 2.5-3.5%
# of a head's norm and 3-5% in a head's median box side (two seeds, inputs
# 64 and 96). A residual add dropped from one block moves a head by 57% or
# more, and two heads' masks swapped move that head's median side by a
# factor near 3 (log 1.1), so both limits sit ~3x above bf16 and far below
# either fault.
BF16_HEAD_RTOL = 0.1
BF16_SIDE_TOL = 0.2


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """torch at 2 threads: the full-width network on the CPU beside the
    suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def stored(tmp_path_factory):
    """(model, net, npz path): YOLOv3 with its BN vectors all distinct,
    written once through the ``.npz`` store."""
    model = get_model("yolo3", "darknet", 80)
    net = model.init(torch.Generator().manual_seed(7), 64)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1)
                layer.var.uniform_(0.5, 1.5)
                layer.scale.uniform_(0.5, 1.5)
                layer.bias.normal_(1.0, 0.2)
    npz = tmp_path_factory.mktemp("yolo3") / "yolov3.npz"
    save_network_npz(str(npz), model, net)
    yield model, net, str(npz)
    npz.unlink()  # 249 MB: not kept among pytest's last runs


@pytest.fixture(scope="module")
def seeded():
    """{dim: (model, folded net, reference config, reference weights)}."""
    out = {}
    for dim in (64, 96):
        config = dict(CONFIG, input=dim)
        w = ref_v3.make_weights(config, 1234 + dim, torch.device("cpu"))
        model = get_model("yolo3", "darknet", 80)
        fm, fnet = fold_bn(model, network_from_state_dict(model, w))
        out[dim] = (fm, fnet, config, w)
    return out


def reference(config, w, x):
    with torch.no_grad(), ref_net.float32_exact():
        return ref_v3.forward(config, ref_net.fold(config, w), x)


def gaps(model, net, x, config, ref_heads, dtype):
    """(the largest head gap: norm of the difference over the reference's
    norm; the largest head's median |log| ratio of decoded box sides)."""
    with torch.no_grad():
        heads = model.apply(net, x, compute_dtype=dtype)
    head = max(float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
               for a, b in zip(heads, ref_heads))
    dec = decode_v3(heads, model.anchors, model.masks, tuple(x.shape[1:3]))
    side = 0.0
    for d, r, mask in zip(dec, ref_heads, config["masks"]):
        rc, _ = ref_v3.decode([r], config["anchors"], [mask], x.shape[1])
        pc = d["corners"].reshape(rc.shape)
        sz = [torch.clamp(c[..., 2:] - c[..., :2], min=1e-6) for c in (pc, rc)]
        side = max(side, float((torch.log(sz[0]) - torch.log(sz[1])).abs()
                               .median()))
    return head, side


def images(dim, seed=5):
    return torch.rand((2, dim, dim, 3),
                      generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("dim", [64, 96])
def test_f32_matches_reference(seeded, dim):
    model, net, config, w = seeded[dim]
    x = images(dim)
    ref_heads = reference(config, w, x)
    with torch.no_grad():
        heads = model.apply(net, x, compute_dtype=torch.float32)
    assert len(heads) == 3
    for got, want, g in zip(heads, ref_heads, (dim // 32, dim // 16,
                                               dim // 8)):
        assert got.shape == want.shape == (2, g, g, 3, 85)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= F32_RTOL
    out = postprocess_v3(heads, model.anchors, model.masks, (dim, dim),
                         score_thresh=0.005, iou_thresh=0.45, top_k=256,
                         use_pallas="never")
    corners, scores = ref_v3.decode(ref_heads, config["anchors"],
                                    config["masks"], dim)
    want = ref_detect.detections(corners, scores, top_k=256,
                                 score_thresh=0.005, iou_thresh=0.45)
    assert torch.equal(out["keep"], want["keep"])
    assert torch.equal(out["classes"], want["classes"])
    kept = out["keep"]
    # a corner is a centre minus a half side, two f32 values near 1 that
    # the two decodes order differently: a few ulps of 1 apart
    torch.testing.assert_close(out["boxes"][kept], want["boxes"][kept],
                               rtol=F32_RTOL, atol=1e-5)


def _dropped_block(model, net, k=40):
    """The model with the residual add of the block ending at spec ``k``
    left out (an identity spec in its place)."""
    specs = list(model.specs)
    assert isinstance(specs[k], ShortcutSpec)
    specs[k] = DropoutSpec(0.0)
    m = dataclasses.replace(model, specs=tuple(specs))
    return m, Network(m.specs, dict(net.named_children()))


def _swapped_masks(model, net):
    m = model.masks
    return dataclasses.replace(model, masks=(m[0], m[2], m[1])), net


@pytest.mark.parametrize("dim,fault", [(64, None), (96, None),
                                       (64, "drop"), (64, "swap")])
def test_bf16_within_its_tolerance(seeded, dim, fault):
    """The plain bf16 path (the residual epilogue's plain version) within
    the tolerances, and each planted fault outside them."""
    model, net, config, w = seeded[dim]
    x = images(dim)
    ref_heads = reference(config, w, x)
    if fault == "drop":
        model, net = _dropped_block(model, net)
    elif fault == "swap":
        model, net = _swapped_masks(model, net)
    head, side = gaps(model, net, x, config, ref_heads, torch.bfloat16)
    within = head <= BF16_HEAD_RTOL and side <= BF16_SIDE_TOL
    assert within == (fault is None), (head, side)


@pytest.mark.parametrize("shape,bn", [((2, 13, 13, 64), False),
                                      ((3, 7, 5, 125), False),
                                      ((4, 9, 256), True),
                                      ((1, 1, 1, 8), False)])
def test_residual_twin_bit_equal(shape, bn):
    g = torch.Generator().manual_seed(sum(shape))
    c = shape[-1]
    y = (torch.randn(shape, generator=g) * 2).bfloat16()
    r = (torch.randn(shape, generator=g) * 2).bfloat16()
    b = torch.randn(c, generator=g)
    scale = torch.rand(c, generator=g) + 0.5 if bn else None
    got = conv_epilogue_torch(y, b, scale, r, leaky=True)
    want = conv_epilogue_torch(y, b, scale, leaky=True) + r
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_model_layout():
    model = get_model("yolo3", "darknet", 80)
    kinds = [type(s).__name__ for s in model.specs]
    assert len(kinds) == 107
    assert kinds.count("ConvSpec") == 75 and kinds.count("ShortcutSpec") == 23
    assert [i for i, k in enumerate(kinds) if k == "YoloSpec"] == [82, 94,
                                                                  106]
    res = residual_convs(model.specs)
    assert len(res) == 23 and all(j == i - 2 for i, j in res.items())
    assert model.masks == ((6, 7, 8), (3, 4, 5), (0, 1, 2))
    assert model.anchors[-1] == (373, 326)
    # the benchmark's layer list is the same network
    assert [l["type"] for l in CONFIG["layers"]] == [
        {"ConvSpec": "conv", "ShortcutSpec": "shortcut", "RouteSpec":
         "route", "UpsampleSpec": "upsample", "YoloSpec": "yolo"}[k]
        for k in kinds]


def _yolov3_cfg() -> str:
    """yolov3.cfg (Darknet's cfg/yolov3.cfg) as published: [net], the 107
    layers in order, with its keys."""
    out = ["[net]", "batch=64", "subdivisions=16", "width=608",
           "height=608", "channels=3", "momentum=0.9", "decay=0.0005",
           "learning_rate=0.001", ""]

    def conv(f, size, stride=1, bn=True, act="leaky"):
        out.extend(["[convolutional]"] + (["batch_normalize=1"] if bn else [])
                   + [f"filters={f}", f"size={size}", f"stride={stride}",
                      "pad=1", f"activation={act}", ""])

    def shortcut():
        out.extend(["[shortcut]", "from=-3", "activation=linear", ""])

    def yolo(mask):
        out.extend(["[yolo]", f"mask = {mask}",
                    "anchors = 10,13,  16,30,  33,23,  30,61,  62,45,  "
                    "59,119,  116,90,  156,198,  373,326",
                    "classes=80", "num=9", "jitter=.3", "ignore_thresh = .7",
                    "truth_thresh = 1", "random=1", ""])

    conv(32, 3)
    for width, n in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        conv(width, 3, 2)
        for _ in range(n):
            conv(width // 2, 1)
            conv(width, 3)
            shortcut()
    for width, mask, back in ((512, "6,7,8", None), (256, "3,4,5", 61),
                              (128, "0,1,2", 36)):
        if back is not None:
            out.extend(["[route]", "layers = -4", ""])
            conv(width, 1)
            out.extend(["[upsample]", "stride=2", "", "[route]",
                        f"layers = -1, {back}", ""])
        for _ in range(3):
            conv(width, 1)
            conv(2 * width, 3)
        conv(255, 1, bn=False, act="linear")
        yolo(mask)
    return "\n".join(out)


def test_cfg_parses_to_the_registry(tmp_path):
    path = tmp_path / "yolov3.cfg"
    path.write_text(_yolov3_cfg())
    got = model_from_cfg(str(path))
    want = get_model("yolo3", "darknet", 80)
    assert got.specs == want.specs
    assert (got.kind, got.num_classes, got.masks, got.downsample) == (
        "v3", 80, want.masks, 32)
    assert tuple(tuple(map(int, a)) for a in got.anchors) == want.anchors


def test_weights_files_round_trip(stored, tmp_path):
    model, net, npz = stored
    want = net.state_dict()
    weights = tmp_path / "yolov3.weights"
    save_darknet_weights(model, net, str(weights))
    try:
        # 75 convs: 72 with BN (4 vectors), 3 linear heads (a bias)
        n_floats = sum(v.numel() for v in want.values())
        assert weights.stat().st_size == 20 + 4 * n_floats
        got = load_darknet_weights(model, str(weights), input_dim=608)
    finally:
        weights.unlink()  # 249 MB
    for net_ in (got, load_network_npz(npz, model)):
        sd = net_.state_dict()
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)


def test_names():
    assert load_config([], ["model.num_classes=80"]).names() == COCO_NAMES
    assert COCO_NAMES == tuple(
        (ROOT / "config/names/coco.txt").read_text().split("\n")[:80])
    assert len(load_config([], ["model.num_classes=20"]).names()) == 20
    with pytest.raises(ValueError, match="num_classes=37"):
        load_config([], ["model.num_classes=37"]).names()


def _refusals():
    from yolojax_torch.cli import qat, train
    from yolojax_torch.eval.evaluator import evaluate_model, make_infer_fn
    from yolojax_torch.quantize.qat import QatConfig
    from yolojax_torch.serve import save_artifact

    def cfg(*extra):
        return load_config([], INI + list(extra))

    def serving(*extra, portable=False):
        return lambda: detect_cli.build_serving(
            cfg(*extra), "never-read.npz", device="cpu", portable=portable)

    model = get_model("yolo3", "darknet", 80)
    return {
        "train": (lambda: train.train(cfg(), device="cpu"), "YOLOv3 loss"),
        "qat": (lambda: qat.run_qat(cfg(), "never-read.npz", "out.npz",
                                    QatConfig(), device="cpu"), "cli.qat"),
        "int8": (serving("detect.use_int8=1"), "int8 trunk"),
        "int8-eval": (lambda: evaluate_model(
            model, None, None, input_dim=64, int8=True, device="cpu"),
            "int8 trunk"),
        "fuse-stem": (serving("detect.fuse_stem=pallas"), "2x2 pool"),
        "tf-export": (serving(portable=True), "TF graph"),
        "torch-export": (lambda: save_artifact(
            "never.yjts", make_infer_fn(model, score_thresh=0.3,
                                        iou_thresh=0.45, top_k=256),
            None, batch=1, dim=64, meta={}, device="cpu"), "exported"),
    }


@pytest.mark.parametrize("what", list(_refusals()))
def test_refusals_name_yolo3(what):
    call, missing = _refusals()[what]
    with pytest.raises(ValueError, match="yolo3") as err:
        call()
    assert missing in str(err.value)


def test_build_detector_records_the_detect_spans(stored):
    model, _, npz = stored
    profiling.clear_spans()
    infer = detect_cli.build_detector(load_config([], INI), npz,
                                      device="cpu")[2]
    x = np.random.RandomState(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = infer(x)
        got = profiling.spans()
    finally:
        profiling.clear_spans()
    assert {k: v.shape for k, v in out.items()} == {
        k: (2, 256) + s for k, s in (("boxes", (4,)), ("scores", ()),
                                     ("classes", ()), ("keep", ()))}
    assert [s.name for s in got] == ["detect.upload", "detect.dispatch",
                                     "detect.readback"]
    assert isinstance(model.specs[0], ConvSpec)


def test_cli_eval_and_detect_run_yolo3(stored, tmp_path, monkeypatch,
                                      capsys):
    """``cli.eval`` and ``cli.detect`` on a yolo3 config, at input 64 on the
    CPU: the same entry points as the v2 models, COCO's names."""
    import json as json_

    from yolojax_torch.data.cache import build_cache

    from .util import run_cli, write_synthetic_voc

    npz = stored[2]
    voc = str(tmp_path / "voc")
    write_synthetic_voc(voc, n_images=4, size=(80, 64), seed=5)
    build_cache(str(tmp_path / "cache"), "test",
                [{"kind": "voc", "root": voc, "image_set": "test"}])
    ini = tmp_path / "v3.ini"
    ini.write_text("[model]\nmodel = yolo3\nnum_classes = 80\ndim = 64\n"
                   f"[cache]\nbasedir = {tmp_path / 'cache'}\n"
                   "[detect]\nthreshold = 0.005\nnms_iou = 0.45\n"
                   "[eval]\nbatch_size = 2\n")
    run_cli("yolojax_torch.cli.eval", ["-c", str(ini), "--weights", npz,
                                       "--device", "cpu"], monkeypatch)
    metrics = json_.loads(capsys.readouterr().out.splitlines()[-1])
    assert metrics["num_images"] == 4 and metrics["num_detections"] > 0
    image = sorted((Path(voc) / "JPEGImages").iterdir())[0]
    run_cli("yolojax_torch.cli.detect", ["-c", str(ini), "--weights", npz,
                                         "--device", "cpu", "--image",
                                         str(image)], monkeypatch)
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(line.startswith(f"{image.name}: ") for line in lines)
    assert {line.split(": ")[1].rsplit(" ", 5)[0] for line in lines} <= set(
        COCO_NAMES)
