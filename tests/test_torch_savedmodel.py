"""TF SavedModel export of the port (``yolojax_torch/serve/savedmodel.py``,
the TF graph of ``serve/tf_graph.py``) against yolojax on the same weights.

Each f32 export goes through ``python -m yolojax_torch.cli.export --device
cpu --format savedmodel`` and serves what yolojax's live portable program
(f32, the plain sweep, exact top-K) serves on the same folded weights:
equal ``keep`` and ``classes``, ``boxes`` and ``scores`` within yolojax's
own SavedModel bounds (``tests/unit/test_savedmodel.py``). The models:
tiny-v2 (yolojax's test model), a YOLOv1 tiny (dense head, flatten) and
full-width Darknet-19 (route and reorg). The int8 program is held to
yolojax's live int8 program on one QuantizedModel, its codes to the
port's ``apply_int8`` bit for bit; a constant canvas pins the tie order of
``top_k``. (``tests/test_torch_tflite.py`` holds the cross-loading of the
two packages' SavedModels, which pays ``jax2tf``'s compile: the two files
take about the same time.)"""

import contextlib
import dataclasses
import io
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.convert.store import save_params_npz
from yolojax.eval.evaluator import make_infer_fn as jax_make_infer_fn
from yolojax.models import get_model as jax_get_model
from yolojax.nn import layers as jax_layers
from yolojax.ops.boxes import decode_v1 as jax_decode_v1
from yolojax.ops.boxes import decode_v2 as jax_decode_v2
from yolojax.ops.boxes import iou_matrix as jax_iou_matrix
from yolojax.quantize import ptq as jax_ptq
from yolojax_torch.cli import export as export_cli
from yolojax_torch.cli.detect import _read_rgb, build_serving
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_to_jax, quantized_from_jax
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.loader import write_ppm
from yolojax_torch.models import get_model
from yolojax_torch.ops.boxes import iou_matrix
from yolojax_torch.postprocess.nms import CLASS_OFFSET
from yolojax_torch.quantize import ptq
from yolojax_torch.serve.savedmodel import load_savedmodel, save_savedmodel
from yolojax_torch.serve.tf_graph import build_tf_program, export_spec

from .test_torch_layers import random_jax_weights
from .test_torch_ptq import HEAD_RTOL, folded_pair, images

tf = pytest.importorskip("tensorflow")
try:  # as the torch fixtures do: share the cores with the other workers
    tf.config.threading.set_intra_op_parallelism_threads(2)
    tf.config.threading.set_inter_op_parallelism_threads(2)
except RuntimeError:  # this process's TF runtime already started
    pass

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESH, NMS_IOU = 0.001, 0.45


@dataclasses.dataclass(frozen=True)
class Case:
    model: str
    inference: str
    classes: int
    anchors: object
    dim: int
    top_k: int
    batch: int
    thresh: float = THRESH
    nms_iou: float = NMS_IOU
    images_seed: int = 4


MODELS = {
    "tiny_v2": Case("yolo2", "tiny", 3, ((1.0, 1.0), (2.0, 2.0)), 64, 32, 2),
    "yolo1_tiny": Case("yolo", "tiny", 3, None, 64, 64, 2),
    # the weights, canvases and thresholds of tests/test_torch_slice.py:
    # with 400 candidates a Darknet-19 image mostly has near-ties closer
    # than the f32 error between two libraries' convs (~1e-6 in the scores
    # of torch-initialised weights: seed 3 swapped two candidates 2.8e-7
    # apart at ranks 48 and 49); these keep their margins, asserted below
    "darknet19": Case("yolo2", "darknet", 20, None, 64, 256, 2, 0.005, 0.4,
                      35),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_weights(key: str, seed: int, tmp, *, random_bn: bool = True):
    """The weights of ``MODELS[key]`` as an unfolded ``.npz`` with an INI
    beside it, BN-folded in the port (model, network) and, bit for bit the
    same, in yolojax (model, params). tiny-v2 and YOLOv1 tiny: the port's
    He init from ``seed`` with (``random_bn``) random BN statistics and
    biases; Darknet-19: ``tests/test_torch_slice.py``'s yolojax weights."""
    c = MODELS[key]
    tm = get_model(c.model, c.inference, c.classes, anchors=c.anchors)
    npz = os.path.join(tmp, f"{key}.npz")
    if key == "darknet19":
        jm = jax_get_model(c.model, c.inference, c.classes)
        params, state = random_jax_weights(jm, c.dim, seed=34)
        gain = np.tile(np.r_[np.full(4, 0.05), np.full(21, 0.25)], 5)
        params["conv_30"]["w"] = (params["conv_30"]["w"] * gain).astype(
            np.float32)
        save_params_npz(npz, params, state)
        net = load_network_npz(npz, tm)
    else:
        gen = torch.Generator().manual_seed(seed)
        net = tm.init(gen, c.dim)
        if random_bn:
            with torch.no_grad():
                for layer in net.children():
                    if hasattr(layer, "mean"):
                        layer.mean.normal_(0.0, 0.1, generator=gen)
                        layer.var.uniform_(0.5, 1.5, generator=gen)
                        layer.scale.uniform_(0.5, 1.5, generator=gen)
                        layer.bias.normal_(0.0, 0.1, generator=gen)
                    elif hasattr(layer, "b"):
                        layer.b.normal_(0.0, 0.1, generator=gen)
        save_network_npz(npz, tm, net)
    names = os.path.join(tmp, "names.txt")
    with open(names, "w") as f:
        f.write("\n".join(f"class{i}" for i in range(c.classes)) + "\n")
    ini = os.path.join(tmp, f"{key}.ini")
    with open(ini, "w") as f:
        f.write(f"[model]\nmodel = {c.model}\ninference = {c.inference}\n"
                f"dim = {c.dim}\nnames_file = {names}\n"
                + (f"anchors = {' '.join(f'{w},{h}' for w, h in c.anchors)}\n"
                   if c.anchors else "")
                + f"[detect]\nthreshold = {c.thresh}\nnms_iou = {c.nms_iou}\n"
                f"top_k = {c.top_k}\n")
    ftm, fnet = fold_bn(tm, net)
    jm = jax_get_model(c.model, c.inference, c.classes, anchors=c.anchors)
    jm = dataclasses.replace(jm, specs=tuple(
        dataclasses.replace(s, bn=False)
        if isinstance(s, jax_layers.ConvSpec) else s for s in jm.specs))
    return {"tm": ftm, "net": fnet, "jm": jm,
            "params": params_to_jax(ftm, fnet)[0], "npz": npz, "ini": ini}


def jax_portable(jm, top_k, qm=None, thresh=THRESH, nms_iou=NMS_IOU):
    """yolojax's live portable serving program (``cli/detect.py::
    build_serving(portable=True)``)."""
    return jax_make_infer_fn(jm, score_thresh=thresh, iou_thresh=nms_iou,
                             top_k=top_k, use_pallas="never",
                             candidates="exact", compute_dtype=jnp.float32,
                             qm=qm)


def assert_margins(w, c: Case, x, got, want, tf_head):
    """The inputs' margins exceed the numeric error, so that a keep or
    class mismatch is a fault and not a near-tie: twice the largest score
    error (the TF program's head against yolojax's, both decoded by
    yolojax) stays below the smallest gap between consecutive top-(K+1)
    scores, and twice the largest IoU error below the smallest |IoU - thr|
    of any candidate pair."""
    jm = w["jm"]
    head = np.asarray(jax.jit(lambda p, x: jm.apply(
        p, {}, x, compute_dtype=jnp.float32)[0])(w["params"], x))

    def scores(h):
        if jm.kind == "v2":
            dec = jax_decode_v2(jnp.asarray(h), jm.anchors)
        else:
            dec = jax_decode_v1(jnp.asarray(h), jm.grid, jm.boxes_per_cell,
                                jm.num_classes)
        return np.asarray(dec["scores"]).reshape(len(x), -1)

    want_scores = scores(head)
    score_err = np.abs(scores(tf_head) - want_scores).max()
    k = want["keep"].shape[1]
    top = -np.sort(-want_scores, axis=1)[:, :k + 1]
    assert np.diff(-top, axis=1).min() > 2 * score_err

    def iou(o):
        b = o["boxes"] + (o["classes"] * CLASS_OFFSET)[..., None]
        return np.asarray(jax_iou_matrix(jnp.asarray(b, jnp.float32),
                                         jnp.asarray(b, jnp.float32)))

    want_iou = iou(want)
    off_diag = ~np.eye(k, dtype=bool)[None].repeat(len(x), 0)
    assert (np.abs(want_iou - c.nms_iou)[off_diag].min()
            > 2 * np.abs(iou(got) - want_iou).max())


def run_export(argv) -> str:
    """``python -m yolojax_torch.cli.export ...`` in this process; its
    last printed line."""
    out = io.StringIO()
    with mock.patch.object(sys, "argv", ["export", *argv]), \
            contextlib.redirect_stdout(out):
        export_cli.main()
    return out.getvalue().strip().splitlines()[-1]


def explain_keep(got, want, b, i):
    """Why rank ``i`` of image ``b`` was kept on one side only: the IoUs
    of its box with the earlier boxes kept on both sides, nearest the
    threshold first, and its score's distance to its neighbours."""
    def shifted(o):
        return torch.from_numpy(o["boxes"][b] + (
            o["classes"][b] * CLASS_OFFSET)[:, None].astype(np.float32))

    lines = []
    for side, o in (("got", got), ("want", want)):
        iou = iou_matrix(shifted(o), shifted(o)).numpy()[i, :i]
        kept = np.flatnonzero(o["keep"][b][:i])
        near = sorted(kept, key=lambda j: abs(iou[j] - NMS_IOU))[:3]
        s = o["scores"][b]
        lines.append(f"{side}: score {s[i]!r} (neighbours "
                     f"{s[max(i - 1, 0)]!r}, {s[min(i + 1, len(s) - 1)]!r}), "
                     f"IoU with earlier kept " + ", ".join(
                         f"#{j} {iou[j]!r}" for j in near))
    return "; ".join(lines)


def assert_detections(got, want, *, atol, rtol, kept_only=False):
    """Equal keep masks (a difference names its near-tie), then classes
    equal and boxes and scores within the bounds, on every row or on the
    kept rows only."""
    assert sorted(got) == ["boxes", "classes", "keep", "scores"]
    diff = np.argwhere(got["keep"] != want["keep"])
    assert not diff.size, (f"keep differs at (image, rank) {diff[:4].tolist()}"
                           f": {explain_keep(got, want, *diff[0])}")
    sel = want["keep"] if kept_only else np.ones_like(want["keep"])
    np.testing.assert_array_equal(got["classes"][sel], want["classes"][sel])
    for k in ("boxes", "scores"):
        np.testing.assert_allclose(got[k][sel], want[k][sel], atol=atol,
                                   rtol=rtol, err_msg=k)


@pytest.fixture(scope="module", params=sorted(MODELS))
def exported(request, tmp_path_factory):
    """One model's weights exported through the CLI at its batch."""
    key = request.param
    tmp = str(tmp_path_factory.mktemp(key))
    w = make_weights(key, 3, tmp)
    out = os.path.join(tmp, "sm")
    line = run_export(["-c", w["ini"], "--weights", w["npz"], "--out", out,
                       "--format", "savedmodel", "--batch",
                       str(MODELS[key].batch), "--device", "cpu"])
    return dict(w, key=key, out=out, line=line)


def test_savedmodel_matches_yolojax(exported):
    """The CLI's SavedModel against yolojax's live portable program on the
    same weights and canvases."""
    c = MODELS[exported["key"]]
    assert exported["line"] == (
        f"{exported['out']}: {c.model}/{c.inference} dim={c.dim} "
        f"batch={c.batch} format=savedmodel platforms=cpu")
    meta, serve_fn = load_savedmodel(exported["out"])
    assert meta["format"] == "savedmodel" and meta["platforms"] == ["cpu"]
    assert meta["int8"] is False and meta["top_k"] == c.top_k
    x = images(c.images_seed, c.batch, c.dim)
    want = {k: np.asarray(v) for k, v in jax.device_get(jax_portable(
        exported["jm"], c.top_k, thresh=c.thresh, nms_iou=c.nms_iou)(
            exported["params"], {}, jnp.asarray(x))).items()}
    got = serve_fn(x)
    prog = build_tf_program(export_spec(exported["tm"], exported["net"]),
                            score_thresh=c.thresh, iou_thresh=c.nms_iou,
                            top_k=c.top_k)
    assert_margins(exported, c, x, got, want,
                   prog.head(tf.constant(x)).numpy())
    assert_detections(got, want, atol=1e-5, rtol=1e-4)
    assert got["keep"].any()
    # the variables hold the weights: the graph file stays small
    assert os.path.getsize(os.path.join(exported["out"],
                                        "saved_model.pb")) < 2 ** 20


def test_savedmodel_serves_under_plain_tf(tmp_path):
    """A TF host with neither package: the signatures' dtypes and shapes,
    ``class_names``, and the fixed input shape (another batch is
    refused)."""
    w = make_weights("tiny_v2", 5, str(tmp_path))
    path = str(tmp_path / "sm")
    save_savedmodel(path, export_spec(w["tm"], w["net"]), batch=2, dim=64,
                    meta={"names": ["a", "b", "c"]}, score_thresh=THRESH,
                    iou_thresh=NMS_IOU, top_k=32)
    mod = tf.saved_model.load(path)
    sig = mod.signatures["serving_default"]
    out = sig(images=tf.zeros((2, 64, 64, 3), tf.float32))
    # dim 64 tiny-v2: 2x2 grid x 2 anchors x 3 classes = 24 candidates
    # (top_k=32 clamps to the candidate count)
    assert {k: (v.dtype, tuple(v.shape)) for k, v in out.items()} == {
        "boxes": (tf.float32, (2, 24, 4)), "scores": (tf.float32, (2, 24)),
        "classes": (tf.int32, (2, 24)), "keep": (tf.bool, (2, 24))}
    names = mod.signatures["class_names"]()["names"].numpy()
    assert [n.decode() for n in names] == ["a", "b", "c"]
    with pytest.raises((TypeError, ValueError,
                        tf.errors.InvalidArgumentError)):
        mod.serve(tf.zeros((1, 64, 64, 3), tf.float32))


# anchors two cells wide, one cell apart, overlap by IoU 1/3: suppressed
TIE_IOU = 0.3


def tie_weights(tmp):
    """Tiny-v2 at dim 128 from yolojax's initialisation (unit BN, zero
    biases) but a random head bias: on a constant zero canvas every conv
    of the trunk gives exact zeros, so the head is its bias in every cell
    and each (anchor, class) score ties across the 16 cells. Top-K then
    cuts 32 of 96 candidates inside tie groups, and at ``TIE_IOU`` the
    sweep's result depends on their order."""
    w = make_weights("tiny_v2", 7, tmp, random_bn=False)
    with torch.no_grad():
        w["net"].conv_14.b.normal_(0.0, 1.0,
                                   generator=torch.Generator().manual_seed(7))
    w["params"] = params_to_jax(w["tm"], w["net"])[0]
    return w


def check_ties(w, serve_fn):
    """``serve_fn`` on a zero canvas against yolojax on the weights ``w``
    of :func:`tie_weights`: the same candidates in the same order, so the
    same classes, boxes and keep mask."""
    x = np.zeros((1, 128, 128, 3), np.float32)
    want = {k: np.asarray(v) for k, v in jax.device_get(jax_portable(
        w["jm"], 32, nms_iou=TIE_IOU)(w["params"], {},
                                      jnp.asarray(x))).items()}
    # most scores tie: 32 candidates, at most three distinct scores
    assert len(np.unique(want["scores"])) <= 3
    got = serve_fn(x)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5,
                               rtol=1e-4)
    assert 0 < want["keep"].sum() < 32


@pytest.fixture(scope="module")
def ties(tmp_path_factory):
    return tie_weights(str(tmp_path_factory.mktemp("ties")))


def test_constant_canvas_tie_order(ties, tmp_path):
    """``tf.math.top_k`` takes tied scores lower index first, as
    ``lax.top_k`` does: a constant canvas where most scores tie gives
    yolojax's classes, boxes and keep mask."""
    path = str(tmp_path / "sm")
    save_savedmodel(path, export_spec(ties["tm"], ties["net"]), batch=1,
                    dim=128, meta={"names": ["a", "b", "c"]},
                    score_thresh=THRESH, iou_thresh=TIE_IOU, top_k=32)
    check_ties(ties, load_savedmodel(path)[1])


def test_int8_savedmodel_matches_yolojax(tmp_path):
    """The int8 program from one QuantizedModel (yolojax's, carried across)
    against yolojax's live int8 program: equal classes and keep masks,
    scores and boxes within the bf16 head's error. The weights and seed
    are ``tests/test_torch_int8_serving.py``'s, whose margins exceed that
    error."""
    dim, top_k, thresh, seed = 32, 8, 0.005, 25
    tm, net, jm, params = folded_pair("yolo2", "tiny", 20, dim, seed)
    gain = np.tile(np.r_[np.full(4, 0.05), np.ones(21)], 5).astype(np.float32)
    params["conv_14"]["w"] = params["conv_14"]["w"] * gain
    with torch.no_grad():
        net.conv_14.w.mul_(torch.from_numpy(gain)[:, None, None, None])
    jqm = jax_ptq.quantize_model(jm, params, jnp.asarray(images(seed, 2, dim)))
    qm = quantized_from_jax(tm, jqm)
    path = str(tmp_path / "int8")
    meta = save_savedmodel(path, export_spec(tm, net, qm), batch=2, dim=dim,
                           meta={"names": ["x"] * 20, "int8": True},
                           score_thresh=thresh, iou_thresh=NMS_IOU,
                           top_k=top_k)
    assert meta["int8"] is True
    x = images(seed + 1, 2, dim)
    want = jax.device_get(jax_make_infer_fn(
        jm, qm=jqm, score_thresh=thresh, iou_thresh=NMS_IOU, top_k=top_k,
        use_pallas="never", candidates="exact",
        compute_dtype=jnp.float32)({}, {}, jnp.asarray(x)))
    got = load_savedmodel(path)[1](x)
    assert_detections(got, {k: np.asarray(v) for k, v in want.items()},
                      atol=1e-3, rtol=0)
    assert got["keep"].any()


@pytest.mark.parametrize("case", ["tiny_v2_int8_stem", "darknet19",
                                  "yolo1_tiny"])
def test_int8_program_codes_match_port(case):
    """Every int8 code of the TF program equals the port's ``apply_int8``
    (itself bit-exact against ``jax.jit(apply_int8)``), bit for bit: the
    int8 stem, 1x1 and 3x3 convs, pools, route and reorg, the dense layers;
    the bf16 head within ``HEAD_RTOL`` of its max."""
    name, inference, dim = {"tiny_v2_int8_stem": ("yolo2", "tiny", 32),
                            "darknet19": ("yolo2", "darknet", 64),
                            "yolo1_tiny": ("yolo", "tiny", 32)}[case]
    tm, net, _, _ = folded_pair(name, inference, 20, dim, 11)
    qm = ptq.quantize_model(tm, net, torch.from_numpy(images(11, 2, dim)))
    if case.endswith("stem"):
        qm = ptq.fuse_stem_int8(qm)
        assert type(qm.model.specs[0]).__name__ == "StemSpec"
    x = images(12, 2, dim)
    want_codes = []
    want = ptq.apply_int8(qm, torch.from_numpy(x), codes=want_codes).numpy()
    prog = build_tf_program(export_spec(tm, net, qm), score_thresh=THRESH,
                            iou_thresh=NMS_IOU, top_k=32)
    codes = []
    got = prog.head(tf.constant(x), codes=codes).numpy()
    assert len(codes) == len(want_codes)
    for i, (g, w) in enumerate(zip(codes, want_codes)):
        np.testing.assert_array_equal(g.numpy(), w.numpy().astype(np.float32),
                                      err_msg=f"requant {i}")
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=HEAD_RTOL * np.abs(want).max())


def test_cli_int8_savedmodel_matches_the_live_int8_program(tmp_path):
    """``cli.export --format savedmodel detect.use_int8=1 --calib-image``
    with the int8 stem (``detect.fuse_stem=xla``, kept in portable builds
    as yolojax keeps it): the SavedModel serves what the port's live int8
    program, calibrated on the same canvases, serves."""
    w = make_weights("tiny_v2", 13, str(tmp_path))
    rng = np.random.RandomState(13)
    ppms = []
    for i, (h, wd) in enumerate(((48, 64), (64, 40))):
        p = str(tmp_path / f"c{i}.ppm")
        write_ppm(p, rng.randint(0, 256, (h, wd, 3), np.uint8))
        ppms.append(p)
    out = str(tmp_path / "int8")
    overrides = ["detect.use_int8=1", "detect.fuse_stem=xla"]
    line = run_export(["-c", w["ini"], "--weights", w["npz"], "--out", out,
                       "--format", "savedmodel", "--batch", "2",
                       "--device", "cpu", "--calib-image", ppms[0],
                       "--calib-image", ppms[1], *overrides])
    assert line.endswith("format=savedmodel platforms=cpu")
    cfg = load_config([w["ini"]], overrides)
    canvases = [letterbox_host(_read_rgb(p), 64)[0] for p in ppms]
    _, _, infer_fn, net, _ = build_serving(cfg, w["npz"], canvases,
                                           device="cpu", portable=True)
    assert type(infer_fn.qm.model.specs[0]).__name__ == "StemSpec"
    x = images(14, 2, 64)
    want = {k: v.numpy() for k, v in
            infer_fn(net, torch.from_numpy(x)).items()}
    want["classes"] = want["classes"].astype(np.int32)
    meta, serve_fn = load_savedmodel(out)
    assert meta["int8"] is True
    assert_detections(serve_fn(x), want, atol=1e-3, rtol=0)


def test_build_serving_portable(tmp_path, caplog):
    """``build_serving(portable=True)``: f32 weights, the plain sweep and
    exact top-K, and ``detect.fuse_stem`` turned off with yolojax's
    warning; its program equals the TF program within the SavedModel
    bounds."""
    w = make_weights("tiny_v2", 15, str(tmp_path))
    cfg = load_config([w["ini"]], ["detect.fuse_stem=pallas"])
    with caplog.at_level("WARNING", logger="detect"):
        _, _, infer_fn, net, _ = build_serving(cfg, w["npz"], device="cpu",
                                               portable=True)
    assert ("portable export: detect.fuse_stem=pallas disabled (fused stems "
            "are TPU-layout-specific)") in caplog.text
    assert not any(type(s).__name__ == "StemSpec"
                   for s in infer_fn.model.specs)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    x = images(16, 2, 64)
    want = {k: v.numpy() for k, v in
            infer_fn(net, torch.from_numpy(x)).items()}
    want["classes"] = want["classes"].astype(np.int32)
    prog = build_tf_program(export_spec(infer_fn.model, net), score_thresh=THRESH,
                            iou_thresh=NMS_IOU, top_k=32)
    got = {k: v.numpy() for k, v in prog(tf.constant(x)).items()}
    assert_detections(got, want, atol=1e-5, rtol=1e-4)
