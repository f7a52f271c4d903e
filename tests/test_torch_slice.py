"""The whole serving slice on the CPU: yolojax's ``make_infer_fn`` (f32,
lax NMS, exact top-K) against the port's ``build_detector(device="cpu")``
on one Darknet-19 ``.npz``, plus the letterbox preprocessing."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.convert.store import load_params_npz, save_params_npz
from yolojax.data.augment import letterbox_host as jax_letterbox_host
from yolojax.eval.evaluator import make_infer_fn as jax_make_infer_fn
from yolojax.models import get_model as jax_get_model
from yolojax.ops.boxes import decode_v2 as jax_decode_v2
from yolojax.ops.boxes import iou_matrix as jax_iou_matrix
from yolojax_torch.cli.detect import build_detector, run_detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.models import get_model
from yolojax_torch.ops.boxes import decode_v2, iou_matrix
from yolojax_torch.postprocess.nms import CLASS_OFFSET

from .test_torch_layers import random_jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, THRESH, NMS_IOU, TOP_K = 64, 0.005, 0.4, 256
# A seed whose top-256 scores and IoUs stay clear of ties by more than the
# f32 numeric error (asserted in the test): with 400 candidates per image
# most seeds have near-ties closer than the ~1e-7 score error.
WEIGHTS_SEED, IMAGES_SEED = 34, 35


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    ini = tmp / "slice.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = darknet\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[detect]\nthreshold = {THRESH}\nnms_iou = {NMS_IOU}\n"
        f"top_k = {TOP_K}\n[eval]\nbatch_size = 4\n")
    jm = jax_get_model("yolo2", "darknet", 20)
    params, state = random_jax_weights(jm, DIM, seed=WEIGHTS_SEED)
    # Random He weights give head logits of a few units: exp(tw) then blows
    # box sizes up to many image widths. Shrink the head's box channels
    # (tx..th) to x0.05 and the score channels to x0.25, so boxes sit near
    # their anchors and every one of the 256 candidates clears the floor.
    gain = np.tile(np.r_[np.full(4, 0.05), np.full(21, 0.25)], 5)
    params["conv_30"]["w"] = (params["conv_30"]["w"] * gain).astype(np.float32)
    npz = str(tmp / "darknet19.npz")
    save_params_npz(npz, params, state)
    canvases = np.random.RandomState(IMAGES_SEED).uniform(
        0, 1, (2, DIM, DIM, 3)).astype(np.float32)
    return str(ini), npz, jm, canvases


def test_slice_matches_jax(slice_setup):
    ini, npz, jm, canvases = slice_setup
    # yolojax side: the serving program as cli/detect.py builds it off-TPU
    fm, fparams, fstate = jax_fold_bn(jm, *load_params_npz(npz))
    jinfer = jax_make_infer_fn(fm, score_thresh=THRESH, iou_thresh=NMS_IOU,
                               top_k=TOP_K, use_pallas="never",
                               candidates="exact", compute_dtype=jnp.float32)
    want = jax.device_get(jinfer(fparams, fstate, jnp.asarray(canvases)))
    # the port
    cfg = load_config([ini])
    names, dim, infer = build_detector(cfg, npz, device="cpu")
    assert dim == DIM and len(names) == 20
    got = infer(canvases)

    # The seed's margins must exceed the numeric error, so that a mismatch
    # below is a fault and not a near-tie: twice the largest score error,
    # port vs yolojax, stays below the smallest gap between consecutive
    # top-K scores, and twice the largest IoU error below the smallest
    # |IoU - thr| of any candidate pair.
    head = np.asarray(jax.jit(lambda p, s, x: fm.apply(
        p, s, x, compute_dtype=jnp.float32)[0])(fparams, fstate, canvases))
    tm0 = get_model("yolo2", "darknet", 20)
    tm, tnet = fold_bn(tm0, load_network_npz(npz, tm0))
    with torch.no_grad():
        thead = tm.apply(tnet, torch.from_numpy(canvases),
                         compute_dtype=torch.float32)
    n = canvases.shape[0]
    jscores = np.asarray(jax_decode_v2(jnp.asarray(head), jm.anchors)
                         ["scores"]).reshape(n, -1)
    tscores = decode_v2(thead, tm.anchors)["scores"].numpy().reshape(n, -1)
    score_err = np.abs(tscores - jscores).max()
    top = -np.sort(-jscores, axis=1)[:, :TOP_K + 1]
    assert np.diff(-top, axis=1).min() > 2 * score_err
    assert want["scores"].min() > THRESH  # every candidate is valid
    shifted = want["boxes"] + (want["classes"] * CLASS_OFFSET)[..., None]
    iou = np.asarray(jax_iou_matrix(jnp.asarray(shifted), jnp.asarray(shifted)))
    tshifted = torch.from_numpy(
        got["boxes"] + (got["classes"] * CLASS_OFFSET)[..., None])
    iou_err = np.abs(iou_matrix(tshifted, tshifted).numpy() - iou).max()
    off_diag = ~np.eye(TOP_K, dtype=bool)[None].repeat(n, 0)
    assert np.abs(iou - NMS_IOU)[off_diag].min() > 2 * iou_err

    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_array_equal(got["keep"], want["keep"])
    # f32 forward in two libraries (summation order): a few ulps
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)
    assert 0 < got["keep"].sum() < got["keep"].size  # NMS suppressed some


def test_run_detect_on_decoded_arrays(slice_setup, capsys):
    ini, npz, _, _ = slice_setup
    cfg = load_config([ini], ["detect.threshold=0.03"])
    rng = np.random.RandomState(23)
    images = [rng.randint(0, 256, (70, 120, 3), np.uint8),
              rng.randint(0, 256, (96, 96, 3), np.uint8)]
    results = run_detect(cfg, npz, images, device="cpu")
    assert [r[0] for r in results] == ["image0", "image1"]
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == sum(len(r[2]) for r in results) > 0
    for (_, raw, dets), image in zip(results, images):
        assert np.array_equal(raw, image)
        for name, cls, score, (x0, y0, x1, y1) in dets:
            assert score > 0.03 and 0 <= cls < 20 and x0 < x1 and y0 < y1


@pytest.mark.parametrize("shape,dtype,stretch", [
    ((37, 53, 3), np.uint8, False),
    ((120, 90, 3), np.uint8, False),
    ((50, 40, 3), np.float32, False),
    ((37, 53, 3), np.uint8, True),
])
def test_letterbox_matches_cv2(shape, dtype, stretch):
    rng = np.random.RandomState(24)
    img = (rng.randint(0, 256, shape).astype(np.uint8) if dtype == np.uint8
           else rng.uniform(0, 1, shape).astype(np.float32))
    want, want_tf = jax_letterbox_host(img, 64, stretch=stretch)
    got, got_tf = letterbox_host(img, 64, stretch=stretch)
    assert got_tf == want_tf
    # bilinear half-pixel in two libraries: cv2 rounds its weights
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-4)
