"""The port's NMS and postprocess against yolojax: the plain greedy sweep
equals, mask for mask, yolojax's lax sweep, its Pallas kernel (interpret
mode) and the numpy oracle; top-K ties follow ``lax.top_k``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolojax.postprocess import nms as jax_nms
from yolojax_torch.postprocess import nms
from yolojax_torch.postprocess.cuda_nms import nms_greedy_cuda

from .unit.test_nms import _random_case, numpy_nms_oracle


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _class_offset_case(rng, n, k, num_classes):
    boxes, valid = _random_case(rng, n, k)
    classes = rng.randint(0, num_classes, (n, k))
    boxes = boxes + (classes.astype(np.float32) * jax_nms.CLASS_OFFSET)[..., None]
    return boxes.astype(np.float32), valid


def _identical_case(rng, n, k):
    boxes = np.tile(np.asarray([0.1, 0.1, 0.5, 0.5], np.float32), (n, k, 1))
    return boxes, np.ones((n, k), bool)


def _separation_case(rng, n, k):
    box = np.asarray([0.2, 0.2, 0.6, 0.6], np.float32)
    boxes = np.zeros((n, k, 4), np.float32)
    boxes[:, 0] = box
    boxes[:, 1] = box + 1 * jax_nms.CLASS_OFFSET
    valid = np.zeros((n, k), bool)
    valid[:, :2] = True
    return boxes, valid


CASES = {
    "n10_k128_chunk_pad": (lambda r: _random_case(r, 10, 128), 0.45),
    "k100": (lambda r: _random_case(r, 3, 100), 0.45),
    "k256_class_offsets": (lambda r: _class_offset_case(r, 4, 256, 20), 0.4),
    "all_identical": (lambda r: _identical_case(r, 2, 128), 0.5),
    "class_offset_separation": (lambda r: _separation_case(r, 1, 128), 0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_sweep_equals_lax_pallas_and_oracle(case):
    from jax.experimental.pallas import tpu as pltpu

    make, thr = CASES[case]
    boxes, valid = make(np.random.RandomState(11))
    got = nms.nms_greedy_torch(torch.from_numpy(boxes),
                               torch.from_numpy(valid), thr).numpy()
    jb, jv = jnp.asarray(boxes), jnp.asarray(valid)
    lax_keep = np.asarray(jax_nms.batched_nms(jb, jv, thr, use_pallas="never"))
    np.testing.assert_array_equal(got, lax_keep)
    with pltpu.force_tpu_interpret_mode():
        pallas_keep = np.asarray(jax_nms.batched_nms(jb, jv, thr,
                                                     use_pallas="always"))
    np.testing.assert_array_equal(got, pallas_keep)
    for i in range(boxes.shape[0]):
        np.testing.assert_array_equal(
            got[i], numpy_nms_oracle(boxes[i], valid[i], thr))
    if case == "all_identical":
        assert got[:, 0].all() and not got[:, 1:].any()
    if case == "class_offset_separation":
        assert got[0, 0] and got[0, 1]


def test_batched_nms_on_cpu_takes_the_plain_sweep():
    boxes, valid = _random_case(np.random.RandomState(12), 4, 128)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    want = nms.nms_greedy_torch(b, v, 0.45)
    before = nms_greedy_cuda.launches
    for use_pallas in ("auto", "always", "never"):
        got = nms.batched_nms(b, v, 0.45, use_pallas=use_pallas)
        assert torch.equal(got, want)
    assert nms_greedy_cuda.launches == before  # no kernel on the CPU
    with pytest.raises(ValueError):
        nms.batched_nms(b, v, 0.45, use_pallas="sometimes")


def test_kernel_wrapper_refuses_non_cuda_devices():
    # a tensor on neither the CPU nor a card must not reach the plain sweep
    b = torch.empty((2, 8, 4), device="meta")
    v = torch.empty((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        nms_greedy_cuda(b, v, 0.5)


def test_topk_ties_follow_lax():
    scores = np.asarray([[.5, .9, .5, .9, .1, .5]], np.float32)
    _, lax_idx = lax.top_k(jnp.asarray(scores), 4)
    assert torch.topk(torch.from_numpy(scores), 4).indices.tolist() \
        != np.asarray(lax_idx).tolist()  # the trap this test pins
    # through _select_candidates: M=3 boxes x C=2 classes
    corners = np.random.RandomState(13).uniform(0, 1, (1, 3, 4)).astype(
        np.float32)
    sc = scores.reshape(1, 3, 2)
    want = jax_nms._select_candidates(jnp.asarray(corners), jnp.asarray(sc),
                                      0.3, 4, candidates="exact")
    got = nms._select_candidates(torch.from_numpy(corners),
                                 torch.from_numpy(sc), 0.3, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_ties_many():
    # (2, 16900) scores quantised to 64 levels: long runs of ties
    rng = np.random.RandomState(14)
    flat = (rng.randint(0, 64, (2, 16900)) / 64.0).astype(np.float32)
    _, want = lax.top_k(jnp.asarray(flat), 256)
    got = torch.sort(torch.from_numpy(flat), dim=1, descending=True,
                     stable=True).indices[:, :256]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _head_v2(rng, n=2, h=5, w=5, a=5, c=20):
    head = rng.normal(0, 1.5, (n, h, w, a, 5 + c)).astype(np.float32)
    head[..., 2:4] *= 0.2  # box extents near the anchors: corners in ~[-1, 2]
    head[..., 4] += 1.0  # enough objectness that many candidates are valid
    return head


ANCHORS = ((1.3221, 1.73145), (3.19275, 4.00944), (5.05587, 8.09892),
           (9.47112, 4.84053), (11.2364, 10.0071))


def _assert_same_detections(got, want):
    np.testing.assert_array_equal(got["classes"].numpy(),
                                  np.asarray(want["classes"]))
    np.testing.assert_array_equal(got["keep"].numpy(), np.asarray(want["keep"]))
    # decode math (sigmoid/exp/softmax) in two libraries: a few ulps
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), rtol=0, atol=1e-6)


def test_postprocess_v2_matches_jax():
    head = _head_v2(np.random.RandomState(15))
    kw = dict(score_thresh=0.05, iou_thresh=0.4, top_k=128)
    want = jax_nms.postprocess_v2(jnp.asarray(head), ANCHORS, **kw,
                                  use_pallas="never", candidates="exact")
    got = nms.postprocess_v2(torch.from_numpy(head), ANCHORS, **kw)
    assert got["keep"].sum() > 10
    _assert_same_detections(got, want)


def test_postprocess_v1_matches_jax():
    s, b, c = 7, 2, 20
    rng = np.random.RandomState(16)
    flat = np.concatenate([
        rng.dirichlet(np.ones(c), (1, s * s)).reshape(1, -1),
        rng.uniform(0, 1, (1, s * s * b)),
        rng.uniform(0.05, 0.95, (1, s * s * b * 4)),
    ], -1).astype(np.float32)
    kw = dict(score_thresh=0.05, iou_thresh=0.4, top_k=128)
    want = jax_nms.postprocess_v1(jnp.asarray(flat), s, b, c, **kw,
                                  use_pallas="never", candidates="exact")
    got = nms.postprocess_v1(torch.from_numpy(flat), s, b, c, **kw)
    assert got["keep"].sum() > 5
    _assert_same_detections(got, want)
