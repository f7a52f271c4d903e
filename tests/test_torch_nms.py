"""The port's NMS and postprocess against yolojax: the plain greedy sweep
equals, mask for mask, yolojax's lax sweep, its Pallas kernel (interpret
mode) and the numpy oracle; top-K ties follow ``lax.top_k``; the top-K
select's plain twin equals a stable descending sort bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolojax.postprocess import nms as jax_nms
from yolojax_torch.ops.boxes import iou_matrix
from yolojax_torch.postprocess import nms
from yolojax_torch.kernels import ops
from yolojax_torch.postprocess.cuda_nms import nms_greedy_cuda
from yolojax_torch.postprocess.cuda_topk import MAX_K, topk_select_cuda

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


def _word_block_sweep(boxes, valid, iou_thresh):
    """csrc/nms_greedy.cu's algorithm in torch: the build kernel's
    lower-triangle overlap words (bit b of word v of row i: IoU(i, 64v + b)
    > thr and 64v + b < i), then the sweep kernel's walk over 64-row word
    blocks: rows suppressed by the kept words of earlier blocks, a 32-step
    chain over the low halves of the diagonal words, the parallel clear of
    rows 32..63 by the kept rows 0..31, and a 32-step chain over the high
    halves."""
    n, k = valid.shape
    words = -(-k // 64)
    pad = 64 * words - k
    thr = torch.tensor(iou_thresh, dtype=torch.float32)
    ov = (iou_matrix(boxes, boxes) > thr) & torch.ones(k, k, dtype=torch.bool).tril(-1)
    ov = torch.nn.functional.pad(ov, (0, pad, 0, pad))
    shifts = torch.arange(64, dtype=torch.int64)
    bits = (ov.reshape(n, 64 * words, words, 64).long() << shifts).sum(-1)
    cand_all = torch.nn.functional.pad(valid.bool(), (0, pad))
    low = 0xFFFFFFFF
    keep = torch.zeros((n, 64 * words), dtype=torch.bool)
    kept_words = []
    for w in range(words):
        rows = slice(64 * w, 64 * w + 64)
        hit = torch.zeros((n, 64), dtype=torch.bool)
        for v in range(w):
            hit |= (bits[:, rows, v] & kept_words[v][:, None]) != 0
        cand = cand_all[:, rows] & ~hit
        d = bits[:, rows, w]
        kept_a = torch.zeros(n, dtype=torch.int64)
        for i in range(32):
            take = cand[:, i] & ((d[:, i] & low & kept_a) == 0)
            kept_a |= take.long() << i
        cand_b = cand[:, 32:] & ((d[:, 32:] & low & kept_a[:, None]) == 0)
        kept_b = torch.zeros(n, dtype=torch.int64)
        for i in range(32):
            take = cand_b[:, i] & ((((d[:, 32 + i] >> 32) & low) & kept_b) == 0)
            kept_b |= take.long() << i
        kept = kept_a | (kept_b << 32)
        kept_words.append(kept)
        keep[:, rows] = ((kept[:, None] >> shifts) & 1).bool()
    return keep[:, :k]


WORD_BLOCK_CASES = {
    **{f"k{k}": (lambda r, k=k: _random_case(r, 3, k), 0.45)
       for k in (1, 63, 64, 65, 200, 1024)},
    "k256_class_offsets": (lambda r: _class_offset_case(r, 4, 256, 20), 0.4),
    "all_identical_k130": (lambda r: _identical_case(r, 2, 130), 0.5),
}


@pytest.mark.parametrize("case", sorted(WORD_BLOCK_CASES))
def test_word_block_sweep_equals_plain_sweep(case):
    make, thr = WORD_BLOCK_CASES[case]
    boxes, valid = make(np.random.RandomState(21))
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    want = nms.nms_greedy_torch(b, v, thr)
    got = _word_block_sweep(b, v, thr)
    assert torch.equal(got, want)
    assert want.any() or not v.any()
    if case.startswith("all_identical"):
        assert want[:, 0].all() and not want[:, 1:].any()


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


# ---------------------------------------------------------------------------
# the top-K select (csrc/topk_select.cu) and its plain twin
# ---------------------------------------------------------------------------


def _sorted_top(flat, k):
    v, i = torch.sort(flat, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def _signed_zeros(rng):
    x = rng.choice([-0.0, 0.0, 0.25, -0.25], (3, 700)).astype(np.float32)
    return x, 96


def _nans(rng):
    x = rng.uniform(0, 1, (2, 5000)).astype(np.float32)
    x[0, ::97] = np.nan
    x[1, 3::11] = np.nan  # more NaNs than K: they fill the top alone
    x[:, 5::13] = np.inf
    return x, 128


def _kth_ties(rng):
    # 300 distinct scores above 0.5, then 1,000 copies of 0.5: the K-th
    # value (K = 320) is tied, and only the first 20 copies are kept
    x = rng.uniform(0, 0.4, (2, 6000)).astype(np.float32)
    top = rng.choice(np.arange(6000), 1300, replace=False)
    x[:, top[:300]] = rng.uniform(0.6, 1.0, 300).astype(np.float32)
    x[:, top[300:]] = 0.5
    return x, 320


TOPK_CASES = {
    "random": lambda r: (r.uniform(0, 1, (4, 3001)).astype(np.float32), 256),
    "all_equal": lambda r: (np.full((2, 4096), 0.375, np.float32), 128),
    # eight levels: runs of ties thousands long, across every slice
    "eight_levels": lambda r: ((r.randint(0, 8, (3, 9000)) / 8).astype(
        np.float32), 256),
    "ties_at_kth": _kth_ties,
    "signed_zeros": _signed_zeros,
    "nan": _nans,
    "negative": lambda r: (-r.exponential(1.0, (2, 2500)).astype(
        np.float32), 200),
    # fewer scores than K (the post-process clips K to M*C)
    "fewer_than_k": lambda r: (r.uniform(0, 1, (2, 150)).astype(np.float32),
                               150),
    # M*C no multiple of any slice length, nor of 4
    "ragged": lambda r: (r.uniform(-1, 1, (2, 2999)).astype(np.float32), 64),
    "one_image": lambda r: (r.uniform(0, 1, (1, 16900)).astype(np.float32),
                            256),
    "k_1024": lambda r: ((r.randint(0, 64, (2, 30000)) / 64).astype(
        np.float32), 1024),
}


@pytest.mark.parametrize("slices", [1, 3, 7])
@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_select_twin_equals_stable_sort(case, slices):
    """The twin repeats the kernel's steps (key map, per-slice floor and
    histograms, k-th key, tie fill in index order, survivors' stable sort);
    scores and indices equal the stable sort's, bit for bit, whatever the
    first level's slice count."""
    x, k = TOPK_CASES[case](np.random.RandomState(31))
    flat = torch.from_numpy(x)
    want_v, want_i = _sorted_top(flat, k)
    got_v, got_i = nms.topk_select_torch(flat, k, slices)
    assert got_i.dtype == torch.int64 and got_v.dtype == torch.float32
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))


# every case but those lax.top_k may order otherwise than the stable sort:
# NaN, and -0.0 beside +0.0
TOPK_FINITE_CASES = sorted(set(TOPK_CASES) - {"nan", "signed_zeros"})


@pytest.mark.parametrize("slices", [1, 3, 7])
@pytest.mark.parametrize("case", TOPK_FINITE_CASES)
def test_topk_select_twin_equals_lax_top_k(case, slices):
    """On finite scores the twin's tie order is the reference's own:
    indices and values equal yolojax's ``lax.top_k`` at the same inputs."""
    x, k = TOPK_CASES[case](np.random.RandomState(31))
    want_v, want_i = lax.top_k(jnp.asarray(x), k)
    got_v, got_i = nms.topk_select_torch(torch.from_numpy(x), k, slices)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))


@pytest.mark.parametrize("length,k,want", [
    (1960, 128, [(1, 1960)]),
    (16900, 256, [(1, 16900)]),
    (851760, 256, [(35, 24336), (1, 8960)]),
    (1819440, 256, [(75, 24260), (1, 19200)]),
    (1819440, 1024, [(75, 24260), (4, 19200), (1, 4096)]),
])
def test_topk_plan_follows_the_shape(length, k, want):
    """One level where a row fits one CTA (v1, v2), two for YOLOv3's rows:
    slices of at most TOPK_MAX_SLICE keys, 16-byte aligned."""
    plan = nms.topk_plan(length, k)
    assert plan == want
    assert all(ls <= nms.TOPK_MAX_SLICE for _, ls in plan)
    assert all(ls % 4 == 0 for _, ls in plan[:-1])


def test_select_candidates_takes_the_twin_on_the_cpu():
    rng = np.random.RandomState(32)
    corners = torch.from_numpy(rng.uniform(0, 1, (2, 40, 4)).astype(
        np.float32))
    scores = torch.from_numpy((rng.randint(0, 5, (2, 40, 3)) / 5).astype(
        np.float32))
    before = topk_select_cuda.launches
    # K = 256 > M*C = 120: clipped to the 120 scores there are
    boxes, top, classes, valid = nms._select_candidates(corners, scores,
                                                        0.3, 256)
    want_v, want_i = _sorted_top(scores.reshape(2, 120), 120)
    assert torch.equal(top, want_v)
    assert torch.equal(classes, want_i % 3)
    assert torch.equal(boxes, torch.gather(
        corners, 1, (want_i // 3)[..., None].expand(-1, -1, 4)))
    assert torch.equal(valid, want_v > 0.3)
    assert topk_select_cuda.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("device,dtype,shape,k,error,match", [
    ("cpu", torch.float64, (2, 64), 8, TypeError, "float32"),
    ("cpu", torch.float16, (2, 64), 8, TypeError, "float32"),
    ("cpu", torch.float32, (64,), 8, ValueError, "want scores"),
    ("cpu", torch.float32, (2, 64), 65, ValueError, "outside"),
    ("cpu", torch.float32, (2, 64), 0, ValueError, "outside"),
    ("meta", torch.float32, (2, 4096), MAX_K + 1, ValueError, "> 1024"),
    ("meta", torch.float32, (2, 4096), 256, ValueError, "CUDA device"),
])
def test_topk_wrapper_refusals(device, dtype, shape, k, error, match):
    """What the kernel does not take raises; a tensor on neither the CPU
    nor a card never reaches the twin, and K above MAX_K raises wherever
    the kernel would run (a meta tensor stands in for the card here)."""
    scores = torch.zeros(shape, dtype=dtype, device=device)
    with pytest.raises(error, match=match):
        topk_select_cuda(scores, k)


def test_topk_wrapper_takes_large_k_on_the_cpu():
    # the twin has no shared-memory limit: K above MAX_K runs on the CPU
    flat = torch.from_numpy(np.random.RandomState(33).uniform(
        0, 1, (1, 3000)).astype(np.float32))
    got_v, got_i = topk_select_cuda(flat, 2000)
    want_v, want_i = _sorted_top(flat, 2000)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


def test_topk_fake_implementation_shapes():
    """The op's fake implementation (what torch.export traces): (N, k) f32
    values and (N, k) int64 indices, on the input's device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        scores = torch.empty((5, 1819440))
        vals, idx = ops.topk_select(scores, 256)
        assert vals.shape == idx.shape == (5, 256)
        assert vals.dtype == torch.float32 and idx.dtype == torch.int64
        assert vals.device == scores.device
