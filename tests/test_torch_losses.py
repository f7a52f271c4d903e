"""The port's YOLO v1/v2 losses against yolojax's on the same heads and
ground truth (f32 on the CPU), and against the numpy oracles of
``tests/unit/test_loss_oracle.py``: every term, and d total / d head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.train import losses as jax_losses
from yolojax_torch.train import losses
from yolojax_torch.train.losses import (
    YoloV1LossConfig,
    YoloV2LossConfig,
    yolo_v1_loss,
    yolo_v2_loss,
)

from .unit.test_loss_oracle import _random_v2_case, _v1_oracle, _v2_oracle

# f32 on both sides; sums over the grid run in other orders. Measured:
# terms agree to ~1e-7 relative, head gradients to ~1e-7 of max|g|.
TERM_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the oracles sum in float64 with loops (their own test's tolerance)
ORACLE_RTOL = 2e-4

V2_CFGS = {
    "default": YoloV2LossConfig(),
    # prior matching on; rescore and the (2 - w*h) coord weight off
    "all_branches": YoloV2LossConfig(
        coord_scale=2.0, object_scale=3.0, noobject_scale=0.7,
        class_scale=1.5, iou_thresh=0.4, rescore=False,
        coord_area_weight=False, prior_scale=0.01),
}
V1_CFGS = {
    "default": YoloV1LossConfig(),
    "no_sqrt_no_rescore": YoloV1LossConfig(coord_scale=3.0,
                                           noobject_scale=0.2, rescore=False,
                                           sqrt=False),
}


def v2_case(seed, tie):
    """The oracle's random case (duplicate-slot GT pair, garbage in the
    padding); ``tie`` makes two anchors identical, so every GT matched to
    either ties and the first must win, as ``jnp.argmax`` picks it."""
    head, anchors, gt_xywh, gt_class, gt_valid = _random_v2_case(seed)
    if tie:
        anchors = (anchors[0], anchors[0], anchors[2])
    return head, anchors, gt_xywh, gt_class, gt_valid


def v1_case(seed, s=5, b=2, c=3, g=6, n=2):
    rng = np.random.RandomState(seed)
    flat = rng.randn(n, s * s * (c + 5 * b)).astype(np.float32)
    gt_xywh = np.stack([
        rng.uniform(0.05, 0.95, (n, g)), rng.uniform(0.05, 0.95, (n, g)),
        rng.uniform(0.05, 0.6, (n, g)), rng.uniform(0.05, 0.6, (n, g)),
    ], axis=-1).astype(np.float32)
    gt_class = rng.randint(0, c, (n, g)).astype(np.int32)
    gt_valid = rng.rand(n, g) < 0.7
    gt_valid[:, 0] = True
    gt_xywh[:, 1, :2] = gt_xywh[:, 0, :2]  # duplicate cell: later wins
    gt_valid[:, 1] = True
    gt_xywh[~gt_valid] = rng.uniform(-5, 5, gt_xywh[~gt_valid].shape)
    return flat, (s, b, c), gt_xywh, gt_class, gt_valid


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_terms_close(got, want, rtol):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=rtol,
                                   atol=1e-7, err_msg=f"term {k!r}")


def assert_grad_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


@pytest.mark.parametrize("cfg_name", sorted(V2_CFGS))
@pytest.mark.parametrize("seed,tie", [(0, False), (1, True), (2, False)])
def test_v2_loss_and_grad_match_jax(seed, tie, cfg_name):
    cfg = V2_CFGS[cfg_name]
    head, anchors, gt_xywh, gt_class, gt_valid = v2_case(seed, tie)
    jcfg = jax_losses.YoloV2LossConfig(**cfg.__dict__)

    def jloss(h):
        return jax_losses.yolo_v2_loss(h, anchors, jnp.asarray(gt_xywh),
                                       jnp.asarray(gt_class),
                                       jnp.asarray(gt_valid), jcfg)

    want, want_grad = jax.jit(lambda h: (
        jloss(h), jax.grad(lambda x: jloss(x)["total"])(h)))(
        jnp.asarray(head))
    want_grad = np.asarray(want_grad)
    th = torch.from_numpy(head).requires_grad_(True)
    got = yolo_v2_loss(th, anchors, *_t(gt_xywh, gt_class, gt_valid), cfg)
    got["total"].backward()
    assert_terms_close(got, want, TERM_RTOL)
    assert_grad_close(th.grad.numpy(), want_grad)
    assert_terms_close(got, _v2_oracle(head, anchors, gt_xywh, gt_class,
                                       gt_valid, cfg), ORACLE_RTOL)


@pytest.mark.parametrize("cfg_name", sorted(V1_CFGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_v1_loss_and_grad_match_jax(seed, cfg_name):
    cfg = V1_CFGS[cfg_name]
    flat, (s, b, c), gt_xywh, gt_class, gt_valid = v1_case(seed)
    jcfg = jax_losses.YoloV1LossConfig(**cfg.__dict__)

    def jloss(f):
        return jax_losses.yolo_v1_loss(f, s, b, c, jnp.asarray(gt_xywh),
                                       jnp.asarray(gt_class),
                                       jnp.asarray(gt_valid), jcfg)

    want, want_grad = jax.jit(lambda f: (
        jloss(f), jax.grad(lambda x: jloss(x)["total"])(f)))(
        jnp.asarray(flat))
    want_grad = np.asarray(want_grad)
    tf = torch.from_numpy(flat).requires_grad_(True)
    got = yolo_v1_loss(tf, s, b, c, *_t(gt_xywh, gt_class, gt_valid), cfg)
    got["total"].backward()
    assert_terms_close(got, want, TERM_RTOL)
    assert_grad_close(tf.grad.numpy(), want_grad)
    assert_terms_close(got, _v1_oracle(flat, s, b, c, gt_xywh, gt_class,
                                       gt_valid, cfg), ORACLE_RTOL)


def test_duplicate_slot_mask_matches_jax():
    rng = np.random.RandomState(4)
    slot = rng.randint(0, 5, (3, 9)).astype(np.int32)
    valid = rng.rand(3, 9) < 0.7
    want = np.asarray(jax_losses._mask_duplicate_slots(jnp.asarray(slot),
                                                       jnp.asarray(valid)))
    got = losses._mask_duplicate_slots(*_t(slot, valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_v2_last_duplicate_wins_and_all_valid_gts_exempt_noobj():
    """Two GTs on one (cell, anchor): the later one's targets win; the
    loser still exempts the predictions that overlap it from noobj."""
    anchors = ((1.0, 1.0), (3.0, 3.0))
    head = np.random.RandomState(5).normal(0, 0.5, (1, 4, 4, 2, 7)).astype(
        np.float32)
    gt = np.array([[[0.3, 0.3, 0.2, 0.2], [0.31, 0.31, 0.25, 0.25],
                    [0.0, 0.0, 0.0, 0.0]]], np.float32)
    cls = np.array([[0, 1, 0]], np.int32)
    valid = np.array([[True, True, False]])
    got = yolo_v2_loss(torch.from_numpy(head), anchors, *_t(gt, cls, valid))
    want = jax.jit(lambda h: jax_losses.yolo_v2_loss(
        h, anchors, jnp.asarray(gt), jnp.asarray(cls),
        jnp.asarray(valid)))(jnp.asarray(head))
    assert_terms_close(got, want, TERM_RTOL)
    assert_terms_close(got, _v2_oracle(head, anchors, gt, cls, valid,
                                       YoloV2LossConfig()), ORACLE_RTOL)
