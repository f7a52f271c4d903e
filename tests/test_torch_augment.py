"""The port's device augmentation against yolojax's on the CPU.

JAX's random bits cannot be repeated by a ``torch.Generator``, so the
deterministic *apply* is held against yolojax's arithmetic on the same
fixed parameters (the body of ``yolojax/data/augment.py::_geometry`` and
``_color_jitter`` with ``jax.image.scale_and_translate`` and yolojax's hsv
functions), and the *draws* are held to yolojax's ranges."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.data import augment as jax_augment
from yolojax_torch.data import augment
from yolojax_torch.data.augment import AugmentConfig, AugmentParams

# f32 on both sides: the resample sums run in other orders (two batched
# products here, one einsum in JAX); measured ~1e-7 of the [0, 1] range
APPLY_ATOL = 1e-5
HSV_ATOL = 1e-6


def jax_geometry(img, boxes, valid, out_dim, z, o, flip, cfg):
    """``_geometry`` of yolojax with its three draws replaced by z, o and
    flip (lines 118-146 of yolojax/data/augment.py)."""
    h_in, w_in = img.shape[0], img.shape[1]
    scale = jnp.asarray([z[1] * out_dim, z[0] * out_dim]) / jnp.asarray(
        [h_in, w_in], jnp.float32)
    trans = jnp.asarray([o[1], o[0]]) * out_dim
    img = jax.image.scale_and_translate(
        img - 0.5, shape=(out_dim, out_dim, 3), spatial_dims=(0, 1),
        scale=scale, translation=trans, method="linear") + 0.5
    xy = boxes[..., 0:2] * z + o
    wh = boxes[..., 2:4] * z
    img = jnp.where(flip, img[:, ::-1, :], img)
    xy = jnp.where(flip, jnp.stack([1.0 - xy[..., 0], xy[..., 1]], -1), xy)
    lo = jnp.clip(xy - wh / 2, 0.0, 1.0)
    hi = jnp.clip(xy + wh / 2, 0.0, 1.0)
    xy = (lo + hi) / 2
    wh = hi - lo
    valid = valid & (wh[..., 0] > cfg.min_box) & (wh[..., 1] > cfg.min_box)
    return img, jnp.concatenate([xy, wh], -1), valid


def jax_jitter(img, dh, ds, dv):
    """``_color_jitter`` of yolojax after its draws (lines 92-101)."""
    hsv = jax_augment.rgb_to_hsv(jnp.clip(img, 0.0, 1.0))
    hsv = jnp.stack([(hsv[..., 0] + dh) % 1.0,
                     jnp.clip(hsv[..., 1] * ds, 0.0, 1.0),
                     jnp.clip(hsv[..., 2] * dv, 0.0, 1.0)], axis=-1)
    return jax_augment.hsv_to_rgb(hsv)


def params(z, o, flip, dh=None, ds=None, dv=None):
    n = len(flip)
    f = lambda a, d: torch.tensor(d if a is None else a, dtype=torch.float32)
    return AugmentParams(f(z, None), f(o, None), torch.tensor(flip),
                         f(dh, [0.0] * n), f(ds, [1.0] * n), f(dv, [1.0] * n))


def rgb_cases():
    rng = np.random.RandomState(0)
    edge = np.array([[0, 0, 0], [1, 1, 1], [0.5, 0.5, 0.5], [1, 0, 0],
                     [0, 1, 0], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 0, 1],
                     [0.2, 0.7, 0.7], [0.7, 0.7, 0.2]], np.float32)
    return np.concatenate([edge, rng.uniform(0, 1, (4000, 3)).astype(
        np.float32)])


def test_rgb_hsv_round_trip_matches_jax():
    rgb = rgb_cases()
    hsv = augment.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    np.testing.assert_allclose(
        hsv, np.asarray(jax_augment.rgb_to_hsv(jnp.asarray(rgb))),
        atol=HSV_ATOL, rtol=0)
    # hue past the wheel's ends: the floor-mod wraps it like JAX's %
    hsv_in = np.random.RandomState(1).uniform(-1.5, 2.5, (4000, 3)).astype(
        np.float32)
    hsv_in[:, 1:] = np.clip(hsv_in[:, 1:], 0, 1)
    np.testing.assert_allclose(
        augment.hsv_to_rgb(torch.from_numpy(hsv_in)).numpy(),
        np.asarray(jax_augment.hsv_to_rgb(jnp.asarray(hsv_in))),
        atol=HSV_ATOL, rtol=0)
    back = augment.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    np.testing.assert_allclose(back, rgb, atol=HSV_ATOL)


GEOMETRY_CASES = {
    # (zoom (zx, zy), offset, flip) per image
    "zoom_in": ([[1.2, 1.15]], [[-0.1, -0.02]], [False]),
    "zoom_out": ([[0.8, 0.85]], [[0.15, 0.05]], [False]),
    "flip": ([[1.0, 1.0]], [[0.0, 0.0]], [True]),
    "mixed_flip_batch": ([[0.9, 1.1], [1.2, 0.8]],
                         [[0.05, -0.07], [-0.19, 0.1]], [True, False]),
}


@pytest.mark.parametrize("out_dim", [40, 64])
@pytest.mark.parametrize("case", sorted(GEOMETRY_CASES))
def test_geometry_apply_matches_jax(case, out_dim):
    z, o, flip = (np.asarray(a) for a in GEOMETRY_CASES[case])
    n = len(flip)
    rng = np.random.RandomState(2)
    img = rng.uniform(0, 1, (n, 48, 56, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (n, 5, 2)),
                            rng.uniform(0.05, 0.5, (n, 5, 2))], -1).astype(
        np.float32)
    boxes[:, 4] = [0.99, 0.5, 0.01, 0.3]  # pushed out of frame: min_box drops
    valid = np.ones((n, 5), bool)
    valid[:, 3] = False
    cfg = AugmentConfig()
    got = augment.apply_geometry(torch.from_numpy(img),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(valid), out_dim,
                                 params(z.astype(np.float32),
                                        o.astype(np.float32), flip.tolist()),
                                 cfg)
    for i in range(n):
        want = jax_geometry(jnp.asarray(img[i]), jnp.asarray(boxes[i]),
                            jnp.asarray(valid[i]), out_dim,
                            jnp.asarray(z[i], jnp.float32),
                            jnp.asarray(o[i], jnp.float32), bool(flip[i]), cfg)
        np.testing.assert_allclose(got[0][i].numpy(), np.asarray(want[0]),
                                   atol=APPLY_ATOL, rtol=0)
        np.testing.assert_allclose(got[1][i].numpy(), np.asarray(want[1]),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(got[2][i].numpy(), np.asarray(want[2]))
    if case == "zoom_in":
        assert not got[2][0, 4]  # the min_box drop happened


def test_color_jitter_apply_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.uniform(-0.05, 1.05, (3, 20, 24, 3)).astype(np.float32)
    dh, ds, dv = [0.08, -0.1, 0.0], [1.4, 0.7, 1.0], [0.75, 1.5, 1.0]
    got = augment.apply_color_jitter(
        torch.from_numpy(img), params([[1, 1]] * 3, [[0, 0]] * 3,
                                      [False] * 3, dh, ds, dv)).numpy()
    for i in range(3):
        want = jax_jitter(jnp.asarray(img[i]), jnp.float32(dh[i]),
                          jnp.float32(ds[i]), jnp.float32(dv[i]))
        np.testing.assert_allclose(got[i], np.asarray(want), atol=APPLY_ATOL,
                                   rtol=0)


@pytest.mark.parametrize("shape,dim", [((2, 64, 64, 3), 48),
                                       ((1, 40, 56, 3), 64)])
def test_resize_matches_jax_image_resize(shape, dim):
    x = np.random.RandomState(4).uniform(0, 1, shape).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (shape[0], dim, dim, 3), "linear")
    got = augment.resize(torch.from_numpy(x), dim).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=APPLY_ATOL, rtol=0)


def test_draws_stay_in_yolojax_ranges_and_repeat_with_the_seed():
    cfg = AugmentConfig(jitter=0.25, hue=0.2, saturation=1.6, exposure=1.3)
    n = 4096
    p = augment.draw_params(torch.Generator().manual_seed(7), n, cfg)
    z, o = p.zoom.numpy(), p.offset.numpy()
    assert z.shape == (n, 2) and z.min() >= 0.75 and z.max() <= 1.25
    # zoom-in shifts left/up (o <= 0), zoom-out pads (o >= 0), |o| <= |1-z|
    assert (o[z >= 1] <= 0).all() and (o[z < 1] >= 0).all()
    assert (np.abs(o) <= np.abs(1 - z) + 1e-7).all()
    assert 0.45 < p.flip.float().mean() < 0.55
    assert np.abs(p.dh.numpy()).max() <= 0.2
    for scale, name in ((1.6, "ds"), (1.3, "dv")):
        v = getattr(p, name).numpy()
        assert v.min() >= 1 / scale - 1e-6 and v.max() <= scale + 1e-6
        assert v.min() < 1 / scale + 0.02 and v.max() > scale - 0.02
    again = augment.draw_params(torch.Generator().manual_seed(7), n, cfg)
    other = augment.draw_params(torch.Generator().manual_seed(8), n, cfg)
    assert torch.equal(again.zoom, p.zoom) and torch.equal(again.dv, p.dv)
    assert not torch.equal(other.zoom, p.zoom)
    # saturation/exposure <= 0 disable the jitter; flip=0 never flips
    off = augment.draw_params(torch.Generator().manual_seed(7), 64,
                              AugmentConfig(saturation=0.0, exposure=-1.0,
                                            flip=False))
    assert (off.ds == 1).all() and (off.dv == 1).all() and not off.flip.any()


def test_augment_batch_shapes_and_determinism():
    rng = np.random.RandomState(5)
    img = torch.from_numpy(rng.uniform(0, 1, (3, 56, 56, 3)).astype(
        np.float32)).to(torch.bfloat16)
    boxes = torch.from_numpy(np.tile([0.5, 0.5, 0.3, 0.4], (3, 2, 1)).astype(
        np.float32))
    valid = torch.ones((3, 2), dtype=torch.bool)
    outs = [augment.augment_batch(torch.Generator().manual_seed(1), img,
                                  boxes, valid, 48) for _ in range(2)]
    im, b, v = outs[0]
    assert im.shape == (3, 48, 48, 3) and b.shape == (3, 2, 4)
    assert im.dtype == torch.float32  # the f32 jitter promotes, as in JAX
    assert bool(torch.isfinite(im).all()) and im.min() >= 0 and im.max() <= 1
    assert all(torch.equal(a, c) for a, c in zip(outs[0], outs[1]))
