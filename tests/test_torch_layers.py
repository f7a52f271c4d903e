"""The port's eval-mode forward against yolojax's ``Model.apply``, in f32 on
the CPU, on the same weights (carried over by ``params_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.models import get_model as jax_get_model
from yolojax.nn import layers as jax_layers
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_from_jax
from yolojax_torch.models import get_model
from yolojax_torch.nn import layers

# f32 on both sides; the sums run in other orders (XLA vs oneDNN), so the
# head agrees to a few ulps of its largest value. Measured: ~3e-6 relative.
FORWARD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def random_jax_weights(model, dim, seed):
    """yolojax-layout (params, state) drawn with numpy from ``seed``:
    He-normal kernels, small random biases, random BN statistics and
    affine. Shapes come from yolojax's ``init`` (traced, not run)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), dim))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        key = path[-1].key
        if key == "w":
            std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            return (rng.standard_normal(leaf.shape) * std).astype(np.float32)
        if key == "b":
            return rng.normal(0, 0.1, leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)  # BN: filled below

    params = jax.tree_util.tree_map_with_path(draw, shapes[0])
    state = {}
    for name in shapes[1]:
        c = shapes[1][name]["mean"].shape[0]
        state[name] = {
            "mean": rng.normal(0, 0.1, c).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, c).astype(np.float32),
        }
        params[name]["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        params[name]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
    return params, state


@pytest.mark.parametrize(
    "name,inference,dim,fold",
    [
        ("yolo2", "darknet", 64, False),
        ("yolo2", "darknet", 64, True),
        ("yolo2", "darknet", 96, False),
        ("yolo2", "darknet", 96, True),
        ("yolo2", "tiny", 64, False),   # MaxPoolSpec(2, 1) pads (0, 1)
        ("yolo", "tiny", 64, False),    # NCHW flatten + dense layers
        ("yolo", "yolo", 64, False),    # 7x7/s2 and 3x3/s2 pad (lo, hi)
    ],
)
def test_forward_matches_jax(name, inference, dim, fold):
    jm = jax_get_model(name, inference, 20)
    tm = get_model(name, inference, 20)
    params, state = random_jax_weights(jm, dim, seed=dim)
    net = params_from_jax(tm, params, state)
    if fold:
        jm, params, state = jax_fold_bn(jm, params, state)
        tm, net = fold_bn(tm, net)
    x = np.random.RandomState(1).uniform(0, 1, (2, dim, dim, 3)).astype(
        np.float32)
    apply = jax.jit(lambda p, s, im: jm.apply(p, s, im,
                                              compute_dtype=jnp.float32)[0])
    ref = np.asarray(apply(params, state, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.apply(net, torch.from_numpy(x),
                       compute_dtype=torch.float32).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= FORWARD_RTOL * np.abs(ref).max()


@pytest.mark.parametrize("shape,size,stride", [
    ((2, 7, 9, 3), 2, 2),    # odd sizes: SAME pad (0, 1) with -inf
    ((2, 13, 13, 5), 2, 1),  # tiny-v2's stride-1 pool
    ((1, 11, 6, 4), 3, 2),
])
def test_max_pool_bit_equal(shape, size, stride):
    x = np.random.RandomState(2).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_layers.max_pool(jnp.asarray(x), size, stride))
    got = layers.max_pool(torch.from_numpy(x), size, stride).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,stride", [((2, 6, 10, 5), 2), ((1, 9, 3, 7), 3)])
def test_space_to_depth_bit_equal(shape, stride):
    x = np.random.RandomState(3).normal(size=shape).astype(np.float32)
    want = np.asarray(jax_layers.space_to_depth(jnp.asarray(x), stride))
    got = layers.space_to_depth(torch.from_numpy(x), stride).numpy()
    np.testing.assert_array_equal(got, want)


def test_darknet_padding_matches_jax():
    for size in (7, 8, 13, 64, 448):
        for k in (1, 3, 7):
            for s in (1, 2):
                assert (layers._darknet_padding(size, k, s)
                        == jax_layers._darknet_padding(size, k, s))
