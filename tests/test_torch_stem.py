"""The fused conv0 + leaky + pool stem: the port's packing, packed conv,
plain version of the CUDA kernel and graph surgery against yolojax's
``nn/stem.py`` and ``nn/pallas_stem.py`` (interpret mode) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.models import get_model as jax_get_model
from yolojax.nn import stem as jax_stem
from yolojax.nn.pallas_stem import stem_forward_pallas
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_from_jax, params_to_jax
from yolojax_torch.models import get_model
from yolojax_torch.nn import stem
from yolojax_torch.nn.cuda_stem import stem_fused_cuda
from yolojax_torch.nn.layers import StemLayer

from .test_torch_convert import assert_trees_equal
from .test_torch_layers import random_jax_weights


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def stem_inputs(dim, seed=0, n=2, co=32):
    """x (n, dim, dim, 3) in [0, 1], w0 (3, 3, 3, co), b (co,), as
    tests/unit/test_stem.py draws them."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (n, dim, dim, 3)).astype(np.float32)
    w0 = rng.normal(0, 0.2, (3, 3, 3, co)).astype(np.float32)
    b = rng.normal(0, 0.1, (co,)).astype(np.float32)
    return x, w0, b


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise distance in bf16 ulps of two arrays of bf16 values."""

    def ordinal(v):
        bits = np.asarray(v, np.float32).view(np.int32).astype(np.int64) >> 16
        return np.where(bits < 0, -(bits & 0x7FFF), bits)

    return np.abs(ordinal(a) - ordinal(b))


@pytest.mark.parametrize("co", [32, 16])
def test_pack_stem_kernel_bit_equal_and_w0_recovered(co):
    _, w0, _ = stem_inputs(8, seed=co, co=co)
    wp = stem.pack_stem_kernel(w0)
    want = jax_stem.pack_stem_kernel(w0)
    assert wp.dtype == want.dtype and wp.shape == (3, 3, 12, 4 * co)
    np.testing.assert_array_equal(wp, want)
    got = stem.unpack_stem_kernel(torch.from_numpy(wp)).numpy()
    np.testing.assert_array_equal(got, w0)


@pytest.mark.parametrize("dim", [32, 64])
def test_stem_forward_matches_jax(dim):
    x, w0, b = stem_inputs(dim)
    wp = stem.pack_stem_kernel(w0)
    want = np.asarray(jax_stem.stem_forward(
        jnp.asarray(x), jnp.asarray(wp), jnp.asarray(b),
        compute_dtype=jnp.float32))
    got = stem.stem_forward(torch.from_numpy(x), torch.from_numpy(wp),
                            torch.from_numpy(b), compute_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # the tolerance of tests/unit/test_stem.py:28
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [32, 64])
def test_plain_stem_matches_pallas_interpret(dim):
    x, w0, b = stem_inputs(dim, seed=dim)
    wp = stem.pack_stem_kernel(w0)
    with pltpu.force_tpu_interpret_mode():
        want = stem_forward_pallas(jnp.asarray(x), jnp.asarray(wp),
                                   jnp.asarray(b))
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 1, 3, 2)  # NHCW
    got = stem.stem_fused_torch(torch.from_numpy(x), torch.from_numpy(wp),
                                torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # both sum bf16 products in f32, in other orders: one bf16 ulp at most
    assert bf16_ulps(got.float().numpy(), want).max() <= 1


def test_cuda_kernel_summation_order_is_the_plain_versions():
    """csrc/stem_fused.cu adds its products in the packed conv's order
    (packed tap, then packed channel) and skips the packed kernel's zeros;
    emulated here in numpy f32, that order gives the plain version's
    result bit for bit, which is what the card is held to."""
    x, w0, b = stem_inputs(32, seed=3, n=1)
    xb = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    wb = torch.from_numpy(w0).to(torch.bfloat16).float().numpy()
    n, h, w, _ = x.shape
    xpad = np.zeros((n, h + 4, w + 4, 3), np.float32)
    xpad[:, 2:h + 2, 2:w + 2] = xb
    acc = np.zeros((4, n, h // 2, w // 2, 32), np.float32)
    for up in range(3):
        for vp in range(3):
            for si in range(2):
                for sj in range(2):
                    for c in range(3):
                        off_r, off_c = 2 * up - 2 + si, 2 * vp - 2 + sj
                        if not (-1 <= off_r <= 2 and -1 <= off_c <= 2):
                            continue
                        xv = xpad[:, 2 + off_r:2 + off_r + h:2,
                                  2 + off_c:2 + off_c + w:2, c][..., None]
                        for di in range(2):
                            for dj in range(2):
                                u, v = off_r - di + 1, off_c - dj + 1
                                if 0 <= u <= 2 and 0 <= v <= 2:
                                    p = di * 2 + dj
                                    acc[p] = acc[p] + xv * wb[u, v, c]
    z = acc + b
    z = np.where(z >= 0, z, np.float32(0.1) * z)
    emulated = torch.from_numpy(z.max(axis=0)).to(torch.bfloat16)
    plain = stem.stem_fused_torch(
        torch.from_numpy(x), torch.from_numpy(stem.pack_stem_kernel(w0)),
        torch.from_numpy(b))
    assert torch.equal(emulated, plain)


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    x, w0, b = stem_inputs(16, seed=4)
    wp = torch.from_numpy(stem.pack_stem_kernel(w0))
    got = stem_fused_cuda(torch.from_numpy(x), wp, torch.from_numpy(b))
    assert torch.equal(got, stem.stem_fused_torch(torch.from_numpy(x), wp,
                                                  torch.from_numpy(b)))
    with pytest.raises(ValueError, match="CUDA"):
        stem_fused_cuda(torch.empty((1, 16, 16, 3), device="meta"), wp,
                        torch.from_numpy(b))


def _fused_pair(inference, impl, seed):
    """(yolojax model, params, state) and (port model, net), both BN-folded
    and stem-fused with ``impl``, from one set of numpy weights."""
    jm = jax_get_model("yolo2", inference, 20)
    params, state = random_jax_weights(jm, 64, seed=seed)
    tm = get_model("yolo2", inference, 20)
    tm, net = fold_bn(tm, params_from_jax(tm, params, state))
    tm, net = stem.fuse_stem(tm, net, impl=impl)
    jm, params, state = jax_fold_bn(jm, params, state)
    jm, params, state = jax_stem.fuse_stem(jm, params, state, impl=impl)
    assert type(tm.specs[0]).__name__ == type(jm.specs[0]).__name__ == \
        "StemSpec"
    assert [type(s).__name__ for s in tm.specs] == \
        [type(s).__name__ for s in jm.specs]
    return (jm, params, state), (tm, net)


@pytest.mark.parametrize("inference", ["tiny", "darknet"])
@pytest.mark.parametrize("impl,tol", [
    ("xla", 2e-4),     # f32 packed conv on both sides (test_stem.py:50)
    ("pallas", 3e-2),  # bf16 stem: plain twin vs Pallas (test_stem.py:70)
])
def test_fused_model_matches_jax(inference, impl, tol):
    (jm, params, state), (tm, net) = _fused_pair(inference, impl, seed=11)
    x = np.random.RandomState(12).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jm.apply(params, state, jnp.asarray(x),
                                   compute_dtype=jnp.float32)[0])
    with torch.no_grad():
        got = tm.apply(net, torch.from_numpy(x),
                       compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_fuse_stem_declines_and_off_is_identity():
    params, state = random_jax_weights(jax_get_model("yolo", "yolo", 20), 64,
                                       seed=13)
    v1 = get_model("yolo", "yolo", 20)
    v1, v1_net = fold_bn(v1, params_from_jax(v1, params, state))
    assert stem.fuse_stem(v1, v1_net, impl="auto") == (v1, v1_net)  # 7x7/s2
    v2 = get_model("yolo2", "darknet", 20)
    v2_net = v2.init(torch.Generator().manual_seed(0), 64)
    assert stem.fuse_stem(v2, v2_net, impl="pallas") == (v2, v2_net)  # BN
    v2f, v2f_net = fold_bn(v2, v2_net)
    assert stem.fuse_stem(v2f, v2f_net) == (v2f, v2f_net)  # impl="off"
    with pytest.raises(ValueError, match="impl"):
        stem.fuse_stem(v2f, v2f_net, impl="cuda")


def test_fused_params_round_trip_exact():
    (jm, params, state), (tm, _) = _fused_pair("darknet", "pallas", seed=14)
    params = jax.tree_util.tree_map(np.asarray, params)
    net = params_from_jax(tm, params, state)
    assert isinstance(net.conv_0, StemLayer) and not hasattr(net, "conv_1")
    assert sorted(params["conv_0"]) == ["b", "wp"] and "conv_1" not in params
    back_params, back_state = params_to_jax(tm, net)
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_state, state)


def test_init_network_builds_a_fused_model():
    tm = get_model("yolo2", "tiny", 20)
    fm, fnet = stem.fuse_stem(*fold_bn(
        tm, tm.init(torch.Generator().manual_seed(1), 64)), impl="xla")
    fresh = fm.init(torch.Generator().manual_seed(2), 64)
    assert isinstance(fresh.conv_0, StemLayer)
    assert fresh.conv_0.wp.shape == fnet.conv_0.wp.shape == (3, 3, 12, 64)
    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = fm.apply(fresh, x, compute_dtype=torch.float32)
    assert out.shape == (1, 2, 2, 5, 25) and torch.isfinite(out).all()
