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


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def _phase_products(x, w0):
    """The conv's bf16 x bf16 products, exact in f32: (N, H/2, W/2, 4
    phases (di*2+dj), 27 taps (u, v, c) in raster order, Co)."""
    xb, wb = _bf16(x), _bf16(w0)
    n, h, w, _ = x.shape
    xpad = np.zeros((n, h + 2, w + 2, 3), np.float32)
    xpad[:, 1:h + 1, 1:w + 1] = xb
    phases = []
    for di in range(2):
        for dj in range(2):
            taps = [xpad[:, di + u:di + u + h:2, dj + v:dj + v + w:2, c][..., None]
                    * wb[u, v, c] for u in range(3) for v in range(3)
                    for c in range(3)]
            phases.append(np.stack(taps, axis=-2))
    return np.stack(phases, axis=3)


def _pairwise(p):
    """f32 pairwise (tree) sum over axis -2, padded to a power of two."""
    k = 1 << (p.shape[-2] - 1).bit_length()
    p = np.concatenate([p, np.zeros(p.shape[:-2] + (k - p.shape[-2],)
                                    + p.shape[-1:], np.float32)], axis=-2)
    while p.shape[-2] > 1:
        p = p[..., 0::2, :] + p[..., 1::2, :]
    return p[..., 0, :]


def _sequential(p):
    acc = np.zeros(p.shape[:-2] + p.shape[-1:], np.float32)
    for t in range(p.shape[-2]):
        acc = acc + p[..., t, :]
    return acc


SUM_ORDERS = {
    "float64": lambda p: p.astype(np.float64).sum(axis=-2).astype(np.float32),
    "reversed_taps": lambda p: _sequential(p[..., ::-1, :]),
    "pairwise": _pairwise,
}


def _epilogue(acc, b):
    """f32 bias + leaky 0.1, max over the phase axis 3, one bf16 rounding."""
    z = acc + b.astype(np.float32)
    z = np.where(z >= 0, z, np.float32(0.1) * z)
    return torch.from_numpy(z.max(axis=3)).to(torch.bfloat16)


def _tolerance_case(case):
    x, w0, b = stem_inputs(16, seed=3, n=1)
    if case == "wide_range_near_cancellation":
        # operands over 12 and 8 binades: the 27-term f32 sums are inexact,
        # so the orders really differ (with inputs in [0, 1] they rarely do)
        rng = np.random.RandomState(7)
        x = (x * 2.0 ** rng.randint(-12, 1, x.shape)).astype(np.float32)
        w0 = (w0 * 2.0 ** rng.randint(-8, 1, w0.shape)).astype(np.float32)
    if case != "random":
        # bias = minus each channel's mean pre-activation: half the sums
        # cancel to near zero, where the sum order matters most
        pre = _phase_products(x, w0).astype(np.float64).sum(axis=-2)
        b = -pre.reshape(-1, pre.shape[-1]).mean(axis=0).astype(np.float32)
    return x, w0, b


def _within_tolerance(got, x, w0, b):
    want = stem.stem_fused_torch(torch.from_numpy(x), torch.from_numpy(
        stem.pack_stem_kernel(w0)), torch.from_numpy(b))
    tol = stem.stem_tolerance(torch.from_numpy(x), torch.from_numpy(w0),
                              torch.from_numpy(b), want)
    ratio = ((got.float() - want.float()).abs() / tol).max()
    return float(ratio), want


@pytest.mark.parametrize("case", ["random", "near_cancellation",
                                  "wide_range_near_cancellation"])
@pytest.mark.parametrize("order", sorted(SUM_ORDERS))
def test_other_summation_orders_stay_within_stem_tolerance(order, case):
    """The CUDA kernel sums the same exact products on the tensor cores in
    an order of its own; any order of the 27 additions in f32 (or a sum in
    float64) must stay within stem_tolerance of the plain version."""
    x, w0, b = _tolerance_case(case)
    products = _phase_products(x, w0)
    acc = SUM_ORDERS[order](products)
    got = _epilogue(acc, b)
    ratio, want = _within_tolerance(got, x, w0, b)
    assert got.shape == want.shape and ratio <= 1.0
    if case != "random":
        assert (want.float().abs() < 1e-2).float().mean() > 0.02
    if case == "wide_range_near_cancellation":
        assert (acc != _sequential(products)).mean() > 0.5


def test_stem_tolerance_catches_two_ulps_on_a_large_value():
    x, w0, b = stem_inputs(16, seed=5, n=1)
    want = stem.stem_fused_torch(torch.from_numpy(x), torch.from_numpy(
        stem.pack_stem_kernel(w0)), torch.from_numpy(b))
    tol = stem.stem_tolerance(torch.from_numpy(x), torch.from_numpy(w0),
                              torch.from_numpy(b), want)
    flat = want.view(torch.int16).reshape(-1).clone()
    i = int(want.float().abs().reshape(-1).argmax())
    assert float(want.reshape(-1)[i].abs()) > 0.5
    for ulps, inside in ((1, True), (2, False)):
        bad = flat.clone()
        bad[i] += ulps if int(bad[i]) >= 0 else -ulps  # away from zero
        got = bad.view(torch.bfloat16).reshape(want.shape)
        err = (got.float() - want.float()).abs().reshape(-1)[i]
        assert bool(err <= tol.reshape(-1)[i]) == inside, ulps


def _emulate_mma_tiles(x, w0, b):
    """The CUDA kernel's tile layout in numpy: 8 pooled pixels of a row
    form a group; in M tile di, mma row g is pixel g at phase (di, 0) and
    row g + 8 pixel g at phase (di, 1); K slot k carries tap STEM_K_TAPS[k]
    (a padding slot reads some finite input value against a zero row of B;
    here tap (2, 2, 2)). Each lane (g, tig) then max-reduces its own C
    fragment registers."""
    xb = _bf16(x)
    n, h, w, _ = x.shape
    hp, wq = h // 2, w // 2
    wg = -(-wq // 8) * 8  # ragged groups: pixels past W/2 are computed, dropped
    xpad = np.zeros((n, h + 2, 2 * wg + 2, 3), np.float32)
    xpad[:, 1:h + 1, 1:w + 1] = xb
    bmat = stem.stem_mma_matrix(torch.from_numpy(w0)).numpy()  # (32, 32)
    taps = [t if t is not None else (2, 2, 2) for t in stem.STEM_K_TAPS]
    tiles = []
    for di in range(2):
        rows = []
        for dj in range(2):  # rows 0..7 then 8..15 of the tile
            a = np.stack([xpad[:, di + u:di + u + h:2, dj + v:dj + v + 2 * wg:2, c]
                          for u, v, c in taps], axis=-1)  # (n, hp, wg, 32)
            rows.append(a.reshape(n, hp, wg // 8, 8, 32))
        a_tile = np.concatenate(rows, axis=3)  # (n, hp, groups, 16, 32)
        tiles.append(a_tile @ bmat)            # (n, hp, groups, 16, 32) f32
    out = np.zeros((n, hp, wg // 8, 8, 32), np.float32)
    for lane in range(32):
        g, tig = lane // 4, lane % 4
        for nt in range(4):
            for e in range(2):
                co = nt * 8 + 2 * tig + e
                vals = [tiles[di][..., g + 8 * dj, co] for di in range(2)
                        for dj in range(2)]  # c0/c1 (dj 0), c2/c3 (dj 1)
                z = [v + np.float32(b[co]) for v in vals]
                z = [np.where(v >= 0, v, np.float32(0.1) * v) for v in z]
                out[..., g, co] = np.maximum.reduce(z)
    out = out.reshape(n, hp, wg, 32)[:, :, :wq]
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 16, 16), (2, 10, 22), (1, 6, 34)])
def test_mma_tile_layout_emulation_matches_plain(shape):
    n, h, w = shape
    rng = np.random.RandomState(h * w)
    x = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    w0 = rng.normal(0, 0.2, (3, 3, 3, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    got = _emulate_mma_tiles(x, w0, b)
    ratio, want = _within_tolerance(got, x, w0, b)
    assert got.shape == want.shape and ratio <= 1.0


def test_mma_operand_fragments_hold_the_tap_matrix():
    """Unpacking the (16, 32) fragment registers as mma.sync m16n8k16's
    col-major B gives back the (32, 32) tap matrix; every tap is in K once."""
    _, w0, _ = stem_inputs(8, seed=6)
    w0 = torch.from_numpy(w0)
    frag = stem.stem_mma_operand(w0)
    assert frag.shape == (16, 32) and frag.dtype == torch.int32
    words = frag.to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([words & 0xFFFF, words >> 16], -1)  # (16, 32, 2)
    vals = halves.to(torch.int32).to(torch.int16).view(torch.bfloat16).float()
    rebuilt = torch.zeros(32, 32)
    lane = torch.arange(32)
    for ks in range(2):
        for nt in range(4):
            for half in range(2):
                r = (ks * 4 + nt) * 2 + half
                k0 = 16 * ks + 8 * half + 2 * (lane % 4)
                n = 8 * nt + lane // 4
                rebuilt[k0, n] = vals[r, :, 0]
                rebuilt[k0 + 1, n] = vals[r, :, 1]
    assert torch.equal(rebuilt, stem.stem_mma_matrix(w0))
    taps = [t for t in stem.STEM_K_TAPS if t is not None]
    assert sorted(taps) == [(u, v, c) for u in range(3) for v in range(3)
                            for c in range(3)]
    assert StemLayer(torch.from_numpy(stem.pack_stem_kernel(w0.numpy())),
                     torch.zeros(32)).wfrag.equal(frag)


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
