"""The port's int8 PTQ (``yolojax_torch/quantize``) against yolojax's on the
CPU: the requant epilogue, the int8 product and max-pool, calibration and
weight quantization, and the whole int8 forward against
``jax.jit(apply_int8)``, the graph yolojax serves, from one carried-over
``QuantizedModel``. int8 codes must be equal bit for bit at every layer;
the bf16 head and independently calibrated scales agree within the
tolerances stated below."""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from yolojax.models import get_model as jax_get_model
from yolojax.nn import layers as jax_layers
from yolojax.quantize import ptq as jax_ptq
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_to_jax, quantized_from_jax
from yolojax_torch.models import get_model
from yolojax_torch.quantize import int8_ops, ptq
from yolojax_torch.quantize.cuda_int8 import int8_requant_cuda

# The head is a bf16 conv (or dense) on bf16-rounded inputs on both sides,
# summed in f32 in other orders and rounded to bf16 once: each side is
# within one bf16 ulp (2^-8 relative) of the exact sum, so two ulps of the
# largest value bound the difference. Measured: ~3e-3 of max|head|.
HEAD_RTOL = 2.0 ** -7
# Scales calibrated apart: both walks run bf16 convs that XLA and PyTorch
# round at different points, and each layer's error feeds the next one's
# range (23 convs deep). Measured: up to ~7e-3 relative on Darknet-19.
SCALE_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def folded_pair(name, inference, num_classes, dim, seed, unfolded=None):
    """A BN-folded port network from ``seed`` (random BN statistics and
    head bias, so every folded bias is non-zero) and the same weights as a
    folded yolojax (model, params). ``unfolded``, a list, receives the port
    network before the fold (which shares its layers without BN)."""
    tm = get_model(name, inference, num_classes)
    gen = torch.Generator().manual_seed(seed)
    net = tm.init(gen, dim)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1, generator=gen)
                layer.var.uniform_(0.5, 1.5, generator=gen)
                layer.scale.uniform_(0.5, 1.5, generator=gen)
                layer.bias.normal_(0.0, 0.1, generator=gen)
            elif hasattr(layer, "b"):
                layer.b.normal_(0.0, 0.1, generator=gen)
    if unfolded is not None:
        unfolded.append(net)
    tm, net = fold_bn(tm, net)
    jm = jax_get_model(name, inference, num_classes)
    jm = dataclasses.replace(jm, specs=tuple(
        dataclasses.replace(s, bn=False)
        if isinstance(s, jax_layers.ConvSpec) else s for s in jm.specs))
    params, _ = params_to_jax(tm, net)
    return tm, net, jm, params


def images(seed, n, dim):
    return np.random.RandomState(seed).uniform(0, 1, (n, dim, dim, 3)).astype(
        np.float32)


def jax_int8(qm, x, *variants):
    """``jax.jit(apply_int8)`` on ``x``: (head, the int8 tensor of every
    ``_requant`` in order). The recording rides the traced graph: the
    requants are the jitted graph's own. Given keyword dicts in
    ``variants``, one such pair for each, from one jitted program (one
    compile; its outputs equal those of separate jits bit for bit)."""

    def fn(imgs):
        out = []
        for kw in variants or ({},):
            codes = []
            orig = jax_ptq._requant

            def rec(y, scale, qmax=127):
                q = orig(y, scale, qmax)
                codes.append(q)
                return q

            with mock.patch.object(jax_ptq, "_requant", rec):
                out.append((jax_ptq.apply_int8(qm, imgs, **kw), codes))
        return out

    out = [(np.asarray(head), [np.asarray(c) for c in codes])
           for head, codes in jax.jit(fn)(jnp.asarray(x))]
    return out if variants else out[0]


def port_int8(qm, x):
    codes = []
    head = ptq.apply_int8(qm, torch.from_numpy(x), codes=codes)
    return head.numpy(), [c.numpy() for c in codes]


def assert_int8_parity(jax_out, port_out, fused_stem=False):
    """Codes equal at every requant but the head's (which yolojax computes
    and never reads); the head within HEAD_RTOL of max|head|."""
    (jh, jc), (th, tc) = jax_out, port_out
    jc = jc[:-1]
    if fused_stem:  # yolojax requants the four phases, then takes the max
        n, h, w, c4 = jc[1].shape
        jc[1] = jc[1].reshape(n, h, w, 4, c4 // 4).max(axis=3)
    assert len(tc) == len(jc)
    for i, (a, b) in enumerate(zip(jc, tc)):
        assert b.dtype == np.int8 and a.shape == b.shape, i
        np.testing.assert_array_equal(b, a, err_msg=f"requant {i}")
    assert th.shape == jh.shape and np.isfinite(th).all()
    err = np.abs(th - jh).max() / np.abs(jh).max()
    assert err <= HEAD_RTOL, err


@pytest.fixture(scope="module")
def darknet():
    """Darknet-19 v2 @ 64, 4 classes: its yolojax QuantizedModel from two
    calibration images, carried into the port, and yolojax's jitted output
    on two other images, with 1x1 convs as convs and as dots."""
    tm, net, jm, params = folded_pair("yolo2", "darknet", 4, 64, seed=11)
    calib, x = images(0, 2, 64), images(1, 2, 64)
    jqm = jax_ptq.quantize_model(jm, params, jnp.asarray(calib))
    conv, dot = jax_int8(jqm, x, {}, {"one_by_one": "dot"})
    return {"tm": tm, "net": net, "jm": jm, "params": params, "calib": calib,
            "x": x, "jqm": jqm, "qm": quantized_from_jax(tm, jqm),
            "jax": conv, "jax_dot": dot}


@pytest.fixture(scope="module")
def tiny_v2():
    return folded_pair("yolo2", "tiny", 20, 32, seed=12)


# ---------------------------------------------------------------------------
# the epilogue, the product and the pool
# ---------------------------------------------------------------------------


def epilogue_inputs(seed):
    """(acc (M, 4*C) int32, in_scale, w_scale, b, scale) cases: wide sums
    (past 2^24, so their f32 conversion rounds), small sums with
    power-of-two scales (exact products, ties at .5 after the reciprocal
    multiply), and zero sums with biases placed on the .5 boundaries of
    y * r and one and two f32 ulps either side."""
    rng = np.random.RandomState(seed)
    c = 32
    scale = np.float32(0.037)
    r = np.float32(1) / scale
    k = rng.randint(-200, 200, c).astype(np.float32)
    edge = ((k + np.float32(0.5)) / r).astype(np.float32)
    biases = np.concatenate([
        edge, np.nextafter(edge, np.float32(np.inf)),
        np.nextafter(edge, -np.float32(np.inf)),
        np.nextafter(np.nextafter(edge, np.float32(np.inf)),
                     np.float32(np.inf)),
    ]).astype(np.float32)
    wide = rng.randint(-2 ** 27, 2 ** 27, (256, 4 * c)).astype(np.int32)
    small = rng.randint(-3000, 3000, (256, 4 * c)).astype(np.int32)
    return [
        (wide, 0.0123456789, rng.uniform(0.5, 2, 4 * c).astype(np.float32)
         * np.float32(1e-3), rng.normal(0, 1, 4 * c).astype(np.float32),
         0.037),
        (small, 0.5, np.full(4 * c, 2.0 ** -8, np.float32),
         (rng.randint(-64, 64, 4 * c) * 2.0 ** -9).astype(np.float32),
         0.125),
        (np.zeros((7, 4 * c), np.int32), 0.01,
         rng.uniform(0.5, 2, 4 * c).astype(np.float32), biases, 0.037),
    ]


@pytest.mark.parametrize("leaky,phases,qmax", [
    (True, 1, 127), (False, 1, 127), (True, 4, 127), (True, 1, 15),
], ids=["leaky", "linear", "stem-phases", "5-bit"])
def test_epilogue_matches_jitted_jax(leaky, phases, qmax):
    """The plain epilogue (the CUDA kernel's plain version, which the
    wrapper runs on the CPU) against yolojax's epilogue expression jitted
    with its scales baked in, on values placed at rounding boundaries."""
    for acc, in_scale, w_scale, b, scale in epilogue_inputs(3):

        def epilogue(a):
            y = a.astype(jnp.float32) * (
                in_scale * jnp.asarray(w_scale)) + jnp.asarray(b)
            if leaky:
                y = jax_layers.leaky_relu(y)
            q = jax_ptq._requant(y, scale, qmax)
            if phases > 1:
                q = q.reshape(q.shape[0], 4, -1).max(axis=1)
            return q

        want = np.asarray(jax.jit(epilogue)(jnp.asarray(acc)))
        m = torch.from_numpy(np.float32(in_scale) * w_scale)
        got = int8_requant_cuda(torch.from_numpy(acc), m, torch.from_numpy(b),
                                ptq._reciprocal(scale), qmax, leaky, phases)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def test_fma_emulation_rounds_once():
    """a * m + b with the exact sum just below an f32 midpoint whose float64
    rounding lands on the midpoint: rounding the float64 sum to f32 (two
    roundings) goes up to even, one fused rounding stays down."""
    a = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    m = torch.tensor([2.0 ** -24 * (1 - 2.0 ** -23)], dtype=torch.float32)
    b = torch.tensor([1 + 2.0 ** -23], dtype=torch.float32)
    twice = (a.double() * m.double() + b.double()).float()
    assert float(twice) == 1 + 2.0 ** -22
    assert float(int8_ops.fma_f32(a, m, b)) == 1 + 2.0 ** -23


@pytest.mark.parametrize("shape,k,cout,stride", [
    ((2, 9, 11, 5), 3, 16, 1),    # odd width, K = 45 padded to 48
    ((2, 8, 8, 16), 1, 24, 1),    # 1x1: the im2col is a view
    ((1, 12, 12, 3), 3, 32, 1),   # conv0: K = 27 padded to 32
    ((2, 15, 15, 4), 7, 8, 2),    # YOLOv1's 7x7/s2, padding (3, 2)
    ((3, 6, 6, 12), 3, 12, 1),    # N = 12 padded to 16 and sliced
])
def test_int8_conv_matches_lax(shape, k, cout, stride):
    """im2col + ``_int_mm`` (and the float64 reference) against
    ``lax.conv_general_dilated(..., preferred_element_type=int32)`` with
    Darknet padding: the int32 sums are equal."""
    rng = np.random.RandomState(k * cout)
    x = rng.randint(-127, 128, shape).astype(np.int8)
    w = rng.randint(-127, 128, (k, k, shape[3], cout)).astype(np.int8)
    pad_h = jax_layers._darknet_padding(shape[1], k, stride)
    pad_w = jax_layers._darknet_padding(shape[2], k, stride)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), (pad_h, pad_w),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    acc, (n, ho, wo) = int8_ops.int8_conv(torch.from_numpy(x),
                                          torch.from_numpy(w), stride,
                                          pad_h, pad_w)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.reshape(n, ho, wo, cout).numpy(), want)
    exact = int8_ops.int8_conv_exact(torch.from_numpy(x), torch.from_numpy(w),
                                     stride, pad_h, pad_w)
    np.testing.assert_array_equal(exact.numpy(), want)


@pytest.mark.parametrize("rows", [1, 40])
def test_int8_dense_matches_dot_general(rows):
    """The v1 dense product, at batch 1 (rows padded past 16) and above."""
    rng = np.random.RandomState(rows)
    x = rng.randint(-127, 128, (rows, 100)).astype(np.int8)
    w = rng.randint(-127, 128, (100, 36)).astype(np.int8)
    want = np.asarray(lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))
    got = int8_ops.int8_matmul(torch.from_numpy(x),
                               int8_ops.gemm_operand(torch.from_numpy(w)), 36)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("hw,size,stride", [
    ((8, 8), 2, 2), ((7, 9), 2, 2), ((13, 13), 2, 1), ((6, 5), 2, 1),
], ids=["even", "odd", "tiny-v2-s1", "s1-ragged"])
def test_int8_max_pool_matches_jax(hw, size, stride):
    """int8 pooling pads with -128 (``MaxPoolSpec(2, 1)`` pads (0, 1)):
    all-negative windows at the padded edge keep their own maximum."""
    rng = np.random.RandomState(hw[0])
    x = rng.randint(-127, 0, (2, *hw, 4)).astype(np.int8)
    x[0] = rng.randint(-127, 128, (*hw, 4))
    want = np.asarray(jax_layers.max_pool(jnp.asarray(x), size, stride))
    got = int8_ops.int8_max_pool(torch.from_numpy(x), size, stride)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the int8 forward against jax.jit(apply_int8)
# ---------------------------------------------------------------------------


def test_apply_int8_darknet_matches_jax(darknet):
    assert_int8_parity(darknet["jax"], port_int8(darknet["qm"], darknet["x"]))


def test_apply_int8_one_by_one_dot(darknet):
    """yolojax's ``one_by_one="dot"`` form of the 1x1 stride-1 convs is the
    product the port always runs: the port's codes equal it too."""
    assert_int8_parity(darknet["jax_dot"],
                       port_int8(darknet["qm"], darknet["x"]))


def test_fuse_stem_int8_bitexact(darknet):
    """The packed int8 stem gives the unfused port's codes after the pool
    and the same head, bit for bit."""
    qm = darknet["qm"]
    fused = ptq.fuse_stem_int8(qm)
    assert type(fused.model.specs[0]).__name__ == "StemSpec"
    assert tuple(fused.qparams["conv_0"]["wp_q"].shape) == (3, 3, 12, 128)
    x = torch.from_numpy(darknet["x"])
    codes, fcodes = [], []
    head = ptq.apply_int8(qm, x, codes=codes)
    fhead = ptq.apply_int8(fused, x, codes=fcodes)
    pooled = int8_ops.int8_max_pool(codes[1], 2, 2)
    assert torch.equal(fcodes[1], pooled)
    assert len(fcodes) == len(codes)
    for a, b in zip(codes[2:], fcodes[2:]):
        assert torch.equal(a, b)
    assert torch.equal(head, fhead)


@pytest.mark.parametrize("case", ["tiny-v2-5bit-fused-stem", "v1-dense"])
def test_apply_int8_matches_jax(tiny_v2, case):
    """Tiny-v2 @ 32 (its stride-1 pool pads) on a 5-bit grid with yolojax's
    fused int8 stem carried across (the stem is bit-exact against the
    unfused form, above); tiny YOLOv1 @ 64, whose flatten and dense stack
    quantize (per-column scales, int8 products) up to the bf16 dense
    head."""
    if case == "v1-dense":
        (tm, _, jm, params), dim, bits = folded_pair(
            "yolo", "tiny", 3, 64, seed=13), 64, 8
    else:
        (tm, _, jm, params), dim, bits = tiny_v2, 32, 5
    jqm = jax_ptq.quantize_model(jm, params, jnp.asarray(images(4, 2, dim)),
                                 bits=bits)
    fused = case != "v1-dense"
    if fused:
        jqm = jax_ptq.fuse_stem_int8(jqm)
        assert "wp_q" in jqm.qparams["conv_0"]
    qm = quantized_from_jax(tm, jqm)
    assert qm.qmax == 2 ** (bits - 1) - 1
    x = images(5, 2, dim)
    assert_int8_parity(jax_int8(jqm, x), port_int8(qm, x), fused_stem=fused)


# ---------------------------------------------------------------------------
# calibration and weight quantization
# ---------------------------------------------------------------------------


def assert_scales_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)  # no compute
    np.testing.assert_allclose(got[1], want[1], rtol=SCALE_RTOL)


def test_quantize_model_matches_jax(darknet):
    """Weights quantize with yolojax's numpy code on the same folded
    weights: codes and per-channel scales are equal; activation scales
    agree within SCALE_RTOL. The head keeps its f32 weights."""
    calib = torch.from_numpy(darknet["calib"])
    qm = ptq.quantize_model(darknet["tm"], darknet["net"], calib)
    jqm = darknet["jqm"]
    assert qm.head_index == jqm.head_index == 30 and qm.qmax == 127
    assert_scales_close((qm.input_scale, qm.act_scales),
                        (jqm.input_scale, jqm.act_scales))
    assert sorted(qm.qparams) == sorted(jqm.qparams)
    n_int8 = 0
    for name, lp in jqm.qparams.items():
        if "w_q" in lp:
            n_int8 += 1
            np.testing.assert_array_equal(qm.qparams[name]["w_q"].numpy(),
                                          lp["w_q"])
            np.testing.assert_array_equal(qm.qparams[name]["w_scale"].numpy(),
                                          lp["w_scale"])
        else:
            np.testing.assert_array_equal(
                qm.qparams[name]["w"].permute(2, 3, 1, 0).numpy(), lp["w"])
    assert n_int8 == 22
    with pytest.raises(ValueError, match="quant bits"):
        ptq.quantize_model(darknet["tm"], darknet["net"], calib, bits=9)


def test_calibrate_percentile_and_chunks_match_jax(tiny_v2):
    """One hot pixel: yolojax's 99th-percentile clip and the port's agree
    over two chunks, and the input scale tracks the bulk where abs-max
    chases the outlier."""
    tm, net, jm, params = tiny_v2
    x = images(6, 3, 32)
    x[0, 0, 0, 0] = 500.0
    want = jax_ptq.calibrate(jm, params, jnp.asarray(x), percentile=99.0,
                             chunk=2)
    got = ptq.calibrate(tm, net, torch.from_numpy(x), percentile=99.0,
                        chunk=2)
    assert_scales_close(got, want)
    assert got[0] < 0.02 and ptq.calibrate(tm, net, torch.from_numpy(x))[0] > 3
    a = np.abs(images(7, 1, 32)).ravel()
    np.testing.assert_allclose(
        float(ptq._percentile(torch.from_numpy(a), 99.9)),
        float(jnp.percentile(jnp.asarray(a), 99.9)), rtol=1e-6)


def test_calibrate_all_black_clamps(tiny_v2):
    """All-zero frames: the input scale clamps at 1e-8 on both sides (no
    division by zero in the requant) and the forward stays finite."""
    tm, net, jm, params = tiny_v2
    black = np.zeros((2, 32, 32, 3), np.float32)
    want = jax_ptq.calibrate(jm, params, jnp.asarray(black))
    got = ptq.calibrate(tm, net, torch.from_numpy(black))
    assert got[0] == want[0] == 1e-8
    assert_scales_close(got, want)
    qm = ptq.quantize_model(tm, net, torch.from_numpy(black))
    out = ptq.apply_int8(qm, torch.from_numpy(images(8, 1, 32)))
    assert torch.isfinite(out).all()
