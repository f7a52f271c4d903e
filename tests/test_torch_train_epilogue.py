"""The train-mode bf16 epilogue (``nn/train_epilogue.py::TrainEpilogue`` over
the plain versions of ``csrc/bn_train.cu`` and ``csrc/conv_epilogue.cu``)
on the CPU: against ``jax.vjp`` of ``jax.jit`` of yolojax's train-mode
epilogue lines (``yolojax/nn/layers.py::apply_network:397-420``), against
autograd of the plain ops the forward ran before (and still runs for f32
and tensor-parallel layers), a float64 gradcheck, bf16 train steps against
yolojax's ``make_train_step``, remat, and two ``gloo`` ranks against one
process."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from yolojax.models import Model as JaxModel
from yolojax.nn import layers as jax_layers
from yolojax.train import step as jax_step
from yolojax_torch.convert.interchange import (
    tensors_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from yolojax_torch.kernels import ops
from yolojax_torch.models import Model
from yolojax_torch.nn import cuda_bn_train, layers, train_epilogue
from yolojax_torch.nn.layers import (
    ConvSpec,
    bn_channel_sums_torch,
    epilogue_grad_apply_torch,
    epilogue_grad_sums_torch,
)
from yolojax_torch.parallel import launch
from yolojax_torch.parallel.mesh import make_mesh, shard_batch
from yolojax_torch.parallel.sharding import Plan
from yolojax_torch.train import step

from .pipeline.test_train_step import _batch
from .pipeline.test_train_step import micro_model as jax_micro_model
from .test_torch_train_steps import micro_model

EPS, ALPHA = 1e-5, 0.1
# x and dy (bf16) against another computation of the same function: two
# f32 values a hair apart may round to neighbouring bf16 values, so each
# value within one bf16 ulp of the larger of the two (at most 2^-7 of its
# magnitude), plus an absolute 1e-5 of the largest |value| for the f32
# statistics, which differ by their sums' order (and by XLA's FMA in BN
# mode) and move values near zero, where a bf16 ulp is tiny. Measured on
# the cases below: x equal to jax.vjp's and the plain ops'; dy at most 4
# values of a case one ulp from jax.vjp's, 2 from the plain ops'.
BF16_REL, F32_ABS = 2.0 ** -7, 1e-5
# the batch mean and variance, the scale and bias gradients (f32 sums in
# other orders), of their largest |value|. Measured against jax.vjp: m
# 1.1e-7, v 1.01e-6, dscale 2.8e-7, dbias 3.2e-7; against the plain ops m,
# v and dbias equal, dscale 2.4e-7.
STAT_RTOL = 1e-5
# a bf16 train step of a micro v2 and v1, port vs yolojax (oneDNN's and
# XLA's bf16 convs round each output to bf16 after summing in other
# orders, and the difference compounds through the backward's bf16
# gradients). Measured: loss terms 2.7e-3 / 3.4e-3 relative, gradients
# 2.3e-2 / 1.3e-2 of the tree's largest |value|, BN statistics 6.1e-6 /
# 4.8e-7; the plain ops the Function replaced show the same errors.
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_BN_RTOL = 1e-2, 5e-2, 1e-4
# two gloo ranks on halves of the batch vs one process: the statistics'
# sums are taken in the ranks' halves and added (f32 order only). Measured
# on the layer: m, v, dscale, dbias within 1.9e-7 of their largest value;
# on the micro v2 step: loss terms 1.0e-7 relative, gradients 2.1e-3 of
# max and their norm 6.6e-5 relative (bf16 values flipped by a statistic's
# last bit), BN statistics 1.9e-9
HALVES_LOSS_RTOL, HALVES_GRAD_RTOL, HALVES_BN_RTOL = 1e-5, 1e-2, 1e-5
SPAWN_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# inputs and references
# ---------------------------------------------------------------------------

# (C, mode): mode "bn" is BN + leaky, "bias" bias + leaky, "linear" bias
CASES = [(c, mode) for c in (8, 32, 125, 1024)
         for mode in ("bn", "bias", "linear")]


def layer_inputs(c, seed, ties=False):
    """bf16 y (N, H, W, C), its output's gradient g (bf16), BN's scale and
    bias (or the layer's bias) f32, from numpy. ``ties`` puts values on
    leaky's zero: rows with y = -bias exactly (z = +0 in bias mode), and
    for BN one channel of zeros with a zero bias (z = +0 everywhere)."""
    rng = np.random.RandomState(seed)
    shape = (4, 6, 5, c) if c < 1024 else (2, 3, 4, c)
    y = rng.normal(0.3, 2, shape).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = torch.from_numpy(rng.normal(0, 0.5, c).astype(
        np.float32)).bfloat16().float().numpy()  # -bias is a bf16 value
    if ties:
        rows = y.reshape(-1, c)
        rows[::3] = -bias
        rows[1::3] = np.where(np.arange(c) % 2 == 0, -bias, bf16_below(-bias))
        y[..., 0] = 0.0
        bias[0] = 0.0
    t = [torch.from_numpy(a) for a in (y, g, scale, bias)]
    return t[0].bfloat16(), t[1].bfloat16(), t[2], t[3]


def bf16_below(v: np.ndarray) -> np.ndarray:
    """The next bf16 value below each bf16 value of ``v`` (f32)."""
    bits = (v.astype(np.float32).view(np.uint32) >> 16).astype(np.int32)
    bits = np.where(v > 0, bits - 1, np.where(v < 0, bits + 1, 0x8001))
    return (bits.astype(np.uint32) << 16).view(np.float32)


def port_layer(y, g, scale, bias, mode):
    """The Function on (y, scale, bias) and its gradients for g:
    {x, m, v, dy, dscale, dbias} as float64 numpy (m, v, dscale None
    outside BN mode)."""
    y = y.clone().requires_grad_()
    scale = scale.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    if mode == "bn":
        x, m, v = train_epilogue.bn_train_epilogue(
            y, scale, bias, leaky=True, alpha=ALPHA, eps=EPS)
    else:
        x = train_epilogue.bias_train_epilogue(y, bias,
                                               leaky=mode == "bias",
                                               alpha=ALPHA)
        m = v = None
    x.backward(g)
    out = {"x": x, "m": m, "v": v, "dy": y.grad,
           "dscale": scale.grad if mode == "bn" else None,
           "dbias": bias.grad}
    return {k: None if t is None else t.detach().double().numpy()
            for k, t in out.items()}


def plain_layer(y, g, scale, bias, mode, mesh=None):
    """Autograd of the forward's plain ops (``nn/layers.py``'s f32 branch:
    ``_batch_moments``, ``batch_norm`` or the bias add, ``leaky_relu``, the
    cast), the same dict as :func:`port_layer`."""
    y = y.clone().requires_grad_()
    scale = scale.clone().requires_grad_()
    bias = bias.clone().requires_grad_()
    yf = y.float()
    m = v = None
    if mode == "bn":
        m, v = layers._batch_moments(yf, mesh)
        z = layers.batch_norm(yf, scale, bias, m, v, eps=EPS)
    else:
        z = yf + bias.float()
    if mode != "linear":
        z = layers.leaky_relu(z, ALPHA)
    x = z.to(torch.bfloat16)
    x.backward(g)
    out = {"x": x, "m": m, "v": v, "dy": y.grad,
           "dscale": scale.grad if mode == "bn" else None,
           "dbias": bias.grad}
    return {k: None if t is None else t.detach().double().numpy()
            for k, t in out.items()}


def jax_layer(y, g, scale, bias, mode):
    """``jax.vjp`` of ``jax.jit`` of apply_network's train-mode epilogue
    (yolojax/nn/layers.py:397-420: the f32 upcast, ``jnp.mean`` and
    ``jnp.var`` over (N, H, W), ``batch_norm``, or the bias add,
    ``leaky_relu``, the cast), the same dict as :func:`port_layer`."""
    bn, leaky = mode == "bn", mode != "linear"

    def f(y, scale, bias):
        yf = y.astype(jnp.float32)
        m = v = jnp.zeros(())
        if bn:
            m = jnp.mean(yf, axis=(0, 1, 2))
            v = jnp.var(yf, axis=(0, 1, 2))
            z = jax_layers.batch_norm(yf, scale, bias, m, v, eps=EPS)
        else:
            z = yf + bias.astype(jnp.float32)
        if leaky:
            z = jax_layers.leaky_relu(z, ALPHA)
        return z.astype(jnp.bfloat16), (m, v)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    x, vjp, (m, v) = jax.vjp(jax.jit(f), j(y), j(scale), j(bias),
                             has_aux=True)
    dy, dscale, dbias = vjp(j(g))

    def n(a):
        return np.asarray(jnp.asarray(a, jnp.float32), np.float64)

    return {"x": n(x), "m": n(m) if bn else None, "v": n(v) if bn else None,
            "dy": n(dy), "dscale": n(dscale) if bn else None,
            "dbias": n(dbias)}


def assert_close_bf16(got, want, what):
    tol = (BF16_REL * np.maximum(np.abs(got), np.abs(want))
           + F32_ABS * np.abs(want).max())
    assert got.shape == want.shape, what
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, int(bad.sum()), np.abs(got - want).max())


def assert_close_stats(got, want, keys=("m", "v", "dscale", "dbias")):
    for k in keys:
        if want[k] is None:
            assert got[k] is None, k
            continue
        err = np.abs(got[k] - want[k]).max()
        assert err <= STAT_RTOL * max(np.abs(want[k]).max(), 1e-30), (k, err)


# ---------------------------------------------------------------------------
# (1) against jax.vjp of yolojax's epilogue; (2) against the plain ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,mode", CASES)
def test_function_matches_jax_vjp(c, mode):
    """Output, batch mean and variance, and the gradients of y, BN's scale
    and bias (or the layer's bias), against ``jax.vjp`` of the jitted
    epilogue on the same bf16 y and g, within the tolerances above."""
    args = layer_inputs(c, seed=c)
    got, want = port_layer(*args, mode), jax_layer(*args, mode)
    assert_close_bf16(got["x"], want["x"], "x")
    assert_close_bf16(got["dy"], want["dy"], "dy")
    assert_close_stats(got, want)


@pytest.mark.parametrize("mode", ["bn", "bias", "linear"])
def test_ties_at_zero_match_jax_vjp(mode):
    """Values on leaky's zero (z = +0 exactly: y = -bias, a zero channel
    with a zero bias) take slope 1, as ``jnp.where(x >= 0, ...)``'s VJP
    does; one bf16 step below zero takes alpha. In the bias modes the
    gradient of y equals yolojax's bit for bit."""
    args = layer_inputs(32, seed=3, ties=True)
    got, want = port_layer(*args, mode), jax_layer(*args, mode)
    assert_close_bf16(got["x"], want["x"], "x")
    assert_close_bf16(got["dy"], want["dy"], "dy")
    assert_close_stats(got, want)
    if mode == "bn":  # the zero channel: z = +0, so x = 0
        assert not got["x"][..., 0].any()
    else:
        assert np.array_equal(got["dy"], want["dy"])
    if mode == "bias":  # z = +0 takes slope 1, one step below alpha
        y, g = args[0].float().numpy(), args[1].float().numpy()
        z0 = (y + args[3].numpy()) == 0
        assert z0.sum() > 0 and np.array_equal(got["dy"][z0], g[z0])


@pytest.mark.parametrize("c,mode", CASES)
def test_function_matches_plain_autograd(c, mode):
    """Against autograd of the plain ops the bf16 train forward ran before:
    the forward (x, m, v) equal bit for bit on the CPU, the gradients
    within the tolerances above (the Function's closed-form backward sums
    in another order than autograd's chain through the mean and the
    variance)."""
    args = layer_inputs(c, seed=c + 1)
    got, want = port_layer(*args, mode), plain_layer(*args, mode)
    for k in ("x", "m", "v"):
        assert (got[k] is None and want[k] is None) or np.array_equal(
            got[k], want[k]), k
    assert_close_bf16(got["dy"], want["dy"], "dy")
    assert_close_stats(got, want, ("dscale", "dbias"))


def test_network_forward_bit_equal_and_dispatch():
    """A bf16 train forward of tiny v2 through the Function equals the
    plain ops' forward bit for bit (output and new BN state); every conv
    goes through it (8 BN convs, the bias head), f32 train mode through
    none."""
    from yolojax_torch.models import get_model

    tm = get_model("yolo2", "tiny", 3)
    net = tm.init(torch.Generator().manual_seed(0), 64)
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    modes = []

    def spy(y, scale, bias, **kw):
        modes.append("bn")
        return fn_bn(y, scale, bias, **kw)

    def spy_bias(y, b, **kw):
        modes.append("bias")
        return fn_bias(y, b, **kw)

    fn_bn, fn_bias = (train_epilogue.bn_train_epilogue,
                      train_epilogue.bias_train_epilogue)
    with mock.patch.object(train_epilogue, "bn_train_epilogue", spy), \
            mock.patch.object(train_epilogue, "bias_train_epilogue",
                              spy_bias):
        got, got_state = tm.apply(net, x, compute_dtype=torch.bfloat16,
                                  train=True)
        assert modes == ["bn"] * 8 + ["bias"]
        tm.apply(net, x, compute_dtype=torch.float32, train=True)
        assert len(modes) == 9
    with mock.patch.object(train_epilogue, "bn_train_epilogue",
                           _plain_bn), \
            mock.patch.object(train_epilogue, "bias_train_epilogue",
                              _plain_bias):
        want, want_state = tm.apply(net, x, compute_dtype=torch.bfloat16,
                                    train=True)
    assert torch.equal(got, want)
    assert got_state.keys() == want_state.keys()
    for k in want_state:
        assert all(torch.equal(a, b) for a, b in zip(got_state[k],
                                                     want_state[k])), k


def _plain_bn(y, scale, bias, *, leaky, alpha=ALPHA, eps=EPS, group=None):
    """The plain ops of ``Network.forward``'s f32 branch, for a BN conv."""
    yf = y.float()
    m, v = layers._batch_moments(yf)
    z = layers.batch_norm(yf, scale, bias, m, v, eps=eps)
    if leaky:
        z = layers.leaky_relu(z, alpha)
    return z.to(torch.bfloat16), m.detach(), v.detach()


def _plain_bias(y, b, *, leaky, alpha=ALPHA):
    z = y.float() + b.float()
    if leaky:
        z = layers.leaky_relu(z, alpha)
    return z.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# (3) float64 gradcheck of the plain versions through the Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["bn", "bn_linear", "bias", "linear"])
def test_gradcheck_float64(mode):
    """The Function's backward (``epilogue_grad_sums_torch`` and
    ``epilogue_grad_apply_torch`` in float64) against finite differences
    of its forward (``bn_channel_sums_torch`` and ``conv_epilogue_torch``
    in float64)."""
    rng = np.random.RandomState(7)
    y = torch.from_numpy(rng.normal(0.5, 1.5, (2, 3, 2, 4))).requires_grad_()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 4)).requires_grad_()
    bias = torch.from_numpy(rng.normal(0, 0.5, 4)).requires_grad_()
    leaky = mode in ("bn", "bias")
    if mode.startswith("bn"):
        def fn(y, scale, bias):
            return train_epilogue.bn_train_epilogue(
                y, scale, bias, leaky=leaky, alpha=ALPHA, eps=EPS)[0]
        inputs = (y, scale, bias)
    else:
        def fn(y, bias):
            return train_epilogue.bias_train_epilogue(y, bias, leaky=leaky,
                                                      alpha=ALPHA)
        inputs = (y, bias)
    assert fn(*inputs).dtype == torch.float64
    assert torch.autograd.gradcheck(fn, inputs)


def test_plain_versions_are_the_ops_on_the_cpu():
    """The custom operators' CPU implementations are the plain versions,
    and ``torch.library.opcheck`` passes on each (BN and bias modes, a
    column slice of a wider gradient)."""
    y, g, scale, bias = layer_inputs(32, seed=9)
    wide = torch.cat([g, g], -1)[..., 16:48]  # rows at stride 64
    m = bn_channel_sums_torch(y) / 120
    rstd = torch.rsqrt(bn_channel_sums_torch(y, m) / 120 + EPS)
    inv, shift = rstd * scale, bias - m * rstd * scale
    sums = epilogue_grad_sums_torch(wide, y, inv, shift, m, rstd, True, ALPHA)
    cases = [
        (ops.bn_channel_sums, (y, None)), (ops.bn_channel_sums, (y, m)),
        (ops.epilogue_grad_sums, (wide, y, inv, shift, m, rstd, True, ALPHA)),
        (ops.epilogue_grad_sums, (g, y, None, bias, None, None, False, ALPHA)),
        (ops.epilogue_grad_apply, (wide, y, inv, shift, m, rstd,
                                   sums[0] / 120, sums[1] / 120, True,
                                   ALPHA)),
        (ops.epilogue_grad_apply, (g, y, None, bias, None, None, None, None,
                                   True, ALPHA))]
    plain = {ops.bn_channel_sums: bn_channel_sums_torch,
             ops.epilogue_grad_sums: epilogue_grad_sums_torch,
             ops.epilogue_grad_apply: epilogue_grad_apply_torch}
    before = cuda_bn_train.epilogue_grad_sums_cuda.launches
    for op, args in cases:
        assert torch.equal(op(*args), plain[op](*args))
        torch.library.opcheck(op, args)
    assert cuda_bn_train.epilogue_grad_sums_cuda.launches == before
    assert epilogue_grad_apply_torch(*cases[4][1]).is_contiguous()


@pytest.mark.parametrize("rows,c,vec", [
    (64 * 208 * 208, 32, 8), (64 * 416 * 416, 32, 8), (64 * 13 * 13, 1024, 8),
    (64 * 13 * 13, 125, 1), (64, 4096, 8), (3, 8, 8), (1, 20, 1),
    (7 * 10 ** 7, 8, 8)])
def test_sums_geometry(rows, c, vec):
    """The reduction grid the wrappers give the kernels: every row in one
    non-empty chunk, at most MAX_TERMS values a thread, a grid the card
    takes (at most 65,535 chunks), and the lanes a block sums."""
    tiles, lanes, chunk_rows, chunks = cuda_bn_train.sums_geometry(
        rows, c, vec, 132)
    units = c // vec
    assert tiles * min(units, cuda_bn_train.MAX_UNITS) >= units
    assert lanes * min(units, cuda_bn_train.MAX_UNITS) <= cuda_bn_train.THREADS
    assert (chunks - 1) * chunk_rows < rows <= chunks * chunk_rows
    assert -(-chunk_rows // lanes) <= cuda_bn_train.MAX_TERMS
    assert 1 <= chunks <= 65535


# ---------------------------------------------------------------------------
# (4) bf16 train steps against yolojax; (5) remat
# ---------------------------------------------------------------------------


def _v1_specs(m):
    """A small YOLOv1 without dropout (yolojax's and the port's dropout
    draw different bits): a bias conv, a BN conv, two dense layers."""
    return (m.ConvSpec(8, 3, bn=False), m.MaxPoolSpec(), m.ConvSpec(16, 3),
            m.MaxPoolSpec(), m.FlattenSpec(), m.DenseSpec(32),
            m.DenseSpec(2 * 2 * (3 + 5), act="linear"))


def step_models(arch):
    if arch == "v2":
        return jax_micro_model(), micro_model()
    return (JaxModel("yolo", "micro", "v1", _v1_specs(jax_layers), 3, 16,
                     boxes_per_cell=1, grid=2),
            Model("yolo", "micro", "v1", _v1_specs(layers), 3, 16,
                  boxes_per_cell=1, grid=2))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree, np.float64)


def tree_err(got, want) -> float:
    """max |got - want| over the tree, of the tree's largest |want|."""
    def walk(g, w):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w)
            return max(walk(g[k], w[k]) for k in w)
        return float(np.abs(np.asarray(g, np.float64)
                            - np.asarray(w, np.float64)).max())

    return walk(got, want) / max(max(np.abs(v).max() for v in _leaves(want)),
                                 1e-30)


def _port_step(tm, ttx, ts, batch, plain=False, remat=False):
    """One bf16 step with the gradients; ``plain``: the plain ops in place
    of the Function."""
    fn = step.make_train_step(tm, ttx, augment=False,
                              compute_dtype=torch.bfloat16, remat=remat)
    if not plain:
        return fn(ts, batch, 1, 32, with_grads=True)
    with mock.patch.object(train_epilogue, "bn_train_epilogue", _plain_bn), \
            mock.patch.object(train_epilogue, "bias_train_epilogue",
                              _plain_bias):
        return fn(ts, batch, 1, 32, with_grads=True)


@pytest.mark.parametrize("arch", ["v2", "v1"])
def test_bf16_train_step_matches_jax(arch):
    """One bf16 train step (``augment=False``) from yolojax's initial
    state carried over, port vs yolojax's ``make_train_step``: every loss
    term, the gradients and the new BN statistics, within the STEP
    tolerances; and the Function's step is no further from yolojax than
    the plain ops' (the same loss, gradients as close)."""
    jm, tm = step_models(arch)
    kw = dict(optimizer="momentum", learning_rate=1e-2)
    jtx = jax_step.make_optimizer(jax_step.OptimizerConfig(**kw))
    ttx = step.make_optimizer(step.OptimizerConfig(**kw))
    jts = jax_step.init_train_state(jm, jtx, jax.random.PRNGKey(0), 32)
    start = train_state_from_jax(tm, jts, ttx)  # before jax's step donates
    batch = _batch(seed=1)
    tbatch = tuple(torch.from_numpy(np.array(a)) for a in batch)
    jfn = jax_step.make_train_step(jm, jtx, augment=False,
                                   compute_dtype=jnp.bfloat16)
    jts, jmet = jfn(jts, batch, jax.random.PRNGKey(1), dim=32,
                    with_grads=True)
    jgrads = jax.device_get(jmet.pop("grads"))
    errs = {}
    for plain in (False, True):
        ts, met = _port_step(tm, ttx, copy.deepcopy(start), tbatch, plain)
        grads = tensors_to_jax(tm, met.pop("grads"))
        loss = {k: float(met[k]) for k in met}
        errs[plain] = tree_err(grads, jgrads)
        if not plain:
            for k in jmet:
                np.testing.assert_allclose(loss[k], float(jmet[k]),
                                           rtol=STEP_LOSS_RTOL, err_msg=k)
            bn = train_state_to_jax(tm, ts)["bn_state"]
            assert tree_err(bn, jax.device_get(jts.bn_state)) <= STEP_BN_RTOL
            kernel_loss = loss
    assert errs[False] <= STEP_GRAD_RTOL
    assert errs[False] <= errs[True] + 1e-4
    assert {k: kernel_loss[k] for k in kernel_loss if k != "grad_norm"} == {
        k: v for k, v in loss.items() if k != "grad_norm"}


def test_remat_bit_equal():
    """``remat=True`` (non-reentrant ``torch.utils.checkpoint``) re-runs
    the Function in the backward and gives the same step bit for bit:
    metrics, gradients, parameters and BN statistics."""
    jm, tm = step_models("v2")
    kw = dict(optimizer="momentum", learning_rate=1e-2)
    ttx = step.make_optimizer(step.OptimizerConfig(**kw))
    start = step.init_train_state(tm, ttx, torch.Generator().manual_seed(0),
                                  32)
    batch = tuple(torch.from_numpy(np.array(a)) for a in _batch(seed=2))
    out = {}
    for remat in (False, True):
        ts, met = _port_step(tm, ttx, copy.deepcopy(start), batch,
                             remat=remat)
        out[remat] = (ts, met)
    (a, ma), (b, mb) = out[False], out[True]
    for k in ma["grads"]:
        assert torch.equal(ma["grads"][k], mb["grads"][k]), k
    for k in ma:
        if k != "grads":
            assert torch.equal(ma[k], mb[k]), k
    for (k, p), (_, q) in zip(a.net.state_dict().items(),
                              b.net.state_dict().items()):
        assert torch.equal(p, q), k


# ---------------------------------------------------------------------------
# (6) two gloo ranks on halves of the batch against one process
# ---------------------------------------------------------------------------


def _halves_rank(rank, out_dir):
    """On each rank: the Function on this rank's half of one BN layer's
    input and gradient over the data group, and one bf16 micro-v2 step on
    this rank's half of the batch (data parallel, global-batch BN)."""
    torch.set_num_threads(1)
    mesh = make_mesh(data=2)
    y, g, scale, bias = layer_inputs(32, seed=11)
    rows = slice(2 * rank, 2 * rank + 2)
    ys = y[rows].clone().requires_grad_()
    sc, bi = scale.clone().requires_grad_(), bias.clone().requires_grad_()
    x, m, v = train_epilogue.bn_train_epilogue(
        ys, sc, bi, leaky=True, alpha=ALPHA, eps=EPS, group=mesh.data_group)
    x.backward(g[rows])
    layer = {"x": x.detach().double().numpy(), "m": m.double().numpy(),
             "v": v.double().numpy(), "dy": ys.grad.double().numpy(),
             "dscale": sc.grad.double().numpy(),
             "dbias": bi.grad.double().numpy()}
    tm = micro_model()
    ttx = step.make_optimizer(step.OptimizerConfig(optimizer="momentum",
                                                   learning_rate=1e-2))
    ts = step.init_train_state(tm, ttx, torch.Generator().manual_seed(0), 32)
    Plan(mesh).shard(ts)
    batch = shard_batch(mesh, tuple(torch.from_numpy(np.array(a))
                                    for a in _batch(seed=3)))
    ts, met = _port_step(tm, ttx, ts, batch)
    if rank == 0:
        torch.save({"grads": met.pop("grads"),
                    "state": dict(ts.net.state_dict())},
                   os.path.join(out_dir, "halves.pt"))
    return layer, {k: float(v) for k, v in met.items() if k != "grads"}


def test_two_ranks_on_halves_match_one_process(tmp_path):
    """Two ``gloo`` ranks, each on half of the batch, against one process
    on the whole batch: the layer's output and dy (concatenated), m and v,
    the summed scale and bias gradients; and the data-parallel bf16 step's
    metrics, gradients and BN statistics."""
    res = launch.run(_halves_rank, 2, args=(str(tmp_path),), device="cpu",
                     timeout=SPAWN_TIMEOUT)
    args = layer_inputs(32, seed=11)
    want = port_layer(*args, "bn")
    (l0, met0), (l1, met1) = res
    got = {"x": np.concatenate([l0["x"], l1["x"]]),
           "dy": np.concatenate([l0["dy"], l1["dy"]]),
           "m": l0["m"], "v": l0["v"],
           "dscale": l0["dscale"] + l1["dscale"],
           "dbias": l0["dbias"] + l1["dbias"]}
    assert np.array_equal(l0["m"], l1["m"]) and np.array_equal(l0["v"],
                                                               l1["v"])
    assert_close_bf16(got["x"], want["x"], "x")
    assert_close_bf16(got["dy"], want["dy"], "dy")
    assert_close_stats(got, want)

    tm = micro_model()
    ttx = step.make_optimizer(step.OptimizerConfig(optimizer="momentum",
                                                   learning_rate=1e-2))
    ts = step.init_train_state(tm, ttx, torch.Generator().manual_seed(0), 32)
    batch = tuple(torch.from_numpy(np.array(a)) for a in _batch(seed=3))
    ts, met = _port_step(tm, ttx, ts, batch)
    assert met0 == met1
    for k in met0:  # the norm of the gradients is held with them
        np.testing.assert_allclose(
            met0[k], float(met[k]), err_msg=k,
            rtol=HALVES_GRAD_RTOL if k == "grad_norm" else HALVES_LOSS_RTOL)
    two = torch.load(tmp_path / "halves.pt")
    grads = {k: v.numpy() for k, v in met["grads"].items()}
    stats = {k: v.numpy() for k, v in ts.net.state_dict().items()
             if k.endswith((".mean", ".var"))}
    assert tree_err({k: v.numpy() for k, v in two["grads"].items()},
                    grads) <= HALVES_GRAD_RTOL
    assert tree_err({k: two["state"][k].numpy() for k in stats},
                    stats) <= HALVES_BN_RTOL
    assert sum(isinstance(s, ConvSpec) and s.bn for s in tm.specs) == 2
