"""The port's QAT (``yolojax_torch/quantize/qat.py``) against yolojax's on
the CPU: ``fake_quant`` and the weight scales bit for bit against
``jax.jit`` (which multiplies by a baked scale's f32 reciprocal and
contracts ``round(x / s) * s - x`` into one FMA), the fake-quant forward
layer by layer, three QAT and distill steps from a carried-over yolojax
state (each gradient leaf against ``jax.grad``, each parameter's change
against yolojax's), the gradients through Darknet-19's route, yolojax's
QAT-beats-PTQ gate on its own init, the identity-BN re-embedding in both
packages, and the tuned model's int8 codes against
``jax.jit(apply_int8)``."""

import collections
import copy
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.convert.store import load_params_npz as jax_load_npz
from yolojax.convert.store import save_params_npz as jax_save_npz
from yolojax.data.augment import AugmentConfig as JaxAugmentConfig
from yolojax.models import get_model as jax_get_model
from yolojax.nn.layers import apply_network as jax_apply_network
from yolojax.quantize import ptq as jax_ptq
from yolojax.quantize import qat as jax_qat
from yolojax.train.step import default_loss_cfg as jax_default_loss_cfg
from yolojax.train.step import make_head_loss as jax_make_head_loss
from yolojax.train.step import prepare_images as jax_prepare_images
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import (
    params_from_jax,
    params_to_jax,
    quantized_from_jax,
    tensors_to_jax,
    train_state_from_jax,
)
from yolojax_torch.convert.store import load_network_npz, save_network_npz
from yolojax_torch.models import get_model
from yolojax_torch.nn.layers import ConvSpec
from yolojax_torch.quantize import ptq, qat
from yolojax_torch.train import step as train_step

from .test_torch_ptq import assert_int8_parity, folded_pair, jax_int8, port_int8

# The fake-quant graph in f32 on both sides: the convs sum in other orders
# (XLA vs oneDNN), so a pre-quant value may land on the other side of a .5
# boundary and flip a code. On these seeded inputs no code flips (each
# layer's count is printed and asserted); the head then differs by the sum
# order alone, measured ~5e-7 of max|head|.
HEAD_RTOL = 1e-5
# One step on both sides from one carried-over state, held by whether a
# fake-quant code flipped between the two forwards (counted layer by layer
# on the step's images and weights). The convs sum in other orders, so a
# pre-quant value on a .5 boundary may flip one code, which moves that
# activation a whole grid step: the loss then moves by ~1e-4 of itself and
# the gradients of the layers it feeds by ~1e-3 of their largest value
# (measured on step 3 of the detection loss: 3.8e-4 on the object term,
# 2.2e-3 on conv_13's kernel). With no flip the loss agrees to ~4e-6 and
# each gradient leaf to ~2.4e-5 of its largest value (the distill step).
# Limits: loss terms 1e-5 relative and every gradient leaf 1e-4 of its
# largest |value| with no flip; 2e-3 and 1e-2 with flips.
LOSS_RTOL, FLIP_LOSS_RTOL = 1e-5, 2e-3
GRAD_RTOL, FLIP_GRAD_RTOL = 1e-4, 1e-2
# Each parameter leaf's change in the step (new - old), against yolojax's
# change, by the norm of the difference over the norm of that change. An
# adam step at lr 1e-5 moves a weight by ~1e-5, which the f32 add rounds
# to ~1e-3 of itself, and where adam divides a gradient that agrees to
# 1e-6 by its root mean square the updates agree less: measured 5.4e-4
# with no flip, 2.5e-3 with. A step that applies no update reads 1, a
# sign-flipped one 2.
DELTA_RTOL = 1e-2
DIM = 32
LR = 1e-5  # QatConfig's default


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# .5 ties (at scale 1: 0.5, 1.5, 2.5, -2.5), the clipped tails, zero
TIES = np.asarray([-300.0, -2.5, -1.05, -0.5, 0.0, 0.49, 0.5, 1.0, 1.5, 2.5,
                   250.0], np.float32)


def _values(seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([TIES, (rng.randn(20000) * 40).astype(np.float32)])


@pytest.mark.parametrize("scale,baked,qmax", [
    (1.0, True, 127.0), (0.0371, True, 127.0), (0.0371, False, 127.0),
    (0.7, True, 15.0),
], ids=["baked-1", "baked-0.0371", "computed-0.0371", "5-bit"])
def test_fake_quant_matches_jit(scale, baked, qmax):
    """A baked (Python float) scale against ``jax.jit`` with the scale
    closed over, a computed one against the scale passed in; bit for bit,
    and the straight-through gradient equal to ``jax.jit(jax.grad)``'s
    (identity, also in the clipped tail)."""
    x = _values(0)
    if baked:
        want = jax.jit(lambda t: jax_qat.fake_quant(t, scale, qmax))(
            jnp.asarray(x))
        arg = scale
    else:
        want = jax.jit(lambda t, s: jax_qat.fake_quant(t, s, qmax))(
            jnp.asarray(x), np.float32(scale))
        arg = torch.tensor(scale)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = qat.fake_quant(xt, arg, qmax)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got ** 2).sum().backward()
    grad = jax.jit(jax.grad(lambda t: jnp.sum(
        jax_qat.fake_quant(t, scale, qmax) ** 2)))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(grad))


@pytest.mark.parametrize("shape,qmax", [((3, 3, 16, 64), 127.0),
                                        ((3, 3, 16, 64), 15.0),
                                        ((96, 40), 127.0)],
                         ids=["conv", "conv-5-bit", "dense"])
def test_weight_fake_quant_matches_jit(shape, qmax):
    """Per-output-channel scales and the fake-quantized kernel, bit for
    bit: yolojax's HWIO / (in, out) kernel against the port's OIHW /
    (out, in) copy of it."""
    w = (np.random.RandomState(1).randn(*shape) * 0.1).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero channel: the 1e-8 clamp
    wt = torch.from_numpy(w)
    wt = wt.permute(3, 2, 0, 1) if w.ndim == 4 else wt.T
    scale = jax.jit(lambda t: jax_qat.weight_scale(t, qmax))(jnp.asarray(w))
    np.testing.assert_array_equal(qat.weight_scale(wt, qmax).reshape(-1),
                                  np.asarray(scale))
    want = jax.jit(lambda t: jax_qat.fake_quant_weight(t, qmax))(
        jnp.asarray(w))
    got = qat.fake_quant_weight(wt, qmax)
    got = got.permute(2, 3, 1, 0) if w.ndim == 4 else got.T
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def make_jax_qat_forward(jm, in_scale, act_scales, qmax=127.0):
    """``jax.jit(qat_forward)`` with the scales baked in, as
    ``make_qat_step`` bakes them: (params, images) -> (head, every
    fake-quantized activation in order). The activations are the jitted
    graph's own values."""

    def fn(p, imgs):
        acts = []
        orig = jax_qat.fake_quant

        def rec(t, s, q=127.0):
            out = orig(t, s, q)
            acts.append(out)
            return out

        def weight(w, q=127.0):  # not an activation: not recorded
            return orig(w, jax_qat.weight_scale(w, q), q)

        with mock.patch.object(jax_qat, "fake_quant", rec), \
                mock.patch.object(jax_qat, "fake_quant_weight", weight):
            head = jax_qat.qat_forward(jm, p, imgs, in_scale, act_scales,
                                       qmax=qmax)
        return head, acts

    return jax.jit(fn)


def jax_qat_forward(jm, params, x, in_scale, act_scales, qmax=127.0):
    head, acts = make_jax_qat_forward(jm, in_scale, act_scales, qmax)(
        params, jnp.asarray(x))
    return np.asarray(head), [np.asarray(a) for a in acts]


def act_grid_steps(tm, in_scale, act_scales):
    """The grid step of each activation ``qat_forward`` records."""
    return [in_scale] + [act_scales[i] for i, s in enumerate(tm.specs)
                         if type(s).__name__ in ("ConvSpec", "RouteSpec",
                                                 "DenseSpec")]


def count_flips(got_acts, acts, scales):
    """Codes that differ between two fake-quant forwards, layer by
    layer."""
    return [int((np.abs(np.asarray(g, np.float64) - a) > s / 2).sum())
            for g, a, s in zip(got_acts, acts, scales)]


@pytest.mark.parametrize("name,inference,dim", [("yolo2", "tiny", DIM),
                                                 ("yolo", "tiny", 64)],
                         ids=["tiny-v2", "v1-dense"])
def test_qat_forward_matches_jit(name, inference, dim):
    """Every fake-quantized activation (the input bit for bit), counting
    the codes that flipped at a .5 boundary layer by layer, and the f32
    head."""
    tm, net, jm, params = folded_pair(name, inference, 3, dim, seed=21)
    x = np.random.RandomState(2).uniform(0, 1, (2, dim, dim, 3)).astype(
        np.float32)
    in_scale, act_scales = jax_ptq.calibrate(jm, params, jnp.asarray(x),
                                             compute_dtype=jnp.float32)
    head, acts = jax_qat_forward(jm, params, x, in_scale, act_scales)
    got_acts = []
    got = qat.qat_forward(tm, net, torch.from_numpy(x), in_scale, act_scales,
                          activations=got_acts)
    scales = act_grid_steps(tm, in_scale, act_scales)
    assert len(got_acts) == len(acts) == len(scales)
    np.testing.assert_array_equal(got_acts[0].numpy(), acts[0])
    flips = count_flips([g.detach() for g in got_acts], acts, scales)
    print(f"{name}/{inference}: codes flipped per layer {flips} of "
          f"{[a.size for a in acts]}")
    assert flips == [0] * len(flips)
    err = np.abs(got.detach().numpy() - head).max() / np.abs(head).max()
    assert got.shape == head.shape and err <= HEAD_RTOL, err


def test_qat_forward_rejects_unfolded_model():
    model = get_model("yolo2", "tiny", 2)
    net = model.init(torch.Generator().manual_seed(0), DIM)
    with pytest.raises(ValueError, match="fold_bn"):
        qat.qat_forward(model, net, torch.zeros((1, DIM, DIM, 3)), 1.0,
                        [1.0] * len(model.specs))


def test_dropout_draws_and_apply():
    """v1's dropout in train mode: the keep draw is the port's own (not
    JAX's bits), so it is held to its rate; the kept values are scaled by
    1 / (1 - rate) exactly. A train-mode forward runs it and needs a
    generator."""
    x = torch.from_numpy(np.random.RandomState(3).uniform(
        0.1, 1, (4, 7, 7, 256)).astype(np.float32))
    out = qat.dropout(x, 0.5, torch.Generator().manual_seed(5))
    keep = out != 0
    assert abs(keep.float().mean().item() - 0.5) < 0.02
    assert torch.equal(out[keep], x[keep] / 0.5)
    tm, net, _, _ = folded_pair("yolo", "tiny", 3, 64, seed=22)
    imgs = torch.from_numpy(np.random.RandomState(4).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    scales = [0.05] * len(tm.specs)
    with torch.no_grad():
        ref = qat.qat_forward(tm, net, imgs, 0.01, scales)
        got = qat.qat_forward(tm, net, imgs, 0.01, scales, train=True,
                              generator=torch.Generator().manual_seed(5))
    assert got.shape == ref.shape and not torch.equal(got, ref)
    with pytest.raises(ValueError, match="generator"):
        qat.qat_forward(tm, net, imgs, 0.01, scales, train=True)


def _batch(seed, n=4):
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 1, (n, DIM, DIM, 3)).astype(np.float32)
    boxes = np.zeros((n, 4, 4), np.float32)
    boxes[:, 0] = [0.4, 0.5, 0.3, 0.3]
    boxes[:, 1] = [0.7, 0.3, 0.2, 0.2]
    cls = rng.randint(0, 3, (n, 4)).astype(np.int32)
    valid = np.zeros((n, 4), bool)
    valid[:, :2] = True
    return images, boxes, cls, valid


QatSetup = collections.namedtuple(
    "QatSetup", "tm net jm params in_scale act_scales jtx ttx")


@pytest.fixture(scope="module")
def qat_setup():
    """Folded tiny-v2 @ 32 on both sides, its calibration, and the QAT
    optimizer (clip 1.0, then adam) on both sides."""
    tm, net, jm, params = folded_pair("yolo2", "tiny", 3, DIM, seed=23)
    calib = _batch(0)[0]
    in_scale, act_scales = jax_ptq.calibrate(jm, params, jnp.asarray(calib))
    qcfg = qat.QatConfig(learning_rate=LR, grad_clip_norm=1.0)
    jtx = jax_qat.make_qat_optimizer(jax_qat.QatConfig(
        learning_rate=LR, grad_clip_norm=1.0))
    return QatSetup(tm, net, jm, params, in_scale, act_scales, jtx,
                    qat.make_qat_optimizer(qcfg))


def _carry(s, jst):
    """A yolojax QatState -> the port's, on the CPU."""
    shim = collections.namedtuple("S", "step params bn_state opt_state")(
        jst.step, jax.device_get(jst.params), {}, jst.opt_state)
    ts = train_state_from_jax(s.tm, shim, s.ttx)
    return qat.QatState(ts.step, ts.net.requires_grad_(True), ts.opt_state)


def _jax_grad_fn(s, distill):
    """``jax.grad`` of a QAT step's own loss (``augment=False``: the
    images are the batch's), jitted: (params, batch, teacher) -> grads."""
    loss_from_head = jax_make_head_loss(s.jm, jax_default_loss_cfg(s.jm))
    act_scales = tuple(float(a) for a in s.act_scales)

    def fn(params, batch, teacher):
        images, gt_xywh, gt_class, gt_valid = batch
        images, gt_xywh, gt_valid = jax_prepare_images(
            jax.random.PRNGKey(0), images, gt_xywh, gt_valid, DIM,
            JaxAugmentConfig(), False)
        target = jax_apply_network(s.jm.specs, teacher, {}, images,
                                   compute_dtype=jnp.float32)[0]

        def loss(p):
            head = jax_qat.qat_forward(s.jm, p, images, float(s.in_scale),
                                       act_scales, train=True,
                                       rng=jax.random.PRNGKey(1))
            if distill:
                flat = head.reshape(head.shape[0], -1)
                return jnp.mean((flat - target.reshape(flat.shape)) ** 2)
            return loss_from_head(head, gt_xywh, gt_class, gt_valid)["total"]

        return jax.grad(loss)(params)

    return jax.jit(fn)


def _leaf_errs(got, want, base=None):
    """Each leaf's largest |got - want| over its largest |want|, or with
    ``base``, the norm of got - want over the norm of want - base (the
    step's change)."""
    out = {}
    for name in want:
        for k in want[name]:
            w = np.asarray(want[name][k], np.float64)
            d = np.asarray(got[name][k], np.float64) - w
            if base is None:
                out[f"{name}/{k}"] = np.abs(d).max() / max(np.abs(w).max(),
                                                           1e-30)
            else:
                ref = w - np.asarray(base[name][k], np.float64)
                out[f"{name}/{k}"] = np.linalg.norm(d) / max(
                    np.linalg.norm(ref), 1e-30)
    return out


@pytest.mark.parametrize("distill", [False, True],
                         ids=["detection-loss", "distill"])
def test_qat_steps_match_jit(qat_setup, distill):
    """Three steps, each from the yolojax state carried over (the first
    after one yolojax step, so adam's buffers are not zero), with
    ``augment=False`` on the same batches: every loss term and the grad
    norm, every gradient leaf against ``jax.grad`` of the same loss on the
    carried-over weights, and every parameter's change in the step against
    yolojax's change. Each step starts from equal weights because the
    fake-quant loss is a step function of them: one code flipped at a .5
    boundary by a last-bit difference moves the loss by ~1e-4, so
    differences carried over several steps say nothing of one step's
    arithmetic. The distill teacher stays the untouched copy."""
    s = qat_setup
    kw = dict(augment=False)
    if distill:
        jfn = jax_qat.make_qat_distill_step(s.jm, s.jtx, s.in_scale,
                                            s.act_scales, **kw)
        tfn = qat.make_qat_distill_step(s.tm, s.ttx, s.in_scale,
                                        s.act_scales, **kw)
    else:
        jfn = jax_qat.make_qat_step(s.jm, s.jtx, s.in_scale, s.act_scales,
                                    **kw)
        tfn = qat.make_qat_step(s.tm, s.ttx, s.in_scale, s.act_scales, **kw)
    jgrad = _jax_grad_fn(s, distill)
    jacts = make_jax_qat_forward(s.jm, s.in_scale, s.act_scales)
    scales = act_grid_steps(s.tm, s.in_scale, s.act_scales)
    tight = 0
    teacher_j = jax.tree_util.tree_map(jnp.asarray, s.params)
    teacher_t = copy.deepcopy(s.net).requires_grad_(False)
    jst = jax_qat.QatState(jnp.zeros((), jnp.int32),
                           jax.tree_util.tree_map(jnp.asarray, s.params),
                           s.jtx.init(s.params))
    key = jax.random.PRNGKey(0)

    def jstep(st, batch):
        if distill:
            return jfn(st, batch, teacher_j, key, dim=DIM)
        return jfn(st, batch, key, dim=DIM)

    jst, _ = jstep(jst, tuple(jnp.asarray(a) for a in _batch(1)))
    teacher_w = teacher_t.conv_0.w.clone()
    for i in range(2, 5):
        tst = _carry(s, jst)
        assert tst.step == i - 1
        before = jax.device_get(jst.params)
        batch = tuple(jnp.asarray(a) for a in _batch(i))
        tbatch = tuple(torch.from_numpy(a) for a in _batch(i))
        got_acts = []
        with torch.no_grad():
            qat.qat_forward(s.tm, tst.net, tbatch[0], s.in_scale,
                            s.act_scales, activations=got_acts)
        flips = count_flips(got_acts, [np.asarray(a) for a in jacts(
            before, batch[0])[1]], scales)
        want_g = jax.device_get(jgrad(jst.params, batch, teacher_j))
        jst, jm_ = jstep(jst, batch)
        if distill:
            tst, tm_ = tfn(tst, tbatch, teacher_t, 0, DIM, with_grads=True)
        else:
            tst, tm_ = tfn(tst, tbatch, 0, DIM, with_grads=True)
        got_g = tensors_to_jax(s.tm, tm_.pop("grads"))
        assert set(tm_) == set(jm_) and tst.step == int(jst.step) == i
        # the gradients taken here are the step's own
        np.testing.assert_allclose(
            float(optax.global_norm(want_g)), float(jm_["grad_norm"]),
            rtol=1e-6)
        # the last is the head's own fake-quant output, which nothing reads
        flipped = any(flips[:-1])
        tight += not flipped
        loss_rtol = FLIP_LOSS_RTOL if flipped else LOSS_RTOL
        grad_rtol = FLIP_GRAD_RTOL if flipped else GRAD_RTOL
        rel = {k: abs(float(tm_[k]) - float(jm_[k])) / abs(float(jm_[k]))
               for k in jm_}
        gerr = _leaf_errs(got_g, want_g)
        derr = _leaf_errs(tensors_to_jax(s.tm, tst.params()),
                          jax.device_get(jst.params), base=before)
        print(f"step {i}: codes flipped per layer {flips}; relative "
              f"differences {rel}; worst gradient leaf "
              f"{max(gerr.items(), key=lambda kv: kv[1])}; worst change "
              f"{max(derr.items(), key=lambda kv: kv[1])}")
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=loss_rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        for k, e in gerr.items():
            assert e <= grad_rtol, (f"step {i} gradient {k}", e, grad_rtol)
        for k, e in derr.items():
            assert e <= DELTA_RTOL, (f"step {i} change of {k}", e)
    assert tight, "every step had a flipped code: no step held tightly"
    if distill:
        assert teacher_t.conv_0.w.data_ptr() != tst.net.conv_0.w.data_ptr()
        assert torch.equal(teacher_t.conv_0.w, teacher_w)


def test_qat_gradients_match_jax_grad_through_route():
    """Darknet-19 @ 32, whose passthrough runs the reorg, the route and the
    fake quantization of the concatenation: one QAT step's gradients, leaf
    by leaf, against ``jax.grad`` of the same loss, with the limits of
    :func:`test_qat_steps_match_jit`."""
    tm, net, jm, params = folded_pair("yolo2", "darknet", 3, DIM, seed=25)
    assert any(type(sp).__name__ == "RouteSpec" for sp in tm.specs)
    images, boxes, cls, valid = _batch(7, n=2)
    in_scale, act_scales = jax_ptq.calibrate(jm, params,
                                             jnp.asarray(_batch(0, n=2)[0]))
    s = QatSetup(tm, net, jm, params, in_scale, act_scales, None, None)
    want = jax.device_get(_jax_grad_fn(s, False)(
        params, tuple(jnp.asarray(a) for a in (images, boxes, cls, valid)),
        params))
    got_acts = []
    with torch.no_grad():
        qat.qat_forward(tm, net, torch.from_numpy(images), in_scale,
                        act_scales, activations=got_acts)
    flips = count_flips(got_acts, [np.asarray(a) for a in make_jax_qat_forward(
        jm, in_scale, act_scales)(params, jnp.asarray(images))[1]],
        act_grid_steps(tm, in_scale, act_scales))
    tx = qat.make_qat_optimizer(qat.QatConfig())
    step = qat.make_qat_step(tm, tx, in_scale, act_scales, augment=False)
    _, m = step(qat.init_qat_state(net, tx), tuple(
        torch.from_numpy(a) for a in (images, boxes, cls, valid)), 0, DIM,
        with_grads=True)
    errs = _leaf_errs(tensors_to_jax(tm, m["grads"]), want)
    limit = FLIP_GRAD_RTOL if any(flips[:-1]) else GRAD_RTOL
    print(f"codes flipped per layer {flips}; worst gradient leaf "
          f"{max(errs.items(), key=lambda kv: kv[1])} (limit {limit:g})")
    for k, e in errs.items():
        assert e <= limit, (k, e, limit)


def test_reembed_roundtrips_in_both_packages(tmp_path):
    """The port's identity-BN ``.npz`` equals yolojax's key for key and bit
    for bit, each loads in the other package, and folding it again gives
    the folded weights back within one f32 ulp in both packages."""
    unfolded = []
    tfm, tfolded, _, _ = folded_pair("yolo2", "tiny", 2, DIM, seed=24,
                                     unfolded=unfolded)
    tm = get_model("yolo2", "tiny", 2)
    registry = jax_get_model("yolo2", "tiny", num_classes=2)
    _, jfp, _ = jax_fold_bn(registry, *params_to_jax(tm, unfolded[0]))
    jax_npz, port_npz = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_npz(jax_npz, *jax_qat.reembed_folded(registry, jfp))
    save_network_npz(port_npz, tm, qat.reembed_folded(tm, tfolded))
    with np.load(jax_npz) as a, np.load(port_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)

    def near(got, want, what):
        close = np.isclose(got, want, rtol=3e-7, atol=1e-7)
        assert close.all(), what

    # the port's npz through yolojax's loader and fold
    _, refolded, _ = jax_fold_bn(registry, *jax_load_npz(port_npz))
    for name, layer in jfp.items():
        for k, v in layer.items():
            near(np.asarray(refolded[name][k]), np.asarray(v), f"jax {name}")
    # yolojax's npz through the port's loader and fold
    _, back = fold_bn(tm, load_network_npz(jax_npz, tm))
    want, _ = params_to_jax(tfm, tfolded)
    got, _ = params_to_jax(tfm, back)
    for name in want:
        for k in want[name]:
            near(got[name][k], want[name][k], f"port {name}")


def test_tuned_model_int8_codes_match_jit(qat_setup):
    """Two port QAT steps, the tuned weights re-embedded, reloaded and
    folded, quantized by yolojax and carried over: the port's
    ``apply_int8`` codes equal ``jax.jit(apply_int8)``'s at every layer."""
    s = qat_setup
    tst = qat.init_qat_state(copy.deepcopy(s.net), s.ttx)
    step = qat.make_qat_step(s.tm, s.ttx, s.in_scale, s.act_scales,
                             augment=False)
    for i in range(2):
        tst, _ = step(tst, tuple(torch.from_numpy(a) for a in _batch(i)),
                      0, DIM)
    registry = get_model("yolo2", "tiny", 3)
    tm, tuned = fold_bn(registry, qat.reembed_folded(registry, tst.net))
    params, _ = params_to_jax(tm, tuned)
    calib, x = _batch(5)[0][:2], _batch(6)[0][:2]
    jqm = jax_ptq.quantize_model(s.jm, params, jnp.asarray(calib))
    assert_int8_parity(jax_int8(jqm, x),
                       port_int8(quantized_from_jax(tm, jqm), x))


def test_qat_beats_ptq_on_yolojax_init():
    """yolojax's mechanism gate (tests/unit/test_qat.py) on its own net,
    init, images and calibration, carried into the port: 60 of the port's
    distill steps (fake-quant forward, straight-through estimator, adam at
    1e-4) toward the f32 outputs must descend (last < first, as yolojax
    asserts), and the port's int8 program of the tuned weights must track
    the f32 target better than PTQ of the original weights. The first loss
    is yolojax's own."""
    jm = jax_get_model("yolo2", "tiny", num_classes=2)
    jparams, jstate = jm.init(jax.random.PRNGKey(7), 32)
    jm, jparams, _ = jax_fold_bn(jm, jparams, jstate)
    x = np.random.RandomState(7).uniform(0, 1, (4, 32, 32, 3)).astype(
        np.float32)
    jtarget, _ = jm.apply(jparams, {}, jnp.asarray(x),
                          compute_dtype=jnp.float32)
    in_scale, act_scales = jax_ptq.calibrate(jm, jparams, jnp.asarray(x))
    jhead, _ = jax_qat_forward(jm, jparams, x, in_scale, act_scales)
    jfirst = float(np.mean((jhead - np.asarray(jtarget)) ** 2))

    model = get_model("yolo2", "tiny", 2)
    tm = dataclasses.replace(model, specs=tuple(  # fold_bn's specs
        dataclasses.replace(sp, bn=False) if isinstance(sp, ConvSpec) else sp
        for sp in model.specs))
    net = params_from_jax(tm, jax.device_get(jparams), {})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        target = tm.apply(net, xt, compute_dtype=torch.float32)

    def int8_err(n):
        qm = ptq.quantize_model(tm, n.requires_grad_(False), xt)
        with torch.inference_mode():
            return float(((ptq.apply_int8(qm, xt) - target) ** 2).mean())

    err_ptq = int8_err(net)
    tx = train_step.make_optimizer(train_step.OptimizerConfig(
        optimizer="adam", learning_rate=1e-4, weight_decay=0.0))
    step = qat.make_qat_distill_step(tm, tx, in_scale, act_scales,
                                     augment=False)
    st = qat.init_qat_state(copy.deepcopy(net), tx)
    teacher = net.requires_grad_(False)
    batch = (xt, torch.zeros((4, 1, 4)),
             torch.zeros((4, 1), dtype=torch.int32),
             torch.zeros((4, 1), dtype=torch.bool))
    losses = []
    for _ in range(60):
        st, m = step(st, batch, teacher, 0, 32)
        losses.append(float(m["total"]))
    err_qat = int8_err(st.net)
    print(f"first {losses[0]:.4e} (yolojax {jfirst:.4e}), max "
          f"{max(losses):.4e}, last {losses[-1]:.4e}; int8 MSE PTQ "
          f"{err_ptq:.4e}, QAT {err_qat:.4e}")
    np.testing.assert_allclose(losses[0], jfirst, rtol=1e-3)
    assert losses[-1] < losses[0]  # the STE actually descends
    assert err_qat < err_ptq, (err_qat, err_ptq)


def test_qat_optimizer_is_clip_then_adam(qat_setup):
    """``make_qat_optimizer``: the clip by global norm, then adam; no
    weight decay (the port's optax-equal ``Optimizer``)."""
    tx = qat_setup.ttx
    assert (tx.name, tx.cfg.grad_clip_norm, tx.cfg.weight_decay) == (
        "adam", 1.0, 0.0)
    p = {"w": torch.ones(3)}
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    state, jstate = tx.init(p), jtx.init({"w": jnp.ones(3)})
    # the first update (norm 50: clipped to 1), then grads under and over
    # the clip. The limit is bit equality: the port forms the bias
    # corrections 1 - b^t in f32 as optax does and divides by them as
    # tensors, and takes the f32 square roots correctly rounded
    for g in ([30.0, -40.0, 0.0], [0.1, 0.2, -0.3], [3.0, 1.0, -7.0],
              [0.0, 0.5, 0.25], [-2.0, 9.0, 4.0]):
        u, state = tx.update({"w": torch.tensor(g)}, state, p)
        ju, jstate = jtx.update({"w": jnp.asarray(g, jnp.float32)}, jstate)
        np.testing.assert_array_equal(u["w"].numpy(), np.asarray(ju["w"]))
