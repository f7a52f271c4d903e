"""The port's training pieces against yolojax's on the CPU in f32: the
train-mode forward and its new BN state, dropout, the schedules, the
multi-scale schedule, and the overfit gate of ``tests/e2e/test_overfit.py``
run on the port. Five optimizer steps of every optimizer variant are in
``test_torch_train_steps.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.models import get_model as jax_get_model
from yolojax.nn.layers import apply_network
from yolojax.train import step as jax_step
from yolojax_torch.config import load_config
from yolojax_torch.convert.interchange import params_from_jax
from yolojax_torch.models import Model, get_model
from yolojax_torch.nn.layers import ConvSpec, DropoutSpec, MaxPoolSpec, Network
from yolojax_torch.ops.boxes import iou_pairwise
from yolojax_torch.postprocess.nms import postprocess_v2
from yolojax_torch.train import step
from yolojax_torch.train.losses import YoloV2LossConfig

from .e2e.test_overfit import ANCHORS as OVERFIT_ANCHORS
from .e2e.test_overfit import _synthetic_set
from .test_torch_layers import random_jax_weights

# f32 on both sides, sums in other orders (XLA vs oneDNN). Measured: the
# train-mode head and the new BN statistics agree to ~1e-6 relative.
FORWARD_RTOL = 1e-4
BN_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= rtol * scale, (
        what, np.abs(got - want).max(), scale)


def test_train_mode_forward_and_bn_state_match_jax():
    jm = jax_get_model("yolo2", "tiny", 20)
    tm = get_model("yolo2", "tiny", 20)
    params, state = random_jax_weights(jm, 64, seed=11)
    net = params_from_jax(tm, params, state)
    x = np.random.RandomState(12).uniform(0, 1, (3, 64, 64, 3)).astype(
        np.float32)
    ref, ref_state = jax.jit(lambda p, s, im: apply_network(
        jm.specs, p, s, im, train=True, compute_dtype=jnp.float32))(
        params, state, jnp.asarray(x))
    with torch.no_grad():
        got, new_state = net(torch.from_numpy(x),
                             compute_dtype=torch.float32, train=True)
    close(got, ref, FORWARD_RTOL, "train-mode output")
    assert sorted(new_state) == sorted(ref_state)
    for name, (mean, var) in new_state.items():
        close(mean, ref_state[name]["mean"], BN_RTOL, name + " mean")
        close(var, ref_state[name]["var"], BN_RTOL, name + " var")
    # eval mode leaves the buffers alone; load_bn_state stores the new ones
    before = net.conv_0.mean.clone()
    with torch.no_grad():
        net(torch.from_numpy(x), compute_dtype=torch.float32)
    assert torch.equal(net.conv_0.mean, before)
    net.load_bn_state(new_state)
    assert torch.equal(net.conv_0.mean, new_state["conv_0"][0])


def test_dropout_keeps_and_scales_like_jax():
    """v1's dropout: keep with probability 1 - rate from the generator,
    scale the kept units by 1 / (1 - rate); the masks are not JAX's bits."""
    tm = get_model("yolo", "tiny", 20)
    net = tm.init(torch.Generator().manual_seed(0), 64)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a = tm.apply(net, x, compute_dtype=torch.float32, train=True,
                     generator=torch.Generator().manual_seed(5))[0]
        b = tm.apply(net, x, compute_dtype=torch.float32, train=True,
                     generator=torch.Generator().manual_seed(5))[0]
        c = tm.apply(net, x, compute_dtype=torch.float32, train=True,
                     generator=torch.Generator().manual_seed(6))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="generator"):
        tm.apply(net, x, compute_dtype=torch.float32, train=True)
    drop = Network((DropoutSpec(0.25),), {})
    y, _ = drop(torch.ones((200, 100)), compute_dtype=torch.float32,
                train=True, generator=torch.Generator().manual_seed(2))
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((y > 0).float().mean()) - 0.75) < 0.01


def test_schedules_match_optax():
    cfg = load_config(["config.ini"]).optimizer
    cases = [
        (cfg, 2001),  # config.ini: warmup 1000, steps at 60000/80000
        (step.OptimizerConfig(learning_rate=1.0, warmup_steps=4,
                              schedule="steps", boundaries=(6, 8)), 13),
        (step.OptimizerConfig(learning_rate=0.1, warmup_steps=10,
                              warmup_power=4.0, schedule="exponential",
                              decay_steps=50, decay_rate=0.3), 300),
        (step.OptimizerConfig(learning_rate=0.1, warmup_steps=5,
                              schedule="cosine", decay_steps=100), 300),
        (step.OptimizerConfig(learning_rate=0.1, schedule="constant"), 20),
    ]
    for c, n in cases:
        jc = jax_step.OptimizerConfig(**c.__dict__)
        want = np.asarray(jax.jit(jax.vmap(jax_step.make_schedule(jc)))(
            jnp.arange(n)))
        got = np.asarray([step.make_schedule(c)(k) for k in range(n)])
        # optax evaluates in f32: near a cosine's zero only the absolute
        # error stays small
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-7 * c.learning_rate,
                                   err_msg=str(c))
    # the joined schedule restarts the count after warmup (optax)
    lr = step.make_schedule(cases[1][0])
    np.testing.assert_allclose(
        [lr(k) for k in range(13)],
        [0, .25, .5, .75, 1, 1, 1, 1, 1, 1, .1, .1, .01], rtol=1e-12)
    assert step.make_schedule(cfg)(0) == 0.0


def test_multiscale_schedule_matches_jax():
    for dims, every, seed in (((320, 352, 384), 10, 1),
                              (tuple(range(320, 609, 32)), 7, 0)):
        a = step.MultiScaleSchedule(dims, every, seed)
        b = jax_step.MultiScaleSchedule(dims, every, seed)
        assert [a.dim_at(s) for s in range(300)] == [
            b.dim_at(s) for s in range(300)]


def test_overfit_and_detect_recovers_boxes():
    """tests/e2e/test_overfit.py's gate on the port: the four-conv model
    on 8 images at 48 px, Adam 2e-3; after 300 steps (yolojax's test takes
    500) the last loss is below a tenth of the first and detection with
    eval-mode BN finds at least 6 of the 8 boxes."""
    a, num_classes = len(OVERFIT_ANCHORS), 2
    model = Model("yolo2", "overfit", "v2", (
        ConvSpec(16, 3), MaxPoolSpec(), ConvSpec(32, 3), MaxPoolSpec(),
        ConvSpec(32, 3),
        ConvSpec(a * (5 + num_classes), 1, bn=False, act="linear")),
        num_classes, 4, anchors=OVERFIT_ANCHORS)
    tx = step.make_optimizer(step.OptimizerConfig(
        optimizer="adam", learning_rate=2e-3, weight_decay=0.0))
    ts = step.init_train_state(model, tx, torch.Generator().manual_seed(0),
                               48)
    fn = step.make_train_step(model, tx, augment=False,
                              compute_dtype=torch.float32,
                              loss_cfg=YoloV2LossConfig())
    batch = tuple(torch.from_numpy(np.array(t)) for t in _synthetic_set())
    losses = []
    for _ in range(300):
        ts, m = fn(ts, batch, 1, 48)
        losses.append(float(m["total"]))
    assert losses[-1] < 0.1 * losses[0], (losses[0], losses[-1])

    images, boxes, classes, _ = batch
    with torch.no_grad():
        head = model.apply(ts.net, images, compute_dtype=torch.float32)
        out = postprocess_v2(head, model.anchors, score_thresh=0.3,
                             iou_thresh=0.45, top_k=128, use_pallas="never")
    recovered = 0
    for i in range(images.shape[0]):
        kept = torch.nonzero(out["keep"][i]).flatten()
        if len(kept) == 0:
            continue
        best = int(kept[0])  # highest score
        cx, cy, w, h = boxes[i, 0].tolist()
        gt = torch.tensor([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2])
        iou = float(iou_pairwise(out["boxes"][i, best], gt))
        if iou > 0.5 and int(out["classes"][i, best]) == int(classes[i, 0]):
            recovered += 1
    assert recovered >= 6, f"recovered {recovered}/8 boxes"
