"""Five steps of the port's ``make_train_step`` against yolojax's on the
CPU in f32, for every optimizer variant (momentum with decay, warmup and a
"steps" schedule; sgd; adam; adamw; rmsprop with clipping; EMA; gradient
accumulation; remat), resumed from a yolojax train state carried over by
``train_state_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolojax.train import step as jax_step
from yolojax_torch.convert.interchange import (
    _collect,
    tensors_to_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import ConvSpec, MaxPoolSpec
from yolojax_torch.train import step

from .pipeline.test_train_step import _batch
from .pipeline.test_train_step import micro_model as jax_micro_model

# f32 on both sides, sums in other orders (XLA vs oneDNN). Measured: the
# losses agree to ~1e-6 relative, params after five steps to ~1e-7 of
# their largest value. State trees (params, gradients, optimizer buffers)
# are held to a fraction of their largest value over the whole tree: a BN
# bias gradient is a sum whose f32 terms can cancel to ~1e-3 of their size,
# so its own largest value is no fair scale.
LOSS_RTOL = 1e-5
BN_RTOL = 1e-5
STATE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def micro_model(num_classes=3):
    jm = jax_micro_model(num_classes)
    specs = (ConvSpec(8, 3), MaxPoolSpec(), ConvSpec(16, 3), MaxPoolSpec(),
             ConvSpec(len(jm.anchors) * (5 + num_classes), 1, bn=False,
                      act="linear"))
    return Model("yolo2", "micro", "v2", specs, num_classes, 4,
                 anchors=jm.anchors)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield np.asarray(tree, np.float64)


def close_trees(got, want, rtol, what=""):
    """Every leaf within ``rtol`` of the largest |value| in ``want``."""
    scale = max(max(np.abs(v).max() for v in _leaves(want)), 1e-6)

    def walk(g, w, path):
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), path
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
            return
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= rtol * scale, (
            path, np.abs(g - w).max(), scale)

    walk(got, want, what)


VARIANTS = {
    "momentum_decay_warmup_steps": (dict(
        optimizer="momentum", learning_rate=2e-2, weight_decay=5e-4,
        warmup_steps=2, warmup_power=2.0, schedule="steps",
        boundaries=(1, 3), gamma=0.5), False),
    "sgd": (dict(optimizer="sgd", learning_rate=2e-2, weight_decay=0.0),
            False),
    "adam": (dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.0),
             False),
    "adamw": (dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1),
              False),
    "rmsprop_clip": (dict(optimizer="rmsprop", learning_rate=1e-3,
                          grad_clip_norm=1.0), False),
    "ema_decay": (dict(optimizer="momentum", learning_rate=1e-2,
                       ema_decay=0.9), False),
    "grad_accum_2": (dict(optimizer="momentum", learning_rate=1e-2,
                          grad_accum=2, ema_decay=0.9), False),
    "remat": (dict(optimizer="momentum", learning_rate=1e-2), True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_five_steps_match_jax(variant):
    """One yolojax step (so every optimizer buffer is non-zero), carry the
    state over with ``train_state_from_jax``, then five steps on both
    sides on the same batches: every loss term and the grad norm each
    step, the first step's gradients, and then every parameter, BN
    statistic, optimizer buffer and count."""
    kw, remat = VARIANTS[variant]
    jm, tm = jax_micro_model(), micro_model()
    jtx = jax_step.make_optimizer(jax_step.OptimizerConfig(**kw))
    ttx = step.make_optimizer(step.OptimizerConfig(**kw))
    jts = jax_step.init_train_state(jm, jtx, jax.random.PRNGKey(0), 32)
    jfn = jax_step.make_train_step(jm, jtx, augment=False,
                                   compute_dtype=jnp.float32, remat=remat)
    tfn = step.make_train_step(tm, ttx, augment=False,
                               compute_dtype=torch.float32, remat=remat)
    rng = jax.random.PRNGKey(1)
    jts, _ = jfn(jts, _batch(seed=0), rng, dim=32)
    tts = train_state_from_jax(tm, jts, ttx)
    assert tts.step == 1
    for i in range(1, 6):
        batch = _batch(seed=i)
        tbatch = tuple(torch.from_numpy(np.array(a)) for a in batch)
        grads = i == 1 and variant == "sgd"
        jts, jm_ = jfn(jts, batch, rng, dim=32, with_grads=grads)
        tts, tm_ = tfn(tts, tbatch, 1, 32, with_grads=grads)
        if grads:
            close_trees(tensors_to_jax(tm, tm_.pop("grads")),
                        jax.device_get(jm_.pop("grads")), STATE_RTOL,
                        "grads")
        assert set(tm_) == set(jm_)
        for k in jm_:
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    got = train_state_to_jax(tm, tts)
    want = jax.device_get(jts)
    assert got["step"] == int(want.step) == 6
    close_trees(got["params"], want.params, STATE_RTOL, "params")
    close_trees(got["bn_state"], want.bn_state, BN_RTOL, "bn_state")
    found = {}
    _collect(want.opt_state, found)
    for key, value in got["opt_state"].items():
        if isinstance(value, dict):
            close_trees(value, found[key], STATE_RTOL, key)
        else:
            assert value == int(found[key]), key
