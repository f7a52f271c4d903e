"""Training step: augment -> train-mode forward -> loss -> backward ->
update (port of ``yolojax/train/step.py``).

The optimizer is written as plain tensor code that computes what yolojax's
optax chain computes, update for update: ``torch.optim``'s RMSprop puts
``eps`` outside the square root with another decay, ``clip_grad_norm_``
adds 1e-6 to the norm, and neither knows optax's weight-decay placement,
its joined warmup schedule or ``MultiSteps``. An optimizer here is a pair
of functions over dicts of tensors keyed by parameter name, like an optax
``GradientTransformation``: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``.

Random bits: each step seeds two generators from (seed, step), one for the
augmentation draws and one for dropout, on the batch's device; they are
not JAX's bits (``jax.random.fold_in``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from yolojax_torch.data.augment import AugmentConfig, augment_batch, resize
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network
from yolojax_torch.parallel.mesh import mesh_rows
from yolojax_torch.train.losses import (
    YoloV1LossConfig,
    YoloV2LossConfig,
    yolo_v1_loss,
    yolo_v2_loss,
)
from yolojax_torch.utils.profiling import span

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """The ``[optimizer]`` keys (also accepted in ``[train]``)."""

    optimizer: str = "momentum"  # adam | momentum | rmsprop | sgd | adamw
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    grad_clip_norm: float = 0.0  # 0 disables
    schedule: str = "constant"  # constant | exponential | cosine | steps
    decay_steps: int = 100_000
    decay_rate: float = 0.1
    warmup_steps: int = 0
    warmup_power: float = 1.0  # lr * (step/warmup)^power; 4 = Darknet burn_in
    boundaries: Tuple[int, ...] = ()  # "steps": scale lr by gamma at each
    gamma: float = 0.1
    ema_decay: float = 0.0  # Polyak-averaged eval weights; 0 disables
    grad_accum: int = 1  # average k mini-step gradients per update


def make_schedule(cfg: OptimizerConfig) -> Callable[[int], float]:
    """count -> learning rate, as yolojax's optax schedule. With warmup,
    ``optax.join_schedules`` restarts the base schedule's count at the
    warmup boundary, so a "steps" boundary b takes effect at count
    warmup + b."""
    base = cfg.learning_rate
    if cfg.schedule == "constant":
        def sched(count):
            return base
    elif cfg.schedule == "exponential":
        def sched(count):
            return base * cfg.decay_rate ** (count / cfg.decay_steps)
    elif cfg.schedule == "cosine":
        def sched(count):
            frac = min(count, cfg.decay_steps) / cfg.decay_steps
            return base * 0.5 * (1 + math.cos(math.pi * frac))
    elif cfg.schedule == "steps":
        bounds = sorted({int(b) for b in cfg.boundaries})

        def sched(count):
            return base * cfg.gamma ** sum(count >= b for b in bounds)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps <= 0:
        return sched
    n, power = float(cfg.warmup_steps), cfg.warmup_power

    def joined(count):
        if count < cfg.warmup_steps:
            return base * min(max(count / n, 0.0), 1.0) ** power
        return sched(count - cfg.warmup_steps)

    return joined


def decay_mask(params: Tensors) -> Dict[str, bool]:
    """Weight decay applies to conv/dense kernels only (ndim > 1), never to
    BN scale/bias or biases."""
    return {k: p.ndim > 1 for k, p in params.items()}


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root that XLA computes: torch's
    CPU ``sqrt`` is not always, a float64 root rounded to f32 is."""
    return torch.sqrt(x.double()).float()


def global_norm(tree: Tensors) -> torch.Tensor:
    return sqrt_rn(sum(torch.sum(torch.square(t.float()))
                       for t in tree.values()))


def _bias_corrections(decays, count: int, device):
    """Adam's ``1 - b^count`` for each decay, formed in f32 as optax forms
    it (``b`` rounds to f32 before the power; numpy's f32 power is the
    ``powf`` XLA's CPU backend calls), each as a 0-d tensor on ``device``:
    CUDA divides by a host scalar as a multiply by its reciprocal, and by a
    device tensor exactly, as XLA does."""
    return [torch.tensor(np.float32(1) - np.float32(b) ** np.float32(count),
                         device=device) for b in decays]


def _zeros(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


class Optimizer:
    """yolojax's ``make_optimizer`` chain: [clip_by_global_norm] ->
    [add_decayed_weights (momentum, sgd, rmsprop)] -> the optimizer ->
    [EMA of the post-step params], inside ``MultiSteps`` when
    ``grad_accum > 1``. The state is a flat dict: ``count`` (updates
    applied, the schedule's count), ``trace`` (momentum; rmsprop's
    momentum), ``mu``/``nu`` (adam/adamw; ``nu`` for rmsprop),
    ``ema_params``, and with accumulation ``mini_step``,
    ``gradient_step`` and ``acc_grads``."""

    def __init__(self, cfg: OptimizerConfig):
        name = cfg.optimizer.lower()
        if name not in ("adam", "adamw", "momentum", "sgd", "rmsprop"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.ema_decay > 0 and not 0.0 < cfg.ema_decay < 1.0:
            raise ValueError(
                f"ema_decay must be in (0,1), got {cfg.ema_decay}")
        self.cfg, self.name, self.schedule = cfg, name, make_schedule(cfg)

    def init(self, params: Tensors) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        if self.name in ("momentum", "rmsprop"):
            state["trace"] = _zeros(params)
        if self.name in ("adam", "adamw"):
            state["mu"] = _zeros(params)
        if self.name in ("adam", "adamw", "rmsprop"):
            state["nu"] = _zeros(params)
        if self.cfg.ema_decay > 0:
            state["ema_params"] = {k: p.detach().float().clone()
                                   for k, p in params.items()}
        if self.cfg.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0,
                         acc_grads=_zeros(params))
        return state

    def update(self, grads: Tensors, state: Dict[str, Any],
               params: Tensors, norm: Optional[Callable] = None
               ) -> Tuple[Tensors, Dict[str, Any]]:
        """-> (updates to add to the params, new state). Pure: the inputs
        are not changed. ``norm`` takes the clip's global norm of a
        gradient tree (default :func:`global_norm`; a sharded state passes
        one that sums over the ranks' pieces)."""
        k = self.cfg.grad_accum
        if k <= 1:
            return self._inner(grads, state, params, norm)
        n_acc = state["mini_step"]
        acc = {name: a + (grads[name] - a) / (n_acc + 1)
               for name, a in state["acc_grads"].items()}
        if n_acc < k - 1:  # accumulate only: zero updates, inner state kept
            return ({name: torch.zeros_like(a) for name, a in acc.items()},
                    dict(state, mini_step=n_acc + 1, acc_grads=acc))
        updates, new = self._inner(acc, state, params, norm)
        new.update(mini_step=0, gradient_step=state["gradient_step"] + 1,
                   acc_grads={name: torch.zeros_like(a)
                              for name, a in acc.items()})
        return updates, new

    def _inner(self, grads: Tensors, state: Dict[str, Any],
               params: Tensors, norm: Optional[Callable] = None
               ) -> Tuple[Tensors, Dict[str, Any]]:
        cfg, name = self.cfg, self.name
        new = dict(state)
        count = state["count"]
        mask = decay_mask(params)
        u = dict(grads)
        if cfg.grad_clip_norm > 0:
            g_norm = (norm or global_norm)(u)
            keep = g_norm < cfg.grad_clip_norm
            u = {key: torch.where(keep, t, (t / g_norm) * cfg.grad_clip_norm)
                 for key, t in u.items()}
        if cfg.weight_decay > 0 and name in ("momentum", "sgd", "rmsprop"):
            u = {key: t + cfg.weight_decay * params[key] if mask[key] else t
                 for key, t in u.items()}
        neg_lr = -self.schedule(count)
        if name == "momentum":
            u = {key: t + cfg.momentum * state["trace"][key]
                 for key, t in u.items()}
            new["trace"] = u
            u = {key: neg_lr * t for key, t in u.items()}
        elif name == "sgd":
            u = {key: neg_lr * t for key, t in u.items()}
        elif name in ("adam", "adamw"):
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu = {key: (1 - b1) * t + b1 * state["mu"][key]
                  for key, t in u.items()}
            nu = {key: (1 - b2) * t ** 2 + b2 * state["nu"][key]
                  for key, t in u.items()}
            c1, c2 = _bias_corrections((b1, b2), count + 1,
                                       next(iter(u.values())).device)
            u = {key: (mu[key] / c1) / (sqrt_rn(nu[key] / c2) + eps)
                 for key in u}
            if name == "adamw" and cfg.weight_decay > 0:
                u = {key: t + cfg.weight_decay * params[key] if mask[key]
                     else t for key, t in u.items()}
            new["mu"], new["nu"] = mu, nu
            u = {key: neg_lr * t for key, t in u.items()}
        else:  # rmsprop: eps inside the square root, decay 0.9, then trace
            nu = {key: (1 - 0.9) * t ** 2 + 0.9 * state["nu"][key]
                  for key, t in u.items()}
            u = {key: torch.rsqrt(nu[key] + 1e-8) * t for key, t in u.items()}
            u = {key: neg_lr * t for key, t in u.items()}
            u = {key: t + cfg.momentum * state["trace"][key]
                 for key, t in u.items()}
            new["nu"], new["trace"] = nu, u
        if cfg.ema_decay > 0:
            d = cfg.ema_decay
            new["ema_params"] = {
                key: d * e + (1.0 - d) * (params[key].detach() + u[key])
                for key, e in state["ema_params"].items()}
        new["count"] = count + 1
        return u, new


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)


def default_loss_cfg(model: Model):
    return YoloV2LossConfig() if model.kind == "v2" else YoloV1LossConfig()


def make_head_loss(model: Model, loss_cfg):
    """Head -> loss-terms dispatch for the model's kind."""

    def loss_from_head(head, gt_xywh, gt_class, gt_valid):
        if model.kind == "v2":
            return yolo_v2_loss(head, model.anchors, gt_xywh, gt_class,
                                gt_valid, loss_cfg)
        return yolo_v1_loss(head, model.grid, model.boxes_per_cell,
                            model.num_classes, gt_xywh, gt_class, gt_valid,
                            loss_cfg)

    return loss_from_head


def prepare_images(generator, images, gt_xywh, gt_valid, dim, aug_cfg,
                   augment: bool, rows: Optional[Tuple[int, int]] = None):
    """Augment, or only resize to ``dim``. ``images`` should already carry
    the step's compute dtype (the resample and HSV ops follow it).
    ``rows`` = (first row, global rows): the images are those rows of a
    global batch, and the draws are the global batch's."""
    if augment:
        return augment_batch(generator, images, gt_xywh, gt_valid, dim,
                             aug_cfg, rows=rows)
    if images.shape[1] != dim:
        images = resize(images, dim)
    return images, gt_xywh, gt_valid


@dataclasses.dataclass
class TrainState:
    """``step`` (mini-steps taken), the network (its parameters and, as
    buffers, the BN running statistics) and the optimizer state. On a mesh
    ``plan`` (``parallel/sharding.py::Plan``) says which pieces of them
    this rank holds; None on one device."""

    step: int
    net: Network
    opt_state: Dict[str, Any]
    plan: Optional[Any] = None

    def params(self) -> Tensors:
        return dict(self.net.named_parameters())


def init_train_state(model: Model, tx: Optimizer, generator: torch.Generator,
                     input_dim: int, device=None) -> TrainState:
    net = model.init(generator, input_dim).to(device)
    return TrainState(0, net, tx.init(dict(net.named_parameters())))


def step_seeds(seed: int, step: int) -> Tuple[int, int]:
    """The (augment, dropout) generator seeds of one step."""
    aug, drop = np.random.SeedSequence((seed, step)).generate_state(
        2, np.uint64)
    return int(aug), int(drop)


def make_train_step(
    model: Model,
    tx: Optimizer,
    *,
    loss_cfg=None,
    aug_cfg: AugmentConfig = AugmentConfig(),
    augment: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    remat: bool = False,
):
    """Build ``train_step(ts, batch, seed, dim, with_grads=False) ->
    (ts, metrics)``. ``batch`` = (canvas images, gt_xywh, gt_class,
    gt_valid) on the device; ``ts`` is updated in place (parameters and BN
    buffers) and returned with ``step + 1``. ``metrics`` holds the loss
    terms and the raw gradients' ``grad_norm`` as 0-d tensors, and with
    ``with_grads`` the gradient dict under ``grads``. ``remat`` recomputes
    the forward in the backward pass (``torch.utils.checkpoint``); the
    dropout generator is re-seeded inside it, so the recomputation draws
    the same masks.

    On a mesh (``ts.plan``) each rank steps on its rows of the global
    batch: the augmentation and dropout draws are the global batch's (from
    the same seeds), train-mode BN normalises with the global batch's
    statistics, the gradients are averaged over the data ranks, and the
    metrics are the global batch's, so the step is the one-device step on
    the global batch."""
    if loss_cfg is None:
        loss_cfg = default_loss_cfg(model)
    loss_from_head = make_head_loss(model, loss_cfg)

    def train_step(ts: TrainState, batch, seed: int, dim: int,
                   with_grads: bool = False):
        images, gt_xywh, gt_class, gt_valid = batch
        device = images.device
        plan = ts.plan
        mesh = plan.mesh if plan is not None and plan.mesh.size > 1 else None
        aug_seed, drop_seed = step_seeds(seed, ts.step)
        images, gt_xywh, gt_valid = prepare_images(
            torch.Generator(device).manual_seed(aug_seed),
            images.to(compute_dtype), gt_xywh, gt_valid, dim, aug_cfg,
            augment, rows=mesh_rows(mesh, images.shape[0]))
        net = ts.net
        params = ts.params()

        def forward(x):
            return model.apply(
                net, x, compute_dtype=compute_dtype, train=True,
                generator=torch.Generator(device).manual_seed(drop_seed),
                mesh=mesh)

        if remat:
            head, new_bn = checkpoint(forward, images, use_reentrant=False)
        else:
            head, new_bn = forward(images)
        terms = loss_from_head(head, gt_xywh, gt_class, gt_valid)
        grads = dict(zip(params, torch.autograd.grad(terms["total"],
                                                     list(params.values()))))
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in terms.items()}
            if plan is None:
                metrics["grad_norm"] = global_norm(grads)
                with span("train.update", ts.step):
                    updates, ts.opt_state = tx.update(grads, ts.opt_state,
                                                      params)
                    for k, p in params.items():
                        p.add_(updates[k])
            else:
                grads = plan.reduce_grads(grads)
                metrics = plan.mean_metrics(metrics)
                metrics["grad_norm"] = plan.norm(grads)
                with span("train.update", ts.step):
                    ts.opt_state = plan.update(tx, grads, ts.opt_state,
                                               params)
            net.load_bn_state(new_bn)
        if with_grads:
            metrics["grads"] = grads
        ts.step += 1
        return ts, metrics

    return train_step


@dataclasses.dataclass
class MultiScaleSchedule:
    """Darknet-style multi-scale input schedule: a pseudo-random but
    deterministic dim every ``every`` steps."""

    dims: Tuple[int, ...] = tuple(range(320, 609, 32))
    every: int = 10
    seed: int = 0

    def dim_at(self, step: int) -> int:
        period = step // self.every
        h = (period * 2654435761 + self.seed) & 0xFFFFFFFF
        return self.dims[h % len(self.dims)]
