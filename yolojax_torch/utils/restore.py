"""Weight loading for the inference CLIs (port of
``yolojax/utils/restore.py``).

Sources: the ``.npz`` store (``convert/store.py``), and a training
checkpoint directory (a logdir holding ``ckpt/``, or the ``ckpt`` directory
itself; ``train/checkpoint.py``), whose latest step's params and BN state
load, or with ``use_ema`` its EMA weights. Darknet ``.weights`` and TF1
checkpoints raise :class:`NotImplementedError` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

import logging
import os

from yolojax_torch.convert.interchange import network_from_state_dict
from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network

log = logging.getLogger(__name__)


def load_weights(path: str, model: Model, *, use_ema: bool = False
                 ) -> Network:
    """Return a CPU :class:`Network` for ``model`` from ``path``.
    ``use_ema`` takes a checkpoint's Polyak-averaged weights (``[train]
    ema_decay``); weight files carry none, so it is refused for them."""
    if use_ema and not os.path.isdir(path):
        raise ValueError(
            f"use_ema needs a checkpoint dir (got {path!r}): only "
            "training checkpoints carry the averaged weights")
    if path.endswith(".npz"):
        log.info("loading npz params: %s", path)
        return load_network_npz(path, model)
    if path.endswith(".weights"):
        raise NotImplementedError(
            "Darknet .weights import is not ported yet (ROADMAP queue 1, "
            "converters); convert to .npz with the yolojax package")
    if os.path.isdir(path):
        from yolojax_torch.train.checkpoint import Checkpointer

        ckpt_dir = path
        if os.path.isdir(os.path.join(path, "ckpt")):
            ckpt_dir = os.path.join(path, "ckpt")
        step, raw = Checkpointer(ckpt_dir).restore_latest_raw()
        if raw is None:
            raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}")
        log.info("loading checkpoint step %s from %s", step, ckpt_dir)
        params = raw["params"]
        if use_ema:
            params = raw["opt_state"].get("ema_params")
            if params is None:
                raise ValueError(
                    f"checkpoint {ckpt_dir} (step {step}) has no EMA "
                    "weights: train with [train] ema_decay > 0 first")
            log.info("using EMA (Polyak-averaged) weights")
        return network_from_state_dict(model, {**params, **raw["bn_state"]})
    if os.path.exists(path + ".index") or ".ckpt" in os.path.basename(path):
        raise NotImplementedError(
            "TF1 checkpoint import is not ported yet (ROADMAP queue 1, "
            "converters)")
    raise ValueError(f"unrecognized weights source: {path}")
