"""Weight loading for the inference CLIs (port of
``yolojax/utils/restore.py``).

Sources, tried in yolojax's order: the ``.npz`` store
(``convert/store.py``), a Darknet ``.weights`` file (``convert/darknet.py``),
a training checkpoint directory (a logdir holding ``ckpt/``, or the
``ckpt`` directory itself; ``train/checkpoint.py``), whose latest step's
params and BN state load, or with ``use_ema`` its EMA weights, and a TF1
checkpoint prefix (``convert/tf1.py``; needs ``tensorflow``). yolojax's
Orbax checkpoints do not load here: a directory of them is refused with the
route through an ``.npz``.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from yolojax_torch.convert.interchange import network_from_state_dict
from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network

log = logging.getLogger(__name__)

# files Orbax writes into each step directory
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "commit_success.txt")


def _is_orbax_dir(ckpt_dir: str) -> bool:
    """Numeric step directories with Orbax's metadata files in them."""
    for name in os.listdir(ckpt_dir):
        step_dir = os.path.join(ckpt_dir, name)
        if name.isdigit() and os.path.isdir(step_dir) and any(
                os.path.exists(os.path.join(step_dir, m))
                for m in _ORBAX_MARKERS):
            return True
    return False


def load_weights(path: str, model: Model, input_dim: Optional[int] = None,
                 *, use_ema: bool = False) -> Network:
    """Return a CPU :class:`Network` for ``model`` from ``path``.
    ``input_dim`` sizes a v1 model's flatten for ``.weights`` and TF1
    sources (448 for v1, 416 for v2 when None). ``use_ema`` takes a
    checkpoint's Polyak-averaged weights (``[train] ema_decay``); weight
    files carry none, so it is refused for them."""
    if use_ema and not os.path.isdir(path):
        raise ValueError(
            f"use_ema needs a checkpoint dir (got {path!r}): only "
            "training checkpoints carry the averaged weights")
    if path.endswith(".npz"):
        log.info("loading npz params: %s", path)
        return load_network_npz(path, model)
    if path.endswith(".weights"):
        from yolojax_torch.convert.darknet import load_darknet_weights

        log.info("loading darknet weights: %s", path)
        return load_darknet_weights(model, path, input_dim=input_dim)
    if os.path.isdir(path):
        from yolojax_torch.train.checkpoint import Checkpointer

        ckpt_dir = path
        if os.path.isdir(os.path.join(path, "ckpt")):
            ckpt_dir = os.path.join(path, "ckpt")
        step, raw = Checkpointer(ckpt_dir).restore_latest_raw()
        if raw is None:
            if _is_orbax_dir(ckpt_dir):
                raise ValueError(
                    f"{ckpt_dir} holds yolojax (Orbax) checkpoints, which "
                    "the port does not read: write an .npz with the "
                    "yolojax package (yolojax.convert.store."
                    "save_params_npz of the restored params and "
                    "bn_state), then pass that file as --weights")
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
        from yolojax_torch.convert.tf1 import load_tf1_checkpoint

        log.info("loading TF1 checkpoint: %s", path)
        return load_tf1_checkpoint(model, path, input_dim=input_dim)
    raise ValueError(f"unrecognized weights source: {path}")
