"""Checkpoint / resume in step directories (port of
``yolojax/train/checkpoint.py``, which uses Orbax).

Layout: ``<dir>/<step>/state.pt``, one ``torch.save`` of
``{"step", "params", "bn_state", "opt_state"}`` with tensors on the CPU;
``params`` and the EMA copy are keyed by the network's parameter names
(``conv_0.w``, ...) and ``bn_state`` by its buffer names (``conv_0.mean``).
A checkpoint is written into a hidden temporary directory and renamed into
place with ``os.replace``, so a directory that a crash left half-written is
never taken as the latest. The format is the port's own; ``.npz``
(``convert/store.py``) carries weights between the two packages.

``should_save`` follows Orbax's ``CheckpointManager``: a step saves when it
is past the latest checkpoint and is a multiple of ``save_interval_steps``,
or when no checkpoint exists yet; the newest ``max_to_keep`` are kept.

In a multi-process run every rank makes a Checkpointer with ``primary``
(True on rank 0 only) and calls ``save`` at the same steps: a train state
split over ranks (``TrainState.plan``) is gathered to its full layout, a
collective every rank enters, and only the primary writes. Such a
Checkpointer reads the disk once, when it is made, and then keeps the
latest step itself, so every rank decides ``should_save`` alike while the
primary writes. A restore loads the full state and cuts it into the run's
mesh, whatever mesh wrote it.
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from yolojax_torch.convert.interchange import bn_buffers

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to(tree: Any, device) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def _tree(ts) -> Dict[str, Any]:
    """A :class:`~yolojax_torch.train.step.TrainState` as the nested dict
    a checkpoint holds, on the state's device (gathered from every rank's
    pieces when the state is split)."""
    if ts.plan is not None and ts.plan.sharded:
        return ts.plan.gather(ts)
    return {"step": int(ts.step), "params": dict(ts.net.named_parameters()),
            "bn_state": bn_buffers(ts.net), "opt_state": ts.opt_state}


def _layout(tree: Any) -> Any:
    """Keys and shapes of a nested dict (ints and floats as their type)."""
    if isinstance(tree, dict):
        return {k: _layout(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    return type(tree).__name__


class Checkpointer:
    def __init__(self, directory: str, *, max_to_keep: Optional[int] = 5,
                 save_interval_steps: int = 1,
                 primary: Optional[bool] = None):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.primary = primary  # None: one process; else rank 0 or not
        self._latest = self._scan_latest()

    def steps(self):
        """Sorted steps of the complete checkpoints."""
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self._dir, name, STATE_FILE)))

    def _scan_latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def latest_step(self) -> Optional[int]:
        if self.primary is None:
            return self._scan_latest()
        return self._latest

    def should_save(self, step: int) -> bool:
        """True iff ``save(step)`` would write."""
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, train_state, *, force: bool = False) -> bool:
        """Write ``train_state`` as ``step``; returns whether it wrote."""
        step = int(step)
        if not force and not self.should_save(step):
            return False
        payload = _tree(train_state)
        self._latest = step
        if self.primary is False:
            return True
        final = os.path.join(self._dir, str(step))
        if os.path.exists(final):
            raise ValueError(f"checkpoint step {step} already exists in "
                             f"{self._dir}")
        payload = _to(payload, "cpu")
        tmp = os.path.join(self._dir, f".{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        os.replace(tmp, final)
        log.info("saved checkpoint step=%d -> %s", step, self._dir)
        if self.max_to_keep:
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)))
        return True

    def restore_latest_raw(self) -> Tuple[Optional[int], Optional[dict]]:
        """(step, payload dict) of the newest checkpoint, or (None, None).
        Used by detect/eval, which need only params and bn_state."""
        step = self.latest_step()
        if step is None:
            return None, None
        payload = torch.load(os.path.join(self._dir, str(step), STATE_FILE),
                             map_location="cpu", weights_only=True)
        return step, payload

    def restore_latest(self, template) -> Tuple[Optional[int], Any]:
        """Load the newest checkpoint into ``template`` (a TrainState whose
        network and optimizer state give the layout and the device).
        Returns (step, state), or (None, template) when there is none."""
        step, payload = self.restore_latest_raw()
        if step is None:
            return None, template
        plan = template.plan
        want = (plan.full_shapes(template) if plan is not None
                else _layout(_tree(template)))
        if _layout(payload) != want:
            # the usual cause: train.ema_decay or train.grad_accum changed,
            # which adds or removes optimizer-state entries
            raise RuntimeError(
                f"failed to restore checkpoint step {step} from {self._dir} "
                f"into the current train-state layout. If optimizer flags "
                f"changed since this logdir was created (train.ema_decay / "
                f"train.grad_accum add or remove optimizer-state entries), "
                f"resume with the original flags or start a fresh logdir. "
                f"Saved optimizer state: {sorted(payload['opt_state'])}; "
                f"current: {sorted(want['opt_state'])}")
        if plan is not None:
            plan.load(template, payload)
            log.info("restored checkpoint step=%d from %s", step, self._dir)
            return step, template
        net = template.net
        device = next(net.parameters()).device
        net.load_state_dict({**payload["params"], **payload["bn_state"]},
                            strict=True)
        template.step = payload["step"]
        template.opt_state = _to(payload["opt_state"], device)
        log.info("restored checkpoint step=%d from %s", step, self._dir)
        return step, template
