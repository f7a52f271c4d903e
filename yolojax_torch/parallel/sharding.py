"""A train state laid out over a mesh: tensor-parallel weights, ZeRO-1
optimizer buffers, and the step's reductions.

yolojax places a ``TrainState`` with ``param_shardings`` and
``opt_state_shardings`` and lets GSPMD derive the collectives
(``cli/train.py:128-150``). Here a :class:`Plan` does the same by hand:

* :meth:`Plan.shard` cuts a full train state (every rank made the same one
  from the same seed) into this rank's pieces: the wide convs' channels
  (and their BN parameters and running statistics) over the model ranks,
  and with ZeRO-1 every per-parameter optimizer buffer over the data ranks;
* :meth:`Plan.reduce_grads` averages the gradients over the data ranks in
  one flat all-reduce, and :meth:`Plan.norm` takes the global norm of a
  tree whose leaves are split, from all-reduced partial sums of squares;
* :meth:`Plan.update` runs the optimizer, on the ZeRO shards with ZeRO-1
  (each rank updates its shard of every buffer and parameter, then the
  parameters are all-gathered);
* :meth:`Plan.gather` rebuilds the full train state (a collective every
  rank enters: checkpoints keep yolojax's full layout) and :meth:`Plan.load`
  cuts a full one into whatever mesh the run has.

On a one-rank mesh none of these communicates, and the step takes the
one-device code unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from yolojax_torch.convert.interchange import bn_buffers
from yolojax_torch.parallel import collectives
from yolojax_torch.parallel.mesh import Mesh, tp_dim, zero_dims

Tensors = Dict[str, torch.Tensor]


def _block(t: torch.Tensor, dim: Optional[int], parts: int,
           index: int) -> torch.Tensor:
    if dim is None or parts == 1:
        return t
    return t.chunk(parts, dim=dim)[index].contiguous()


class Plan:
    """How this rank holds a train state on ``mesh``."""

    def __init__(self, mesh: Mesh, *, zero: bool = False,
                 tp_threshold: int = 1024):
        self.mesh = mesh
        self.zero = bool(zero) and mesh.data > 1
        self.tp_threshold = tp_threshold
        self.tp: Dict[str, Optional[int]] = {}   # param / BN buffer -> dim
        self.zdims: Dict[str, Tuple] = {}        # param -> (model, data) dim

    @property
    def sharded(self) -> bool:
        """Whether some leaf is split over ranks (saves then gather)."""
        return self.mesh.model > 1 or self.zero

    # -- layout --------------------------------------------------------------
    def _model_piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return _block(t, self.tp.get(name), self.mesh.model,
                      self.mesh.model_index)

    def _data_piece(self, name: str, t: torch.Tensor) -> torch.Tensor:
        d = self.zdims[name][1] if self.zero else None
        return _block(t, d, self.mesh.data, self.mesh.data_index)

    def _set_net(self, net: nn.Module, tensors: Tensors) -> None:
        for full, t in tensors.items():
            mod_name, attr = full.rsplit(".", 1)
            mod = net.get_submodule(mod_name)
            if attr in mod._parameters:
                setattr(mod, attr, nn.Parameter(t))
            else:
                setattr(mod, attr, t)

    def _piece_opt_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        return {key: ({k: self._data_piece(k, self._model_piece(k, v))
                       for k, v in value.items()}
                      if isinstance(value, dict) else value)
                for key, value in state.items()}

    def shard(self, ts) -> None:
        """Cut the full train state ``ts`` into this rank's pieces, in
        place, and bind the plan to it."""
        mesh, thr = self.mesh, self.tp_threshold
        sd = {**dict(ts.net.named_parameters()), **bn_buffers(ts.net)}
        self.tp = {k: tp_dim(tuple(v.shape), mesh.model, thr)
                   for k, v in sd.items()}
        self.zdims = {k: zero_dims(tuple(p.shape), mesh.data, mesh.model, thr)
                      for k, p in ts.net.named_parameters()}
        if mesh.model > 1:
            with torch.no_grad():
                self._set_net(ts.net, {
                    k: self._model_piece(k, v.detach()).clone()
                    for k, v in sd.items() if self.tp[k] is not None})
        ts.opt_state = self._piece_opt_state(ts.opt_state)
        ts.plan = self

    def load(self, ts, payload: Dict[str, Any]) -> None:
        """Load a full checkpoint payload's pieces into ``ts``."""
        device = next(ts.net.parameters()).device
        with torch.no_grad():
            for k, v in {**payload["params"], **payload["bn_state"]}.items():
                dst = ts.net.get_parameter(k) if k in self.zdims else \
                    ts.net.get_buffer(k)
                dst.copy_(self._model_piece(k, v))
        ts.step = payload["step"]
        ts.opt_state = {key: ({k: v.to(device) for k, v in value.items()}
                              if isinstance(value, dict) else value)
                        for key, value in self._piece_opt_state(
                            payload["opt_state"]).items()}

    def full_shapes(self, ts) -> Dict[str, Any]:
        """The checkpoint layout of ``ts``'s full state (no collective)."""

        def full(name, t, opt):
            shape = list(t.shape)
            m_dim = self.tp.get(name)
            if m_dim is not None and self.mesh.model > 1:
                shape[m_dim] *= self.mesh.model
            if opt and self.zero and self.zdims[name][1] is not None:
                shape[self.zdims[name][1]] *= self.mesh.data
            return tuple(shape)

        return {
            "step": "int",
            "params": {k: full(k, p, False)
                       for k, p in ts.net.named_parameters()},
            "bn_state": {k: full(k, b, False)
                         for k, b in bn_buffers(ts.net).items()},
            "opt_state": {key: ({k: full(k, v, True) for k, v in value.items()}
                                if isinstance(value, dict)
                                else type(value).__name__)
                          for key, value in ts.opt_state.items()},
        }

    def gather(self, ts) -> Dict[str, Any]:
        """The full train state as a checkpoint holds it. A collective:
        every rank of the mesh must call it."""
        mesh = self.mesh
        net = self.full_state_dict(ts)
        opt = {}
        for key, value in ts.opt_state.items():
            if not isinstance(value, dict):
                opt[key] = value
                continue
            value = dict(value)
            if self.zero:
                names = [k for k in value if self.zdims[k][1] is not None]
                got = collectives.flat_gather(
                    [value[k] for k in names],
                    [self.zdims[k][1] for k in names], mesh.data_group,
                    mesh.data)
                value.update(zip(names, got))
            value.update(self._gather_model(value))
            opt[key] = value
        params = {k: net[k] for k, _ in ts.net.named_parameters()}
        return {"step": int(ts.step), "params": params,
                "bn_state": {k: net[k] for k in bn_buffers(ts.net)},
                "opt_state": opt}

    def _gather_model(self, tensors: Tensors) -> Tensors:
        if self.mesh.model == 1:
            return {}
        names = [k for k in tensors if self.tp.get(k) is not None]
        got = collectives.flat_gather([tensors[k] for k in names],
                                      [self.tp[k] for k in names],
                                      self.mesh.model_group, self.mesh.model)
        return dict(zip(names, got))

    def full_tree(self, tree: Tensors) -> Tensors:
        """A params-shaped tree of model pieces (gradients, say) at full
        size; a collective when the weights are split over model ranks."""
        return {**tree, **self._gather_model(tree)}

    def full_state_dict(self, ts) -> Tensors:
        """Every parameter and BN buffer at full size (a collective when
        the weights are split over model ranks)."""
        net = {**{k: v.detach() for k, v in ts.net.named_parameters()},
               **bn_buffers(ts.net)}
        net.update(self._gather_model(net))
        return net

    # -- the step ------------------------------------------------------------
    def reduce_grads(self, grads: Tensors) -> Tensors:
        """The data ranks' mean of each gradient (one flat all-reduce)."""
        if self.mesh.data == 1:
            return grads
        summed = collectives.flat_all_reduce(list(grads.values()),
                                             self.mesh.data_group)
        return {k: s / self.mesh.data for k, s in zip(grads, summed)}

    def mean_metrics(self, metrics: Tensors) -> Tensors:
        """Loss terms averaged over the data ranks (each is a mean over
        this rank's rows, and the ranks hold as many rows each)."""
        if self.mesh.data == 1:
            return metrics
        keys = list(metrics)
        summed = collectives.flat_all_reduce(
            [metrics[k].reshape(1) for k in keys], self.mesh.data_group)
        return {k: (s / self.mesh.data).reshape(()) for k, s in
                zip(keys, summed)}

    def norm(self, tree: Tensors, *, zero: bool = False) -> torch.Tensor:
        """The global norm of a params-shaped tree whose leaves are this
        rank's pieces: the model pieces (and, with ``zero``, the data
        pieces) contribute partial sums of squares, all-reduced."""
        from yolojax_torch.train.step import global_norm, sqrt_rn

        zero = zero and self.zero
        if self.mesh.model == 1 and not zero:
            return global_norm(tree)
        parts = [0.0, 0.0, 0.0, 0.0]  # whole, model, data, both
        for k, t in tree.items():
            s = torch.sum(torch.square(t.float()))
            m = self.mesh.model > 1 and self.tp.get(k) is not None
            d = zero and self.zdims[k][1] is not None
            parts[m + 2 * d] = parts[m + 2 * d] + s
        dev = next(iter(tree.values())).device
        parts = [torch.as_tensor(p, dtype=torch.float32, device=dev)
                 for p in parts]
        if zero:
            parts[2], parts[3] = collectives.flat_all_reduce(
                [parts[2], parts[3]], self.mesh.data_group)
        if self.mesh.model > 1:
            parts[1], parts[3] = collectives.flat_all_reduce(
                [parts[1], parts[3]], self.mesh.model_group)
        return sqrt_rn(parts[0] + parts[1] + parts[2] + parts[3])

    def update(self, tx, grads: Tensors, state: Dict[str, Any],
               params: Tensors) -> Dict[str, Any]:
        """One optimizer update of ``params`` (in place); returns the new
        optimizer state. With ZeRO-1 each rank updates its data piece of
        every split parameter and buffer, then the parameters are
        all-gathered over the data ranks (one collective)."""
        if not self.zero:
            updates, state = tx.update(grads, state, params, norm=self.norm)
            for k, p in params.items():
                p.add_(updates[k])
            return state
        gs = {k: self._data_piece(k, g) for k, g in grads.items()}
        ps = {k: self._data_piece(k, p.detach()) for k, p in params.items()}
        updates, state = tx.update(
            gs, state, ps, norm=lambda t: self.norm(t, zero=True))
        split = [k for k in params if self.zdims[k][1] is not None]
        got = collectives.flat_gather(
            [ps[k] + updates[k] for k in split],
            [self.zdims[k][1] for k in split], self.mesh.data_group,
            self.mesh.data)
        full = dict(zip(split, got))
        for k, p in params.items():
            if k in full:
                p.copy_(full[k])
            else:
                p.add_(updates[k])
        return state
