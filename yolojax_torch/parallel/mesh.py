"""The device mesh over processes, and the sharding rules.

Port of ``yolojax/parallel/mesh.py``. yolojax builds a ``jax.sharding.Mesh``
over ``("data", "model")`` from the devices of one process; the port runs
one process per device, so its mesh is a ``(data, model)`` grid over the
ranks of the default process group, rank ``r`` at ``(r // model, r %
model)``, with one process group for each row and column:

* ``data_group``: the ranks that share this rank's model index (they hold
  the same parameter shards and split the batch);
* ``model_group``: the ranks that share this rank's data index (they see
  the same rows and split the wide convs' output channels).

Rules, the same as yolojax's on the port's layouts (conv kernels OIHW, dense
kernels (out, in); yolojax's are HWIO and (in, out)):

* tensor parallelism: a conv kernel with ``tp_threshold`` output channels
  or more, divisible by ``model``, and any 1-D leaf as long, hold
  ``out / model`` of them on each model rank (OIHW dim 0; yolojax's HWIO
  dim 3);
* ZeRO-1: a per-parameter optimizer buffer is split over the data ranks on
  its largest axis that ``data`` divides, other than the model axis
  (yolojax's ``opt_state_shardings``, computed on the yolojax layout and
  mapped back, so ties break on the same logical axis); the 1-D BN buffers
  of a tensor-parallel conv put both axes on their one dim.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# yolojax's dim j of an HWIO kernel is the port's dim _HWIO_TO_OIHW[j];
# of an (in, out) dense kernel, _DENSE_TO_PORT[j]
_HWIO_TO_OIHW = (2, 3, 1, 0)
_DENSE_TO_PORT = (1, 0)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(data, model)`` grid of processes. ``data_group`` and
    ``model_group`` are None in a one-process run."""

    data: int
    model: int
    rank: int = 0
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model


def make_mesh(*, data: Optional[int] = None, model: int = 1,
              world: Optional[int] = None) -> Mesh:
    """The mesh over the default process group's ranks (one rank, no
    groups, when there is no group). ``data`` defaults to the ranks left
    after ``model``; ``data * model`` may not exceed the ranks, with
    yolojax's ``make_mesh`` messages (a one-process run has one device), and
    must use every rank: one process per device has no device to leave
    idle. Every rank must call this, in the same order (it makes groups)."""
    n = world if world is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model > n:
        raise ValueError(
            f"mesh {data}x{model} needs data*model = {data * model} "
            f"devices, have {n}")
    if data * model < n:
        raise ValueError(
            f"mesh {data}x{model} uses {data * model} of {n} processes; run "
            f"one process per mesh device")
    if n == 1 or not dist.is_initialized():
        return Mesh(data, model)
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return Mesh(data, model, rank, data_group, model_group)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def tp_dim(shape: Sequence[int], tp_size: int,
           tp_threshold: int = 1024) -> Optional[int]:
    """The dim of a port-layout leaf of ``shape`` that tensor parallelism
    splits over the model ranks, or None (yolojax's ``_tp_dim``: a conv
    kernel's output channels, or a 1-D leaf as long)."""
    if (tp_size > 1 and len(shape) in (1, 4) and shape[0] >= tp_threshold
            and shape[0] % tp_size == 0):
        return 0
    return None


def param_shard_dims(params: Dict[str, Any], tp_size: int,
                     tp_threshold: int = 1024) -> Dict[str, Optional[int]]:
    """{name: the model-axis dim of that leaf, or None (replicated)};
    leaves are tensors or shapes (yolojax's ``param_shardings``)."""
    return {k: tp_dim(_shape(v), tp_size, tp_threshold)
            for k, v in params.items()}


def _to_reference(shape: Tuple[int, ...]):
    """The yolojax layout of a port shape, and its dim map back."""
    if len(shape) == 4:
        return tuple(shape[j] for j in _HWIO_TO_OIHW), _HWIO_TO_OIHW
    if len(shape) == 2:
        return (shape[1], shape[0]), _DENSE_TO_PORT
    return shape, tuple(range(len(shape)))


def zero_dims(shape: Sequence[int], dp: int, tp_size: int,
              tp_threshold: int = 1024) -> Tuple[Optional[int], Optional[int]]:
    """(model dim, data dim) of a per-parameter optimizer buffer of global
    ``shape`` under ZeRO-1 over ``dp`` data ranks (yolojax's
    ``opt_state_shardings`` rule): the model dim as :func:`tp_dim`; the
    data dim the largest other axis that ``dp`` divides, or, for a leaf
    whose only axis is the model one, that axis when ``tp_size * dp``
    divides it. Equal dims mean both axes on one dim, the model blocks
    outer."""
    shape = tuple(shape)
    if len(shape) < 1:
        return None, None
    m_dim = tp_dim(shape, tp_size, tp_threshold)
    if dp <= 1:
        return m_dim, None
    ref, to_port = _to_reference(shape)
    ref_tp = None if m_dim is None else to_port.index(m_dim)
    dims = sorted((d for d in range(len(ref)) if d != ref_tp),
                  key=lambda d: -ref[d])
    for d in dims:
        if ref[d] % dp == 0 and ref[d] >= dp:
            return m_dim, to_port[d]
    if m_dim is not None and shape[m_dim] % (tp_size * dp) == 0:
        return m_dim, m_dim
    return m_dim, None


def opt_state_shard_dims(state: Dict[str, Any], dp: int, tp_size: int,
                         tp_threshold: int = 1024) -> Dict[str, Any]:
    """The port's flat optimizer state (``train/step.py::Optimizer``) ->
    the same dict with each per-parameter buffer's (model dim, data dim)
    (:func:`zero_dims`); the counts stay (None, None), replicated."""
    out: Dict[str, Any] = {}
    for key, value in state.items():
        if isinstance(value, dict):
            out[key] = {k: zero_dims(_shape(v), dp, tp_size, tp_threshold)
                        for k, v in value.items()}
        else:
            out[key] = (None, None)
    return out


def mesh_rows(mesh: Optional[Mesh], n_local: int
              ) -> Optional[Tuple[int, int]]:
    """(first row, global rows) of this rank's ``n_local`` rows of the
    global batch; None off a data-parallel mesh."""
    if mesh is None or mesh.data == 1:
        return None
    return mesh.data_index * n_local, n_local * mesh.data


def shard_rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` (its data block)."""
    if n % mesh.data:
        raise ValueError(f"batch {n} does not split over data={mesh.data}")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch) -> tuple:
    """This rank's rows of every leaf of a global batch (the data-axis
    split of yolojax's ``shard_batch``)."""
    rows = shard_rows(mesh, batch[0].shape[0])
    return tuple(torch.as_tensor(a)[rows] for a in batch)
