"""Multi-process runs over ``torch.distributed``: one process per device.

Port of ``yolojax/parallel/distributed.py``. yolojax runs one process per
host and ``jax.distributed`` joins them into one runtime; the port runs one
process per device, as torch does, and joins them into one default process
group. Every process runs the same program on its own rows of the global
batch; ``parallel/mesh.py`` lays the processes out as a ``(data, model)``
grid with a group for each axis.

Launch (one command per device):

  python -m yolojax_torch.cli.train -c config.ini \\
      train.coordinator=host0:9999 train.num_processes=2 train.process_id=K

or through the environment: ``JAX_COORDINATOR`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` (the names yolojax reads). The backend is ``nccl`` for a
CUDA device and ``gloo`` for the CPU; a caller may name another with
``backend=`` (no config key does). On a CUDA device each process takes
card ``process_id % device_count`` unless the device names its index.
"""

from __future__ import annotations

import atexit
import datetime
import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from yolojax_torch.utils.profiling import span

log = logging.getLogger(__name__)

# a collective that waits longer than this fails the run instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def _settings(coordinator: str, num_processes: int, process_id: int):
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR", "")
    num_processes = num_processes or int(
        os.environ.get("JAX_NUM_PROCESSES", "0"))
    if process_id < 0:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "-1"))
    return coordinator, num_processes, process_id


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: Optional[str] = None, device=None) -> None:
    """Join the default process group of ``num_processes`` processes at
    ``tcp://<coordinator>`` as rank ``process_id`` (a group of one is
    allowed). On a CUDA device the process first takes its card."""
    device = torch.device(device if device is not None else (
        "cuda" if torch.cuda.is_available() else "cpu"))
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT)
    atexit.register(shutdown)
    log.info("distributed: process %d/%d, backend %s, device %s",
             process_id, num_processes, backend, device)


def maybe_initialize(coordinator: str = "", num_processes: int = 0,
                     process_id: int = -1, *, backend: Optional[str] = None,
                     device=None) -> bool:
    """Join the process group when the run is configured multi-process
    (arguments or environment). Returns True when running multi-process;
    a single-process run makes no group and returns False. A group that
    the caller already made (``initialize``) is taken as it is, provided
    it agrees with the configured size and rank."""
    coordinator, num_processes, process_id = _settings(
        coordinator, num_processes, process_id)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_processes > 1 and (world, rank) != (num_processes,
                                                   process_id):
            raise ValueError(
                f"the process group has world {world} rank {rank}; the "
                f"run asks for {num_processes} processes, id {process_id}")
        return world > 1
    if not coordinator or num_processes <= 1:
        return False
    if process_id < 0:
        raise ValueError("multi-process run needs process_id (>= 0)")
    initialize(coordinator, num_processes, process_id, backend=backend,
               device=device)
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group (registered at exit by :func:`initialize`)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def sync_done() -> None:
    """Park every process until all arrive (yolojax's
    ``sync_global_devices``): a process that finishes early must not tear
    the group down under one that is still working."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under ``nccl``, the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_numpy(arr: np.ndarray) -> np.ndarray:
    """Stack every process's ``arr`` (same shape and dtype everywhere) on a
    new leading axis, in rank order (``process_allgather``)."""
    dev = collective_device()
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def global_batch(local: Sequence, device=None) -> tuple:
    """This process's rows of the global batch, as tensors on ``device``.

    yolojax's ``make_array_from_process_local_data`` takes each process's
    rows and makes one array sharded over the mesh's ``data`` axis; in the
    port each process computes on its own rows, and the global batch is
    the concatenation of every data rank's rows in rank order."""
    arrays = [torch.as_tensor(np.asarray(a)) for a in local]
    n = {a.shape[0] for a in arrays}
    if len(n) != 1:
        raise ValueError(f"local batch leaves disagree on rows: {sorted(n)}")
    out = []
    for a in arrays:
        with span("train.upload", n=a.numel() * a.element_size()):
            out.append(a.to(device))
    return tuple(out)
