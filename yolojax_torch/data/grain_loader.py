"""Grain-backed input pipeline, the alternative to ``data/loader.py``.

Port of ``yolojax/data/grain_loader.py``: the same batch contract on top of
``grain.python``'s DataLoader, for runs that want grain's worker
processes, its determinism and its checkpointable iterator
(``stream()`` exposes ``get_state`` / ``set_state`` for an exact mid-epoch
resume; ``cli/train.py`` saves that state beside every checkpoint):

  images (B, canvas, canvas, 3) f32 [0, 1], boxes (B, G, 4) xywh,
  classes (B, G) i32, valid (B, G) bool

Select it with ``[queue] loader = grain``; ``[queue] grain_workers = N``
decodes in N grain worker processes (0: in the training process). Each
example is decoded, letterboxed and padded by the port's own
:class:`~yolojax_torch.data.loader.Loader` (``_load_example``, without the
C++ pool: grain owns the parallelism), so a batch holds what the default
loader would put there; the order is grain's. Multi-process runs shard
with grain's ``ShardOptions``.

``grain`` is imported when a loader is made, never when this module is
(grain uses jax when it can import it, and runs without). A machine
without grain raises an ImportError that names it; there is no fallback
to the default loader.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Optional

import numpy as np

from yolojax_torch.data.cache import DatasetCache
from yolojax_torch.data.loader import Loader, LoaderConfig

log = logging.getLogger(__name__)


def _grain():
    try:
        import grain.python as gp
    except ImportError as e:
        raise ImportError(
            f"queue.loader=grain needs the grain package, which does not "
            f"import here ({e}); use queue.loader=native") from e
    return gp


class _IndexSource:
    """Record i is the index i (the decode is the map transform).
    Module-level so grain's worker processes can unpickle it."""

    def __init__(self, n: int):
        self._n = n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        return int(i)

    def __repr__(self):  # stable: grain checks repr() across restores
        return f"_IndexSource(n={self._n})"


class _Decode:
    """Decode + letterbox + pad one example with the port's Loader. Holds
    only (cache, cfg), so it pickles into grain's workers; each process
    builds its Loader on first use."""

    def __init__(self, cache: DatasetCache, cfg: LoaderConfig):
        self._cache = cache
        self._cfg = dataclasses.replace(cfg, use_native=False)
        self._loader = None

    def __getstate__(self):
        return {"cache": self._cache, "cfg": self._cfg}

    def __setstate__(self, state):
        self._cache, self._cfg = state["cache"], state["cfg"]
        self._loader = None

    def map(self, i):
        if self._loader is None:
            self._loader = Loader(self._cache, self._cfg)
        return self._loader._load_example(int(i))


_DECODE_CLASS = None


def _decode_transform_class():
    """``_Decode`` as a grain ``MapTransform`` (made on first use, so the
    module imports without grain). Registered as this module's
    ``_DecodeExample`` for pickling into worker processes."""
    global _DECODE_CLASS
    if _DECODE_CLASS is None:
        gp = _grain()
        _DECODE_CLASS = type("_DecodeExample", (_Decode, gp.MapTransform),
                             {"__module__": __name__})
    return _DECODE_CLASS


def __getattr__(name):  # a worker unpickling the transform finds it here
    if name == "_DecodeExample":
        return _decode_transform_class()
    raise AttributeError(name)


class GrainLoader:
    """A grain DataLoader yielding the default loader's batch shapes."""

    def __init__(self, cache: DatasetCache, cfg: LoaderConfig, *,
                 worker_count: Optional[int] = None):
        self._gp = _grain()
        self.cache = cache
        self.cfg = cfg
        self._decode = _decode_transform_class()(cache, cfg)
        self._worker_count = (cfg.grain_workers if worker_count is None
                              else worker_count)
        if self._worker_count:
            log.info("grain loader: %d worker processes", self._worker_count)

    def __len__(self) -> int:
        n = len(self.cache)
        if self.cfg.shard_count > 1:
            if self.cfg.drop_remainder:
                # grain's even split drops the tail: every shard n // count
                n = n // self.cfg.shard_count
            else:
                # sizes differ by at most one, as a strided split's
                n = len(range(self.cfg.shard_index, n, self.cfg.shard_count))
        b = self.cfg.batch_size
        return n // b if self.cfg.drop_remainder else (n + b - 1) // b

    def _make_dataloader(self, *, shuffle: bool, num_epochs, seed: int):
        """The one construction of ``epoch`` and ``stream``: the two must
        never differ in sharding, decode or batching."""
        gp, cfg = self._gp, self.cfg
        sampler = gp.IndexSampler(
            num_records=len(self.cache),
            shard_options=gp.ShardOptions(
                shard_index=cfg.shard_index, shard_count=cfg.shard_count,
                drop_remainder=cfg.drop_remainder),
            shuffle=shuffle, num_epochs=num_epochs, seed=seed)
        return gp.DataLoader(
            data_source=_IndexSource(len(self.cache)),
            sampler=sampler,
            operations=[self._decode,
                        gp.Batch(batch_size=cfg.batch_size,
                                 drop_remainder=cfg.drop_remainder)],
            worker_count=self._worker_count)

    def epoch(self, epoch_idx: int = 0, *, shuffle: bool = True) -> Iterator:
        loader = self._make_dataloader(shuffle=shuffle, num_epochs=1,
                                       seed=self.cfg.seed + epoch_idx)
        for batch in loader:
            yield tuple(np.asarray(a) for a in batch)

    def __iter__(self):
        return self.epoch(0)

    def stream(self, *, shuffle: bool = True) -> "CheckpointableStream":
        """An endless batch stream (grain reshuffles each epoch from the
        seed) with grain's iterator state, for an exact mid-epoch
        resume."""
        return CheckpointableStream(self._make_dataloader(
            shuffle=shuffle, num_epochs=None, seed=self.cfg.seed))


class CheckpointableStream:
    """Iterator over numpy batches with ``get_state() -> bytes`` and
    ``set_state(bytes)``."""

    def __init__(self, loader):
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        return tuple(np.asarray(a) for a in next(self._it))

    def get_state(self) -> bytes:
        return self._it.get_state()

    def set_state(self, state: bytes) -> None:
        self._it.set_state(state)


def make_loader(cache: DatasetCache, cfg: LoaderConfig, kind: str = "native"):
    """``native`` (threads + the C++ decode pool) or ``grain``."""
    if kind == "grain":
        return GrainLoader(cache, cfg)
    if kind in ("native", "thread", ""):
        return Loader(cache, cfg)
    raise ValueError(f"unknown loader kind {kind!r} (native|grain)")
