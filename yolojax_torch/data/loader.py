"""Host-side input pipeline: threaded image decode -> letterboxed canvases.

Port of ``LoaderConfig`` / ``Loader`` from ``yolojax/data/loader.py``. The
host reads, decodes and letterboxes each image to a fixed canvas on a
pool of worker threads, each building whole batches, with a bounded
prefetch; batches come out in order. The C++ decode pool
(``data/native.py``) takes whole batches of JPEGs where its library
loads, and an image it cannot decode goes through the Python decoder
alone.

A Loader builds its pool at its first epoch and keeps it. Once it has
been asked for epoch e and then e+1 with the same ``shuffle``, as a
training loop asks, the pool runs ahead: when an epoch's last batch has
been dealt to a worker, the workers go straight on to the next epoch's,
within the same prefetch bound. Any other call drops what was built
ahead. Each Python worker runs ``letterbox_host`` on an intra-op team of
its own, of ``WORKER_INTRA_OP_THREADS``.

The Python decoder reads binary 8-bit PPM (P6) files with numpy and hands
every other format to ``cv2``, so a machine without ``cv2`` (a bare CUDA
image has neither it nor PIL) evaluates a PPM-image cache; ``cv2.imread``
reads the same files to the same pixels, so such a cache means the same
to both packages. The letterbox is the port's ``letterbox_host``.

Batches are fixed-shape numpy arrays: images (B, canvas, canvas, 3)
float32 in [0,1], boxes (B, G, 4) normalized xywh on the canvas, classes
(B, G) int32, valid (B, G) bool. Epoch shuffling is seeded.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import threading
import weakref
from typing import Iterator, List, Optional

import numpy as np
import torch

from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.cache import DatasetCache
from yolojax_torch.utils.profiling import span

log = logging.getLogger(__name__)

# intra-op threads of each Python worker (``torch.set_num_threads`` sets
# the calling thread's OpenMP team): workers that each lead a team as wide
# as the machine oversubscribe its cores by the number of workers. Two,
# not one: ``F.interpolate``'s bilinear kernel gives other bits on one
# thread than on two or more (about 28% of a 448 canvas's values, by up
# to 2e-7), and two give the bits of any wider team.
WORKER_INTRA_OP_THREADS = 2


@dataclasses.dataclass(frozen=True)
class LoaderConfig:
    batch_size: int = 32
    canvas_dim: int = 448   # host letterbox target
    max_boxes: int = 50     # GT padding (fixed shapes)
    num_threads: int = 8
    prefetch: int = 4       # batches in flight
    seed: int = 0
    stretch: bool = False   # plain resize instead of letterbox
    drop_remainder: bool = True
    use_native: bool = True  # C++ decode pool when libyolodata.so loads
    loader: str = "native"   # native (threads + C++ pool) | grain
    grain_workers: int = 0   # grain worker processes (0: decode inline)
    # multi-host: each process loads a disjoint slice of every epoch
    shard_index: int = 0
    shard_count: int = 1


class Loader:
    """Iterable over one phase of a :class:`DatasetCache`."""

    def __init__(self, cache: DatasetCache, cfg: LoaderConfig):
        self.cache = cache
        self.cfg = cfg
        self._decoder = decode_image
        self._native = None
        self._pool = None
        if cfg.use_native:
            from yolojax_torch.data.native import NativeDecodePool, available

            if available():
                self._native = NativeDecodePool(cfg.num_threads)
                log.info("using native decode pool (%d threads)",
                         cfg.num_threads)

    def __len__(self) -> int:
        n = len(self.cache)
        if self.cfg.shard_count > 1:
            n = len(range(self.cfg.shard_index, n, self.cfg.shard_count))
        b = self.cfg.batch_size
        return n // b if self.cfg.drop_remainder else (n + b - 1) // b

    # -- single example ----------------------------------------------------
    def _load_example(self, i: int, batch=None):
        with span("loader.decode", batch):
            img = self._decoder(str(self.cache.paths[i]))
        with span("loader.letterbox", batch):
            canvas, tf = letterbox_host(img, self.cfg.canvas_dim,
                                        stretch=self.cfg.stretch)
        return (canvas.numpy(), *self._gt_arrays(i, *tf))

    def _gt_arrays(self, i: int, sx, sy, px, py):
        """Padded GT arrays for example i, transformed to canvas coords."""
        _, boxes, classes = self.cache.example(i)
        g = self.cfg.max_boxes
        out_boxes = np.zeros((g, 4), np.float32)
        out_cls = np.zeros((g,), np.int32)
        valid = np.zeros((g,), bool)
        k = min(len(boxes), g)
        if k:
            b = boxes[:k].copy()
            b[:, 0] = b[:, 0] * sx + px
            b[:, 1] = b[:, 1] * sy + py
            b[:, 2] = b[:, 2] * sx
            b[:, 3] = b[:, 3] * sy
            out_boxes[:k] = b
            out_cls[:k] = classes[:k]
            valid[:k] = True
        return out_boxes, out_cls, valid

    def _load_batch(self, idxs, batch=None):
        """Build one batch; uses the C++ decode pool when available.
        ``batch``: its (epoch, index), the id of its spans."""
        with span("loader.batch", batch, len(idxs)):
            if self._native is None:
                ex = [self._load_example(int(i), batch) for i in idxs]
                return tuple(map(np.stack, zip(*ex)))
            paths = [str(self.cache.paths[int(i)]) for i in idxs]
            images, transforms, status = self._native.load_batch(
                paths, self.cfg.canvas_dim, stretch=self.cfg.stretch)
            boxes, cls, valid = [], [], []
            for j, i in enumerate(idxs):
                if status[j] != 0:  # not a JPEG, or corrupt: decode in Python
                    images[j], b, c, v = self._load_example(int(i), batch)
                else:
                    b, c, v = self._gt_arrays(int(i), *transforms[j])
                boxes.append(b)
                cls.append(c)
                valid.append(v)
            return images, np.stack(boxes), np.stack(cls), np.stack(valid)

    # -- epoch iteration ---------------------------------------------------
    def _start(self) -> "_Pool":
        """The worker pool, built at the first epoch and kept."""
        if self._pool is None:
            native = self._native is not None
            # with the native pool, decode parallelism lives in C++; two
            # python threads suffice to overlap batch assembly with
            # consumption
            workers = max(1, min(2 if native else self.cfg.num_threads,
                                 len(self)))
            self._pool = _Pool(
                weakref.WeakMethod(self._load_batch),
                functools.partial(epoch_batches, len(self.cache), self.cfg),
                workers, max(self.cfg.prefetch, 0) + workers,
                None if native else WORKER_INTRA_OP_THREADS)
            self._finalize = weakref.finalize(self, self._pool.close)
        return self._pool

    def close(self) -> None:
        """Stop the worker threads and wait for them to end; dropping the
        Loader stops them too. A later epoch builds a new pool."""
        if self._pool is not None:
            self._finalize()
            self._pool.join()
            self._pool = None

    def epoch(self, epoch_idx: int = 0, *, shuffle: bool = True) -> Iterator:
        """Yield batches for one epoch. Deterministic given (seed, epoch)."""
        n = len(self)
        if not n:
            return
        pool = self._start()
        run = pool.request(epoch_idx, shuffle)
        done = False
        try:
            for bi in range(n):
                run, p = pool.take(run, epoch_idx, shuffle, bi, bi == n - 1)
                if isinstance(p, Exception):
                    raise p
                done = bi == n - 1
                yield p
        finally:
            if not done:  # left mid-epoch: build no more of it
                pool.cancel(run)

    def __iter__(self):
        return self.epoch(0)


def epoch_batches(n: int, cfg: LoaderConfig, epoch_idx: int,
                  shuffle: bool) -> List[np.ndarray]:
    """The cache indices of each batch of one epoch of ``n`` images, in
    order: deterministic given (seed, epoch)."""
    order = np.arange(n)
    if shuffle:
        # identical seed on every process -> consistent disjoint shards
        rng = np.random.RandomState((cfg.seed, epoch_idx))
        rng.shuffle(order)
    if cfg.shard_count > 1:
        order = order[cfg.shard_index :: cfg.shard_count]
    b = cfg.batch_size
    limit = (len(order) // b) * b if cfg.drop_remainder else len(order)
    return [order[s : s + b] for s in range(0, limit, b)]


class _Pool:
    """A Loader's worker threads and the batches they build. Jobs are dealt
    in order from one stream, each a whole batch to one worker; at most
    ``slots`` are dealt and not yet taken (built, or in a worker's hands),
    and the consumer takes them in order. A stream serves one epoch, or,
    once a caller has asked for consecutive epochs, runs on into the next
    epoch as soon as the last batch of one is dealt. A new stream drops
    what the old one built; its jobs still in a worker's hands are dropped
    when they end."""

    def __init__(self, build, batches, workers: int, slots: int,
                 intra_op: Optional[int]):
        self._build = build      # weak method: (idxs, (epoch, bi)) -> batch
        self._batches = batches  # (epoch, shuffle) -> index arrays
        self._slots = slots
        # one lock, two waits: a freed slot wakes one worker, a built
        # batch wakes the consumer (re-entrant: the garbage collector may
        # close the pool on a thread that holds it)
        self._lock = threading.RLock()
        self._can_deal = threading.Condition(self._lock)
        self._built = threading.Condition(self._lock)
        self._jobs = None        # the stream's (epoch, bi, idxs) to deal
        self._ready = {}         # (epoch, bi) -> batch or exception
        self._held = 0           # dealt and neither taken nor dropped
        self._run = 0            # serial of the stream
        self._runs_ahead = False
        self._ahead = None       # the request the stream is already dealing
        self._last = None        # (epoch, shuffle) of the last request
        self._closed = False
        started = None
        if intra_op:
            # the count a new thread takes up; set_num_threads also sets
            # it, so it is given back once every worker has set its own
            inherited = _in_new_thread(torch.get_num_threads)
            intra_op = min(inherited, intra_op)
            started = threading.Barrier(workers + 1)
        self._threads = [
            threading.Thread(target=self._work, args=(intra_op, started),
                             daemon=True, name=f"loader-{k}")
            for k in range(workers)]
        for t in self._threads:
            t.start()
        if started is not None:
            started.wait()
            _in_new_thread(torch.set_num_threads, inherited)

    def _work(self, intra_op: Optional[int], started) -> None:
        if intra_op:
            # take up the inherited count first: a thread's first parallel
            # op takes up the process's count, which is given back below
            torch.get_num_threads()
            torch.set_num_threads(intra_op)
            started.wait()
        while True:
            with self._lock:
                job = self._deal()
                while job is None:
                    if self._closed:
                        return
                    self._can_deal.wait()
                    job = self._deal()
            run, epoch, bi, idxs = job
            build = self._build()
            if build is None:  # the Loader is gone
                return
            try:
                payload = build(idxs, (epoch, bi))
            except Exception as e:  # raised at its batch's yield
                payload = e
            del build
            with self._lock:
                if run == self._run:
                    self._ready[(epoch, bi)] = payload
                    self._built.notify_all()
                else:
                    self._held -= 1
                    self._can_deal.notify()

    def _deal(self):
        if self._closed or self._jobs is None or self._held >= self._slots:
            return None
        job = next(self._jobs, None)
        if job is None:
            self._jobs = None
            return None
        self._held += 1
        return (self._run, *job)

    def _stream(self, epoch: int, shuffle: bool, start: int, ahead: bool):
        while True:
            batches = self._batches(epoch, shuffle)
            for bi in range(start, len(batches)):
                yield epoch, bi, batches[bi]
            if not (ahead and batches):
                return
            epoch, start = epoch + 1, 0

    def _restart(self, epoch: Optional[int], shuffle: bool = True,
                 start: int = 0, ahead: bool = False) -> None:
        self._run += 1
        self._held -= len(self._ready)
        self._ready.clear()
        self._runs_ahead, self._ahead = ahead, None
        self._jobs = (None if epoch is None
                      else self._stream(epoch, shuffle, start, ahead))
        self._can_deal.notify_all()
        self._built.notify_all()

    def request(self, epoch: int, shuffle: bool) -> int:
        """A consumer starts ``epoch``: keep the stream if it already runs
        ahead into it, else start one (that runs ahead when the last
        request was the epoch before, with the same ``shuffle``). Returns
        the stream's serial."""
        with self._lock:
            if self._ahead != (epoch, shuffle):
                self._restart(epoch, shuffle,
                              ahead=self._last == (epoch - 1, shuffle))
            self._last, self._ahead = (epoch, shuffle), None
            return self._run

    def take(self, run: int, epoch: int, shuffle: bool, bi: int,
             last: bool):
        """Batch ``bi`` of ``epoch`` (a batch or the exception its build
        raised) for the consumer of stream ``run``, waiting until it is
        built. A consumer whose stream another replaced deals the rest of
        its epoch afresh. Returns (the stream's serial, the batch)."""
        key = (epoch, bi)
        with self._lock:
            if run != self._run:
                self._restart(epoch, shuffle, bi)
                run = self._run
            with span("loader.get", key, int(key in self._ready)):
                while key not in self._ready:
                    if self._closed:
                        raise RuntimeError("the loader was closed")
                    self._built.wait()
            payload = self._ready.pop(key)
            self._held -= 1
            if last and self._runs_ahead:
                self._ahead = (epoch + 1, shuffle)
            self._can_deal.notify()
            return run, payload

    def cancel(self, run: int) -> None:
        """The consumer of stream ``run`` left mid-epoch."""
        with self._lock:
            if run == self._run:
                self._restart(None)

    def close(self) -> None:
        """Deal nothing more; each worker ends once its batch is built.
        Waits for none: the garbage collector may call it on a worker."""
        with self._lock:
            self._closed = True
            self._restart(None)

    def join(self) -> None:
        for t in self._threads:
            t.join()


def _in_new_thread(fn, *args):
    """``fn(*args)`` on a thread of its own (one that has not yet taken up
    an intra-op thread count)."""
    out = []
    t = threading.Thread(target=lambda: out.append(fn(*args)))
    t.start()
    t.join()
    return out[0]


def read_ppm(path: str) -> np.ndarray:
    """Decode a binary 8-bit PPM (P6, maxval 255) file to RGB uint8 HWC."""
    with open(path, "rb") as f:
        return parse_ppm(f.read(), path)


def parse_ppm(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """The bytes of a binary 8-bit PPM (P6, maxval 255) -> RGB uint8 HWC;
    ValueError when they are not one."""
    fields, pos = [], 2  # after the magic "P6"
    while len(fields) < 3:  # width, height, maxval; '#' comments between
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            raise ValueError(f"{path}: malformed PPM header")
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if maxval != 255:
        raise ValueError(f"{path}: PPM maxval {maxval}; only 8-bit "
                         "(maxval 255) PPM is read without cv2")
    pos += 1  # the single whitespace byte before the raster
    pixels = np.frombuffer(data, np.uint8, count=h * w * 3, offset=pos)
    return pixels.reshape(h, w, 3).copy()


def write_ppm(path: str, rgb: np.ndarray) -> None:
    """Write an RGB uint8 HWC image as a binary PPM (P6) file."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(rgb.tobytes())


def decode_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC: 8-bit binary PPM with numpy,
    any other format with ``cv2``."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"P6":
        try:
            return read_ppm(path)
        except ValueError:
            pass  # a PPM variant the numpy reader does not take: cv2
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"cannot decode {path}: only 8-bit binary PPM (P6) is read "
            f"without cv2, and cv2 is not importable ({e})") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def decode_image_bytes(data: bytes) -> np.ndarray:
    """Decode an encoded image (a request body) to RGB uint8 HWC: 8-bit
    binary PPM with numpy, any other format with ``cv2``. Raises
    ValueError when the bytes do not decode."""
    if data[:2] == b"P6":
        try:
            return parse_ppm(data)
        except ValueError:
            pass  # a PPM variant the numpy reader does not take: cv2
    try:
        import cv2
    except ImportError:
        raise ValueError("undecodable image: only 8-bit binary PPM (P6) is "
                         "read without cv2") from None
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("undecodable image")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
