"""Host-side input pipeline: threaded image decode -> letterboxed canvases.

Port of ``LoaderConfig`` / ``Loader`` from ``yolojax/data/loader.py``. The
host reads, decodes and letterboxes each image to a fixed canvas on a
thread pool with a bounded prefetch queue; batches come out in order. The
C++ decode pool (``data/native.py``) takes whole batches of JPEGs where its
library loads, and an image it cannot decode goes through the Python
decoder alone.

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
import logging
import queue
import threading
from typing import Iterator

import numpy as np

from yolojax_torch.data.augment import letterbox_host
from yolojax_torch.data.cache import DatasetCache
from yolojax_torch.utils.profiling import span

log = logging.getLogger(__name__)


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
    def epoch(self, epoch_idx: int = 0, *, shuffle: bool = True) -> Iterator:
        """Yield batches for one epoch. Deterministic given (seed, epoch)."""
        order = np.arange(len(self.cache))
        if shuffle:
            # identical seed on every process -> consistent disjoint shards
            rng = np.random.RandomState((self.cfg.seed, epoch_idx))
            rng.shuffle(order)
        if self.cfg.shard_count > 1:
            order = order[self.cfg.shard_index :: self.cfg.shard_count]
        n = len(order)
        b = self.cfg.batch_size
        limit = (n // b) * b if self.cfg.drop_remainder else n

        work_q: "queue.Queue" = queue.Queue()
        out_q: "queue.Queue" = queue.Queue(maxsize=self.cfg.prefetch)
        batches = [order[s : s + b] for s in range(0, limit, b)]
        for bi, idxs in enumerate(batches):
            work_q.put((bi, idxs))
        stop = threading.Event()

        def put_or_stop(item):
            # out_q is bounded: re-check stop while waiting, so a consumer
            # that abandons the generator mid-epoch leaks no thread
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def worker():
            while not stop.is_set():
                try:
                    bi, idxs = work_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    put_or_stop((bi, self._load_batch(idxs,
                                                      (epoch_idx, bi))))
                except Exception as e:  # surface decode errors, don't hang
                    put_or_stop((bi, e))

        # with the native pool, decode parallelism lives in C++; two python
        # threads suffice to overlap batch assembly with consumption
        n_py_threads = 2 if self._native is not None else self.cfg.num_threads
        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(n_py_threads, max(len(batches), 1)))
        ]
        for t in threads:
            t.start()
        try:
            # batches may complete out of order across threads
            next_bi = 0
            pending = {}
            for _ in range(len(batches)):
                bi, payload = out_q.get()
                pending[bi] = payload
                while next_bi in pending:
                    p = pending.pop(next_bi)
                    if isinstance(p, Exception):
                        raise p
                    yield p
                    next_bi += 1
        finally:
            stop.set()

    def __iter__(self):
        return self.epoch(0)


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
