"""ctypes binding of the native decode pool (``native/libyolodata.so``).

Port of ``yolojax/data/native.py``. The C++ pool decodes + letterboxes a
whole batch of JPEG files in one GIL-releasing call (``native/yolodata.cc``).
The port loads the library that is in the checkout (or in
``$YOLOJAX_NATIVE_DIR``) and never builds it: where it is missing or does
not load (no ``libjpeg`` on the machine), :func:`available` is False and
:class:`yolojax_torch.data.loader.Loader` decodes in Python threads.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = os.environ.get("YOLOJAX_NATIVE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_PATH = os.path.join(_NATIVE_DIR, "libyolodata.so")


@functools.lru_cache(maxsize=None)
def _load_lib() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_SO_PATH)
    except OSError as e:
        log.info("native loader unavailable: %s", e)
        return None
    lib.ydl_create.restype = ctypes.c_void_p
    lib.ydl_create.argtypes = [ctypes.c_int]
    lib.ydl_destroy.argtypes = [ctypes.c_void_p]
    lib.ydl_load_batch.restype = ctypes.c_int
    lib.ydl_load_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def available() -> bool:
    return _load_lib() is not None


class NativeDecodePool:
    """Batch decode+letterbox via the C++ worker pool."""

    def __init__(self, num_threads: int = 8):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"{_SO_PATH} is not available")
        self._lib = lib
        self._pool = lib.ydl_create(int(num_threads))

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.ydl_destroy(self._pool)
            self._pool = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def load_batch(
        self, paths, dim: int, *, stretch: bool = False
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (images (N,dim,dim,3) f32 [0,1], transforms (N,4) f32
        [sx, sy, px, py], status (N,) int32 0=ok)."""
        n = len(paths)
        images = np.empty((n, dim, dim, 3), np.float32)
        transforms = np.empty((n, 4), np.float32)
        status = np.empty((n,), np.int32)
        arr = (ctypes.c_char_p * n)(
            *[os.fsencode(str(p)) for p in paths]
        )
        self._lib.ydl_load_batch(
            self._pool, arr, n, int(dim), int(bool(stretch)),
            images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            transforms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        return images, transforms, status
