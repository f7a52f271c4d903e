"""Dynamic request batching for the detection serving daemon.

Port of ``yolojax/serve/batching.py``. The serving program has a fixed
batch B (an exported artifact bakes it; a live program keeps its cuDNN
plans warm at one shape), and the card spends about the same time on a
half-empty batch as on a full one. The batcher gathers single-image
requests that arrive together into one dispatch: the first request into an
empty queue opens a window of ``window_ms``; the batch launches when B
requests wait or the window closes, padded to B with a filler canvas, and
each request's slice of the results goes back to its blocked submitter.

One difference from yolojax: a group that fails before it is dispatched
(the pool was shut down under it) counts in ``errors`` only, not in
``batches`` — it never reached the device, so it must not lower
``mean_fill``.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np


class QueueFull(RuntimeError):
    """Backpressure signal: the request queue is at capacity — the client
    should retry later (HTTP 429/503 at the daemon layer) rather than
    stack unbounded latency behind a saturated device."""


class _Pending:
    __slots__ = ("canvas", "done", "result", "error", "fill")

    def __init__(self, canvas):
        self.canvas = canvas
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.fill = 0


class DynamicBatcher:
    """Batch concurrent ``submit`` calls into fixed-size ``infer`` calls.

    ``infer(canvases)`` receives a ``(batch, dim, dim, 3)`` float32 array
    and must return a dict of host arrays with leading dim ``batch``
    (the contract of ``cli/detect.py``'s ``build_detector`` inference fn).
    ``filler`` pads partial batches — it must be a valid single canvas.
    """

    def __init__(
        self,
        infer: Callable[[np.ndarray], Dict[str, Any]],
        batch: int,
        filler: np.ndarray,
        window_ms: float = 5.0,
        max_queue: int = 0,
        pipeline_depth: int = 1,
    ):
        """``max_queue``: requests allowed to WAIT beyond the one being
        assembled (0 = 8×batch). When the queue is at capacity ``submit``
        raises :class:`QueueFull` instead of stacking latency. Note the
        queue cap bounds *waiting* requests only: with ``pipeline_depth``
        D, up to ``D×batch`` further requests are in flight on the device
        side, so total in-system requests (and worst-case buffered
        latency) are bounded by ``max_queue + pipeline_depth×batch``.

        ``pipeline_depth``: dispatches allowed in flight at once. At the
        default 1 the worker serializes batches end-to-end (assemble →
        device → host pull → scatter). At depth D, up to D batches overlap:
        while batch N's results transfer back and scatter on the host,
        batch N+1 is already queued on the device — the chip never idles
        behind host-side work. ``infer`` is called from several threads at
        once and must return host arrays (the card's results copied out,
        which waits for them); batches may complete out of order, which is
        fine because every request carries its own completion event."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self._infer = infer
        self._batch = int(batch)
        self._filler = np.asarray(filler, np.float32)
        self._window = max(float(window_ms), 0.0) / 1e3
        self._max_queue = int(max_queue) if max_queue else 8 * self._batch
        self._cv = threading.Condition()
        self._queue: List[_Pending] = []
        self._closed = False
        self._images = 0
        self._batches = 0
        self._sum_fill = 0
        self._errors = 0
        self._rejected = 0
        self._depth = int(pipeline_depth)
        self._pool = None
        self._inflight = None
        if self._depth > 1:
            from concurrent.futures import ThreadPoolExecutor

            # the semaphore (not the executor queue) bounds in-flight
            # batches: the worker blocks on acquire instead of piling
            # unbounded dispatches behind a slow device
            self._pool = ThreadPoolExecutor(
                max_workers=self._depth,
                thread_name_prefix="yolojax-torch-dispatch")
            self._inflight = threading.Semaphore(self._depth)
        self._worker = threading.Thread(
            target=self._run, name="yolojax-torch-batcher", daemon=True)
        self._worker.start()

    def submit(self, canvas: np.ndarray):
        """Block until ``canvas`` has been through a batch; return
        ``(result, fill)``: this image's slice of the infer outputs
        (per-image arrays, batch dim dropped) and how many real images
        shared its batch — re-raises the infer exception if its batch
        failed."""
        p = _Pending(canvas)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self._max_queue:
                self._rejected += 1
                raise QueueFull(
                    f"{len(self._queue)} requests already queued "
                    f"(max_queue={self._max_queue}); retry later")
            self._queue.append(p)
            self._cv.notify_all()
        p.done.wait()
        if p.error is not None:
            raise p.error
        return p.result, p.fill

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "images": self._images,
                "batches": self._batches,
                "mean_fill": (self._sum_fill / self._batches
                              if self._batches else 0.0),
                "errors": self._errors,
                "rejected": self._rejected,
                "queued": len(self._queue),
            }

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain whatever is queued, join the
        worker (and any in-flight pipelined dispatches). Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout)
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # -- worker ------------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue and self._closed:
                    return
                # first request opens the batching window; leave early if
                # the batch fills (or the server is closing — drain fast)
                deadline = time.monotonic() + self._window
                while len(self._queue) < self._batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                group = self._queue[: self._batch]
                del self._queue[: self._batch]
            if self._pool is None:
                self._dispatch(group)
            else:
                self._inflight.acquire()
                try:
                    self._pool.submit(self._dispatch_release, group)
                except RuntimeError as e:
                    # close() shut the pool down while we outlived its join
                    # timeout (a wedged in-flight dispatch). Fail this group
                    # explicitly — its submitters block on done.wait() with
                    # no timeout and would otherwise hang forever.
                    self._inflight.release()
                    for p in group:
                        p.error = RuntimeError(
                            f"batcher closed while dispatching: {e}")
                        p.done.set()
                    with self._cv:  # never dispatched: not a batch
                        self._errors += 1

    def _dispatch_release(self, group: List[_Pending]):
        try:
            self._dispatch(group)
        finally:
            self._inflight.release()

    def _dispatch(self, group: List[_Pending]):
        fill = len(group)
        canvases = [p.canvas for p in group]
        canvases += [self._filler] * (self._batch - fill)
        failed = 0
        try:
            out = self._infer(np.stack(canvases))
            for k, p in enumerate(group):
                p.result = {key: np.asarray(val)[k]
                            for key, val in out.items()}
                p.fill = fill
        except Exception as e:  # propagate to every blocked submitter
            failed = 1
            for p in group:
                p.error = e
        finally:
            for p in group:
                p.done.set()
        with self._cv:
            self._images += fill
            self._batches += 1
            self._sum_fill += fill
            self._errors += failed
