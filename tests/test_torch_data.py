"""Host data: the port's dataset cache, loader (with and without the native
decode pool) and PPM decoder against yolojax's on the same files; the
loader's persistent worker pool against a frozen copy of the per-epoch
loader it replaced."""

import gc
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import yolojax.data.native
from yolojax.data import cache as jax_cache
from yolojax.data.loader import Loader as JaxLoader
from yolojax.data.loader import LoaderConfig as JaxLoaderConfig
from yolojax_torch.data import cache, loader, native
from yolojax_torch.utils import profiling

from .util import write_synthetic_coco, write_synthetic_voc

CACHE_FIELDS = ("paths", "sizes", "offsets", "boxes", "classes", "difficult")


def assert_caches_equal(got, want):
    for field in CACHE_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.names == want.names


def build_both(tmp_path, datasets, names):
    got = cache.build_cache(str(tmp_path / "port"), "test", datasets, names)
    want = jax_cache.build_cache(str(tmp_path / "jax"), "test", datasets,
                                 names)
    assert_caches_equal(got, want)
    for d in ("port", "jax"):
        with open(tmp_path / d / "names.txt") as f:
            assert tuple(f.read().split()) == want.names
    # each package loads the other's file to the same arrays
    assert_caches_equal(cache.load_cache(str(tmp_path / "jax"), "test"), want)
    assert_caches_equal(jax_cache.load_cache(str(tmp_path / "port"), "test"),
                        want)
    return got


def test_voc_cache_matches_jax(tmp_path):
    write_synthetic_voc(str(tmp_path / "voc"), n_images=12, seed=1,
                        difficult_frac=0.3)
    got = build_both(tmp_path, [{"kind": "voc", "root": str(tmp_path / "voc"),
                                 "image_set": "test"}], cache.VOC_NAMES)
    assert got.difficult.any() and not got.difficult.all()


def test_coco_cache_matches_jax(tmp_path):
    ann, img_dir = write_synthetic_coco(str(tmp_path / "coco"), n_images=7,
                                        seed=2)
    for names in (None, ("blue", "red", "green")):  # category order or given
        got = build_both(tmp_path, [{"kind": "coco", "ann_json": ann,
                                     "image_dir": img_dir}], names)
        assert len(got) == 7 and not got.difficult.any()


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_loader_epoch_matches_jax(tmp_path, monkeypatch, use_native, shard):
    """Batches of one shuffled epoch, ragged last batch kept. Images of the
    canvas size, so neither package resizes: the canvases are the decoded
    pixels and must agree to 1e-6 whichever decoder ran."""
    if use_native:
        assert native.available() and yolojax.data.native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(yolojax.data.native, "available", lambda: False)
    write_synthetic_voc(str(tmp_path / "voc"), n_images=11, size=(64, 64),
                        seed=3, difficult_frac=0.3)
    c = cache.build_cache(str(tmp_path / "c"), "test",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "test"}])
    kw = dict(batch_size=4, canvas_dim=64, max_boxes=3, num_threads=2,
              drop_remainder=False, seed=5, shard_index=shard[0],
              shard_count=shard[1])
    port = loader.Loader(c, loader.LoaderConfig(**kw))
    ref = JaxLoader(c, JaxLoaderConfig(**kw))
    assert (port._native is None) == (ref._native is None) == (not use_native)
    got = list(port.epoch(1))
    want = list(ref.epoch(1))
    assert len(got) == len(want) == len(port) == len(ref)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_loader_letterboxes_like_jax(tmp_path, monkeypatch):
    """Images of another size than the canvas: the boxes agree exactly and
    the canvases within the letterbox's tolerance (bilinear in two
    libraries, tests/test_torch_slice.py::test_letterbox_matches_cv2)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(yolojax.data.native, "available", lambda: False)
    write_synthetic_voc(str(tmp_path / "voc"), n_images=5, size=(96, 64),
                        seed=4)
    c = cache.build_cache(str(tmp_path / "c"), "test",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "test"}])
    kw = dict(batch_size=2, canvas_dim=48, num_threads=2,
              drop_remainder=True)
    for g, w in zip(loader.Loader(c, loader.LoaderConfig(**kw)).epoch(0),
                    JaxLoader(c, JaxLoaderConfig(**kw)).epoch(0)):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2e-4)
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)


def test_ppm_decoder_matches_cv2(tmp_path):
    import cv2

    rgb = np.random.RandomState(6).randint(0, 256, (37, 53, 3), np.uint8)
    ours, theirs = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    loader.write_ppm(ours, rgb)
    cv2.imwrite(theirs, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    commented = str(tmp_path / "c.ppm")
    with open(commented, "wb") as f:  # header comment, spaces, one line
        f.write(b"P6 # made by hand\n53   37\n# max\n255\n" + rgb.tobytes())
    for path in (ours, theirs, commented):
        want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)
        got = loader.read_ppm(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, rgb)
        np.testing.assert_array_equal(loader.decode_image(path), rgb)


def test_decoder_names_the_file_without_cv2(tmp_path, monkeypatch):
    import cv2

    png = str(tmp_path / "a.png")
    rgb = np.random.RandomState(7).randint(0, 256, (9, 11, 3), np.uint8)
    cv2.imwrite(png, cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    np.testing.assert_array_equal(loader.decode_image(png), rgb)  # via cv2
    ppm = str(tmp_path / "a.ppm")
    loader.write_ppm(ppm, rgb)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(loader.decode_image(ppm), rgb)
    with pytest.raises(RuntimeError, match=r"a\.png.*cv2"):
        loader.decode_image(png)


def test_ppm_cache_loads_like_png(tmp_path):
    """A COCO set written as PPM and as PNG (both lossless): the loader's
    batches are the same, the PPM through numpy, the PNG through cv2."""
    import cv2

    rng = np.random.RandomState(8)
    images, anns = [], []
    for fmt in ("ppm", "png"):
        os.makedirs(tmp_path / fmt)
    for i, (h, w) in enumerate(((40, 60), (64, 64), (50, 30))):
        rgb = rng.randint(0, 256, (h, w, 3), np.uint8)
        loader.write_ppm(str(tmp_path / "ppm" / f"{i}.img"), rgb)
        cv2.imwrite(str(tmp_path / "png" / f"{i}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        images.append({"id": i, "file_name": f"{i}.img", "width": w,
                       "height": h})
        anns.append({"id": i + 1, "image_id": i, "category_id": 1,
                     "bbox": [2, 3, 10, 12], "iscrowd": 0})
    batches = {}
    for fmt in ("ppm", "png"):
        if fmt == "png":
            for im in images:
                im["file_name"] = im["file_name"].replace(".img", ".png")
        ann = tmp_path / f"{fmt}.json"
        ann.write_text(json.dumps({"images": images, "annotations": anns,
                                   "categories": [{"id": 1, "name": "dog"}]}))
        c = cache.build_cache(str(tmp_path / f"c_{fmt}"), "test",
                              [{"kind": "coco", "ann_json": str(ann),
                                "image_dir": str(tmp_path / fmt)}], ("dog",))
        lo = loader.Loader(c, loader.LoaderConfig(
            batch_size=2, canvas_dim=32, drop_remainder=False, num_threads=2))
        batches[fmt] = list(lo.epoch(0, shuffle=False))
    assert len(batches["ppm"]) == 2
    for g, w in zip(batches["ppm"], batches["png"]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def per_epoch_loader(lo, epoch_idx, shuffle=True):
    """Frozen copy of ``Loader.epoch`` before its persistent pool: fresh
    threads and queues each call, none run ahead, workers on the intra-op
    threads they inherit."""
    order = np.arange(len(lo.cache))
    if shuffle:
        rng = np.random.RandomState((lo.cfg.seed, epoch_idx))
        rng.shuffle(order)
    if lo.cfg.shard_count > 1:
        order = order[lo.cfg.shard_index :: lo.cfg.shard_count]
    n = len(order)
    b = lo.cfg.batch_size
    limit = (n // b) * b if lo.cfg.drop_remainder else n

    work_q = queue.Queue()
    out_q = queue.Queue(maxsize=lo.cfg.prefetch)
    batches = [order[s : s + b] for s in range(0, limit, b)]
    for bi, idxs in enumerate(batches):
        work_q.put((bi, idxs))
    stop = threading.Event()

    def put_or_stop(item):
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
                put_or_stop((bi, lo._load_batch(idxs, (epoch_idx, bi))))
            except Exception as e:
                put_or_stop((bi, e))

    n_py_threads = 2 if lo._native is not None else lo.cfg.num_threads
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(min(n_py_threads, max(len(batches), 1)))]
    for t in threads:
        t.start()
    try:
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


def pool_cache(tmp_path, n_images=11):
    """JPEGs that the letterbox resizes to a canvas of 224: at this size
    ``F.interpolate`` on one intra-op thread gives other bits than on
    two or more."""
    write_synthetic_voc(str(tmp_path / "voc"), n_images=n_images,
                        size=(256, 192), seed=9)
    return cache.build_cache(str(tmp_path / "c"), "train",
                             [{"kind": "voc", "root": str(tmp_path / "voc"),
                               "image_set": "trainval"}], cache.VOC_NAMES)


def pool_config(**kw):
    return loader.LoaderConfig(**{**dict(
        batch_size=2, canvas_dim=224, max_boxes=3, num_threads=3, seed=7,
        use_native=False), **kw})


def assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def wait_until(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def built(lo, epoch):
    """Every batch of ``epoch`` built and waiting in the pool."""
    pool = lo._pool
    with pool._lock:
        return all((epoch, b) in pool._ready for b in range(len(lo)))


@pytest.fixture
def spans_cleared():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_pool_matches_per_epoch_loader(tmp_path, spans_cleared, use_native,
                                       drop_remainder, shard):
    """Three consecutive shuffled epochs, bit for bit and in order, against
    the frozen per-epoch loader; the third was built ahead, during the
    second, and each of its ``loader.get`` spans found its batch ready."""
    if use_native:
        assert native.available()
    c = pool_cache(tmp_path)
    cfg = pool_config(use_native=use_native, drop_remainder=drop_remainder,
                      shard_index=shard[0], shard_count=shard[1])
    lo, ref = loader.Loader(c, cfg), loader.Loader(c, cfg)
    assert (lo._native is None) == (not use_native)
    n = len(lo)
    with profile(activities=[ProfilerActivity.CPU]):
        for e in range(3):
            if e == 2:
                wait_until(lambda: built(lo, 2))
            assert_batches_equal(list(lo.epoch(e)),
                                 list(per_epoch_loader(ref, e)))
    gets = {s.id: s.n for s in profiling.spans() if s.name == "loader.get"}
    assert sorted(gets) == [(e, b) for e in range(3) for b in range(n)]
    assert [gets[(2, b)] for b in range(n)] == [1] * n
    lo.close()


@pytest.mark.parametrize("call", ["skip_an_epoch", "no_shuffle", "iter"])
def test_another_call_drops_the_run_ahead(tmp_path, call):
    """After epochs 0 and 1 the pool has built epoch 2 ahead; epoch 3,
    epoch 2 unshuffled or ``__iter__`` drops it (a new stream) and gets
    what the per-epoch loader gives."""
    c = pool_cache(tmp_path, n_images=8)
    lo, ref = loader.Loader(c, pool_config()), loader.Loader(c, pool_config())
    list(lo.epoch(0))
    list(lo.epoch(1))
    wait_until(lambda: built(lo, 2))
    stream = lo._pool._run
    got, want = {
        "skip_an_epoch": (lo.epoch(3), per_epoch_loader(ref, 3)),
        "no_shuffle": (lo.epoch(2, shuffle=False),
                       per_epoch_loader(ref, 2, shuffle=False)),
        "iter": (iter(lo), per_epoch_loader(ref, 0)),
    }[call]
    first = next(got)
    assert lo._pool._run == stream + 1
    assert_batches_equal([first, *got], list(want))
    lo.close()


def test_two_epochs_taken_in_turns(tmp_path):
    """Two generators of one Loader, taken in turns: each replaces the
    other's stream and deals the rest of its own epoch afresh."""
    c = pool_cache(tmp_path, n_images=8)
    lo, ref = loader.Loader(c, pool_config()), loader.Loader(c, pool_config())
    out = []
    t = threading.Thread(
        target=lambda: out.append(list(zip(lo.epoch(0), lo.epoch(1)))),
        daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and out, "the two epochs did not come out"
    got = out[0]
    want = list(zip(per_epoch_loader(ref, 0), per_epoch_loader(ref, 1)))
    for g, w in zip(got, want):
        assert_batches_equal(g, w)
    lo.close()


def test_a_single_epoch_never_runs_ahead(tmp_path):
    lo = loader.Loader(pool_cache(tmp_path, n_images=8), pool_config())
    assert len(list(lo.epoch(0, shuffle=False))) == 4
    time.sleep(0.2)
    with lo._pool._lock:  # nothing dealt past the epoch's last batch
        assert lo._pool._held == 0 and not lo._pool._ready
    lo.close()


def test_a_decode_error_ahead_raises_at_its_batch(tmp_path):
    """An image that epoch 1 drops (``drop_remainder``) and epoch 2 holds in
    its second batch fails to decode: the run-ahead builds that batch
    during epoch 1, and the error comes at its yield in epoch 2."""
    c = pool_cache(tmp_path, n_images=9)
    for seed in range(100):
        cfg = pool_config(batch_size=4, seed=seed)
        e1, e2 = (loader.epoch_batches(len(c), cfg, e, True) for e in (1, 2))
        (bad,) = set(range(9)) - set(np.concatenate(e1).tolist())
        if bad in e2[1]:
            break
    lo = loader.Loader(c, cfg)
    bad_path = str(c.paths[bad])
    armed = threading.Event()

    def decoder(path):
        if armed.is_set() and path == bad_path:
            raise ValueError(f"corrupt image {path}")
        return loader.decode_image(path)

    lo._decoder = decoder
    list(lo.epoch(0))
    armed.set()
    list(lo.epoch(1))
    wait_until(lambda: built(lo, 2))
    with lo._pool._lock:
        assert isinstance(lo._pool._ready[(2, 1)], ValueError)
    it = lo.epoch(2)
    next(it)  # batch 0 holds no such image
    with pytest.raises(ValueError, match="corrupt image"):
        next(it)
    lo.close()


@pytest.mark.parametrize("how", ["drop", "close"])
def test_closing_leaves_no_thread(tmp_path, how):
    c = pool_cache(tmp_path, n_images=8)
    before = threading.active_count()
    lo = loader.Loader(c, pool_config())
    list(lo.epoch(0))
    it = lo.epoch(1)  # runs ahead into epoch 2
    next(it)
    it.close()  # mid-epoch: the pool stops dealing it
    pool = lo._pool
    with pool._lock:
        assert pool._jobs is None and not pool._ready
    assert threading.active_count() > before
    if how == "close":
        lo.close()
        assert threading.active_count() == before
    else:
        del lo, it
        gc.collect()
        wait_until(lambda: threading.active_count() == before)
    wait_until(lambda: pool._held == 0)


def test_pool_under_stress(tmp_path):
    """More workers than cores, a thread switch every microsecond: six
    consecutive epochs (two left mid-way) come out as the per-epoch loader
    gives them, and once the pool is closed nothing stays dealt."""
    write_synthetic_voc(str(tmp_path / "voc"), n_images=10, size=(40, 30),
                        seed=5)
    c = cache.build_cache(str(tmp_path / "c"), "train",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "trainval"}], cache.VOC_NAMES)
    cfg = pool_config(batch_size=1, canvas_dim=32, num_threads=12,
                      prefetch=1)
    lo, ref = loader.Loader(c, cfg), loader.Loader(c, cfg)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for e in range(6):
            want = list(per_epoch_loader(ref, e))
            if e in (2, 4):  # left after 3 batches, then asked again
                it = lo.epoch(e)
                assert_batches_equal([next(it) for _ in range(3)], want[:3])
                it.close()
            assert_batches_equal(list(lo.epoch(e)), want)
            pool = lo._pool
            assert pool._held <= pool._slots
    finally:
        sys.setswitchinterval(interval)
    lo.close()
    assert pool._held == 0 and not any(t.is_alive() for t in pool._threads)


def test_workers_leave_the_intra_op_threads_as_they_were(tmp_path):
    """Each worker bounds its own intra-op pool to two threads; the calling
    thread, and threads started afterwards, keep the counts they had."""
    main = torch.get_num_threads()
    process = loader._in_new_thread(torch.get_num_threads)
    loader._in_new_thread(torch.set_num_threads, 3)  # new threads take 3
    try:
        lo = loader.Loader(pool_cache(tmp_path, n_images=4), pool_config())
        seen = []

        def decoder(path):
            seen.append(torch.get_num_threads())
            return loader.decode_image(path)

        lo._decoder = decoder
        list(lo.epoch(0))
        assert set(seen) == {loader.WORKER_INTRA_OP_THREADS}
        assert torch.get_num_threads() == main
        assert loader._in_new_thread(torch.get_num_threads) == 3
        lo.close()
    finally:
        loader._in_new_thread(torch.set_num_threads, process)
