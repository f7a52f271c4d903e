"""The port's span recorder (``utils/profiling.py::span``) and the spans
the program records: off with no profiler running, on under a
``torch.profiler`` session, nested by thread, bounded; and the spans of
``build_detector``'s ``infer``, ``Loader.epoch`` and the train step."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from yolojax_torch.cli import detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data import cache, loader
from yolojax_torch.models import Model, get_model
from yolojax_torch.nn.layers import ConvSpec, MaxPoolSpec
from yolojax_torch.parallel.distributed import global_batch
from yolojax_torch.train import step
from yolojax_torch.train.losses import YoloV2LossConfig
from yolojax_torch.utils import profiling

from .util import write_synthetic_voc


@pytest.fixture(autouse=True)
def _clear():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def tracing():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_records_nothing():
    s = profiling.span("a", 1, 2)
    assert s is profiling.span("b")  # one shared no-op context
    with s:
        with profiling.span("c"):
            pass
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_spans_record_and_nest_under_a_profiler():
    with tracing() as prof:
        with profiling.span("outer", 7, 3):
            with profiling.span("inner", 7):
                pass
        with profiling.span("next"):
            pass
    with profiling.span("after"):  # the session has ended
        pass
    inner, outer, nxt = profiling.spans()
    assert [s.name for s in (inner, outer, nxt)] == ["inner", "outer",
                                                     "next"]
    assert inner.parent == outer.seq and outer.parent is None
    assert nxt.parent is None
    assert (outer.id, outer.n, inner.id, inner.n) == (7, 3, 7, None)
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= nxt.t0
    assert inner.thread == threading.get_ident()
    # the same spans in the profiler's own record
    names = [e.name for e in prof.events()]
    assert {"outer", "inner", "next"} <= set(names)


def hammer(threads=16, each=100):
    """Spans from more threads than cores, switching often: a batch span
    with a decode span inside, ``each`` times a thread."""
    def work(k):
        for j in range(each):
            with profiling.span("batch", (k, j)):
                with profiling.span("decode", (k, j)):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing():
            pool = [threading.Thread(target=work, args=(k,))
                    for k in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    return threads * each * 2


def test_spans_from_many_threads():
    total = hammer()
    got = profiling.spans()
    assert len(got) == total and profiling.spans_dropped() == 0
    batches = {s.id: s for s in got if s.name == "batch"}
    assert len(batches) == total // 2
    assert len({s.seq for s in got}) == total
    for s in got:
        if s.name == "decode":  # its parent is its own thread's batch
            assert s.parent == batches[s.id].seq
            assert s.thread == batches[s.id].thread


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAPACITY", 1000)
    total = hammer()
    assert len(profiling.spans()) == 1000
    assert profiling.spans_dropped() == total - 1000  # no drop uncounted
    profiling.clear_spans()
    assert profiling.spans() == [] and profiling.spans_dropped() == 0


def test_detect_infer_spans(tmp_path):
    model = get_model("yolo2", "tiny", 20)
    npz = str(tmp_path / "tiny.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(3),
                                            64))
    cfg = load_config([], ["model.model=yolo2", "model.inference=tiny",
                           "model.dim=64", "detect.threshold=0.005"])
    infer = detect.build_detector(cfg, npz, device="cpu")[2]
    x = np.random.RandomState(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    infer(x)  # call 0, with no profiler: no spans
    with tracing():
        out = infer(x)
    assert out["keep"].shape[0] == 2
    got = profiling.spans()
    assert [s.name for s in got] == ["detect.upload", "detect.dispatch",
                                     "detect.readback"]
    assert {s.id for s in got} == {1}
    assert got[0].n == x.nbytes
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))


def test_loader_epoch_spans(tmp_path):
    write_synthetic_voc(str(tmp_path / "voc"), n_images=6, size=(48, 40),
                        seed=2)
    c = cache.build_cache(str(tmp_path / "c"), "train",
                          [{"kind": "voc", "root": str(tmp_path / "voc"),
                            "image_set": "trainval"}], cache.VOC_NAMES)
    lo = loader.Loader(c, loader.LoaderConfig(
        batch_size=2, canvas_dim=32, num_threads=2, use_native=False))
    with tracing():
        batches = list(lo.epoch(3))
    assert len(batches) == 3
    got = profiling.spans()
    main = threading.get_ident()
    parents = {s.seq: s for s in got if s.name == "loader.batch"}
    assert sorted(s.id for s in parents.values()) == [(3, 0), (3, 1), (3, 2)]
    assert all(s.n == 2 and s.thread != main for s in parents.values())
    for name in ("loader.decode", "loader.letterbox"):
        children = [s for s in got if s.name == name]
        assert len(children) == 6  # one an image
        for s in children:
            p = parents[s.parent]
            assert (s.id, s.thread) == (p.id, p.thread)
            assert p.t0 <= s.t0 <= s.t1 <= p.t1


def test_train_step_and_upload_spans():
    model = Model("yolo2", "spans", "v2", (
        ConvSpec(8, 3), MaxPoolSpec(),
        ConvSpec(2 * (5 + 2), 1, bn=False, act="linear")),
        2, 2, anchors=((1.0, 1.0), (2.0, 2.0)))
    tx = step.make_optimizer(step.OptimizerConfig(
        optimizer="momentum", learning_rate=1e-3, weight_decay=0.0))
    ts = step.init_train_state(model, tx, torch.Generator().manual_seed(0),
                               32)
    fn = step.make_train_step(model, tx, augment=False,
                              compute_dtype=torch.float32,
                              loss_cfg=YoloV2LossConfig())
    rng = np.random.RandomState(0)
    host = (rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32),
            np.full((2, 3, 4), 0.5, np.float32), np.zeros((2, 3), np.int32),
            np.ones((2, 3), bool))
    ts, _ = fn(ts, global_batch(host, "cpu"), 1, 32)  # step 0: no profiler
    with tracing():
        batch = global_batch(host, "cpu")
        ts, _ = fn(ts, batch, 1, 32)
    got = profiling.spans()
    uploads = [s for s in got if s.name == "train.upload"]
    assert [s.n for s in uploads] == [h.nbytes for h in host]
    (update,) = [s for s in got if s.name == "train.update"]
    assert update.id == 1 and update.parent is None
