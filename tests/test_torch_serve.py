"""The port's serving layer on the CPU: the three kernels as
``torch.library`` custom operators (``kernels/ops.py``), the exported
serving artifact (``yolojax_torch/serve``: exact round trip of the bf16,
fused-stem and int8 programs, the header checks), and the dynamic batcher
(``serve/batching.py``) against every case of yolojax's
``tests/unit/test_batching.py``."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from yolojax.serve import MAGIC as JAX_MAGIC
from yolojax_torch.cli.detect import build_serving
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.kernels import ops
from yolojax_torch.models import get_model
from yolojax_torch.nn.stem import pack_stem_kernel
from yolojax_torch.serve import MAGIC, load_artifact, save_artifact
from yolojax_torch.serve.batching import DynamicBatcher, QueueFull

# ---------------------------------------------------------------------------
# the custom operators
# ---------------------------------------------------------------------------


def _op_cases():
    rng = np.random.RandomState(0)
    cy, cx = rng.uniform(0, 1, (2, 3, 64))
    hw = rng.uniform(0.05, 0.4, (2, 3, 64))
    boxes = torch.from_numpy(np.stack([cy - hw[0] / 2, cx - hw[1] / 2,
                                       cy + hw[0] / 2, cx + hw[1] / 2],
                                      -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(0, 1, (3, 64)) < 0.8)
    w0 = (rng.randn(3, 3, 3, 32) * 0.3).astype(np.float32)
    x = torch.from_numpy(rng.uniform(0, 1, (2, 16, 24, 3)).astype(np.float32))
    wp = torch.from_numpy(pack_stem_kernel(w0))
    b = torch.from_numpy(rng.normal(0, 0.1, 32).astype(np.float32))
    wide = torch.from_numpy(rng.randint(-3000, 3000, (40, 96)).astype(
        np.int32))
    m = torch.from_numpy(rng.uniform(1e-4, 1e-3, 64).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, 64).astype(np.float32))
    y = torch.from_numpy(rng.normal(0, 2, (2, 5, 7, 125)).astype(
        np.float32)).bfloat16()
    shift = torch.from_numpy(rng.normal(0, 0.5, 125).astype(np.float32))
    inv = torch.from_numpy(rng.uniform(0.5, 1.5, 125).astype(np.float32))
    # scores with ties and a -0.0 (NaN, which compares unequal to
    # itself, is held bit for bit in tests/test_torch_nms.py)
    scores = torch.from_numpy((rng.randint(0, 16, (3, 500)) / 16).astype(
        np.float32))
    scores[0, 7] = -0.0
    return {
        "nms_greedy": (ops.nms_greedy, (boxes, valid, 0.45)),
        "topk_select": (ops.topk_select, (scores, 64)),
        "stem_fused": (ops.stem_fused, (x, wp, b)),
        # a column slice of a wider product, as the int8 trunk passes it
        "int8_requant": (ops.int8_requant,
                         (wide[:, :64], m, bias, 1.0 / 0.037, 127, True, 1)),
        "int8_requant_phases": (ops.int8_requant,
                                (wide[:, :64], m, bias, 25.0, 15, True, 4)),
        # the v2 head's width; the folded bias, and BN's (inv, shift)
        "conv_epilogue": (ops.conv_epilogue, (y, shift, None, False, 0.1)),
        "conv_epilogue_bn": (ops.conv_epilogue, (y, shift, inv, True, 0.1)),
    }


@pytest.mark.parametrize("case", list(_op_cases()))
def test_custom_op_opcheck(case):
    """``torch.library.opcheck`` (schema, fake tensor, autograd
    registration, AOT dispatch) on the CPU, whose implementation is each
    kernel's plain version."""
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_custom_ops_are_the_plain_versions_on_the_cpu():
    from yolojax_torch.nn.stem import stem_fused_torch
    from yolojax_torch.postprocess.cuda_nms import nms_greedy_cuda
    from yolojax_torch.postprocess.cuda_topk import topk_select_cuda
    from yolojax_torch.postprocess.nms import nms_greedy_torch, topk_select_torch
    from yolojax_torch.quantize.int8_ops import int8_requant_torch

    cases = _op_cases()
    boxes, valid, thr = cases["nms_greedy"][1]
    before = nms_greedy_cuda.launches
    assert torch.equal(ops.nms_greedy(boxes, valid, thr),
                       nms_greedy_torch(boxes, valid, thr))
    x, wp, b = cases["stem_fused"][1]
    assert torch.equal(ops.stem_fused(x, wp, b),
                       stem_fused_torch(x, wp, b))
    args = cases["int8_requant_phases"][1]
    assert torch.equal(ops.int8_requant(*args), int8_requant_torch(*args))
    assert nms_greedy_cuda.launches == before  # no kernel on the CPU
    scores, k = cases["topk_select"][1]
    topk_before = topk_select_cuda.launches
    for got, want in zip(ops.topk_select(scores, k),
                         topk_select_torch(scores, k)):
        assert torch.equal(got, want)
    assert topk_select_cuda.launches == topk_before


# ---------------------------------------------------------------------------
# serving artifacts
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("art")
    model = get_model("yolo2", "tiny", 3, anchors=((1.0, 1.0), (2.0, 2.0)))
    npz = str(tmp / "w.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(0),
                                            64))
    ini = tmp / "t.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n"
                   "num_classes = 3\nanchors = 1.0,1.0 2.0,2.0\n"
                   "[detect]\nthreshold = 0.001\ntop_k = 32\n")
    x = torch.from_numpy(np.random.RandomState(1).uniform(
        0, 1, (2, 64, 64, 3)).astype(np.float32))
    return {"tmp": tmp, "npz": npz, "ini": str(ini), "x": x}


def _export(tiny, overrides, name):
    cfg = load_config([tiny["ini"]], overrides)
    _, dim, infer_fn, net, device = build_serving(
        cfg, tiny["npz"], list(tiny["x"][:1]), device="cpu")
    path = str(tiny["tmp"] / name)
    meta = save_artifact(path, infer_fn, net, batch=2, dim=dim,
                         meta={"names": ["a", "b", "c"], "stretch": False},
                         device=device)
    return path, meta, infer_fn, net


@pytest.mark.parametrize("overrides", [
    [], ["detect.fuse_stem=pallas"], ["detect.use_int8=1"],
    ["detect.use_int8=1", "detect.fuse_stem=xla"],
], ids=["f32", "fused-stem", "int8", "int8-stem"])
def test_roundtrip_exact(tiny, overrides):
    """The loaded artifact's outputs equal the live program's bit for bit
    on the CPU, and its graph holds the kernels' operators (the stem's
    with ``fuse_stem``, the requant's with int8, the top-K select and NMS
    always)."""
    path, meta, infer_fn, net = _export(tiny, overrides, "m.yjts")
    assert meta["platforms"] == ["cpu"] and meta["payload_bytes"] > 1e6
    assert (meta["batch"], meta["dim"]) == (2, 64)
    want = infer_fn(net, tiny["x"])
    art = load_artifact(path, device="cpu")
    assert art.meta["names"] == ["a", "b", "c"]
    got = art(tiny["x"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    program = torch.export.load(_payload(path))
    targets = {str(n.target) for n in program.graph.nodes
               if "yolojax_torch" in str(n.target)}
    want_ops = {"yolojax_torch.nms_greedy.default",
                "yolojax_torch.topk_select.default"}
    if "detect.fuse_stem=pallas" in overrides:
        want_ops.add("yolojax_torch.stem_fused.default")
    if "detect.use_int8=1" in overrides:
        want_ops.add("yolojax_torch.int8_requant.default")
    assert targets == want_ops
    if "detect.use_int8=1" in overrides:
        kinds = {s.kind.name for s in program.graph_signature.input_specs}
        assert "BUFFER" in kinds and "PARAMETER" not in kinds


def _payload(path):
    import io

    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[len(MAGIC):len(MAGIC) + 4], "little")
    return io.BytesIO(raw[len(MAGIC) + 4 + n:])


def test_bad_magic_rejected(tmp_path):
    p = tmp_path / "bad.yjts"
    p.write_bytes(b"not an artifact at all")
    with pytest.raises(ValueError, match="bad magic"):
        load_artifact(str(p), device="cpu")


def test_yolojax_artifact_names_the_route(tmp_path):
    p = tmp_path / "m.yjsa"
    blob = b'{"platforms": ["cpu"]}'
    p.write_bytes(JAX_MAGIC + len(blob).to_bytes(4, "little") + blob)
    with pytest.raises(ValueError, match="yolojax_torch.cli.export"):
        load_artifact(str(p), device="cpu")


def test_corrupt_metadata_rejected(tmp_path):
    p = tmp_path / "trunc.yjts"
    blob = b'{"truncated'
    p.write_bytes(MAGIC + len(blob).to_bytes(4, "little") + blob)
    with pytest.raises(ValueError, match="corrupt artifact metadata"):
        load_artifact(str(p), device="cpu")


def test_platform_mismatch_rejected(tiny, tmp_path):
    path = _export(tiny, [], "p.yjts")[0]
    with open(path, "rb") as f:
        raw = f.read()
    n = int.from_bytes(raw[len(MAGIC):len(MAGIC) + 4], "little")
    meta = json.loads(raw[len(MAGIC) + 4:len(MAGIC) + 4 + n])
    meta["platforms"] = ["cuda"]  # as if exported on the card
    blob = json.dumps(meta).encode()
    p = tmp_path / "cuda.yjts"
    p.write_bytes(MAGIC + len(blob).to_bytes(4, "little") + blob
                  + raw[len(MAGIC) + 4 + n:])
    with pytest.raises(ValueError, match="exported for"):
        load_artifact(str(p), device="cpu")


def test_directory_rejected(tmp_path):
    with pytest.raises(ValueError, match="directory"):
        load_artifact(str(tmp_path), device="cpu")


def test_tflite_handed_to_artifact_gets_a_hint(tmp_path):
    p = tmp_path / "model.tflite"
    p.write_bytes(b"TFL3 flatbuffer bytes")
    with pytest.raises(ValueError, match="TFLite interpreter"):
        load_artifact(str(p), device="cpu")


@pytest.mark.parametrize("kind", ["savedmodel", "tflite"])
def test_artifact_hints_name_the_tf_loaders(tmp_path, kind):
    """A SavedModel directory or a ``.tflite`` file handed to
    ``load_artifact`` names the port's own loader for it, as yolojax's
    hints name its loaders; the named function exists."""
    import importlib

    if kind == "savedmodel":
        path = tmp_path / "model"
        path.mkdir()
        (path / "saved_model.pb").write_bytes(b"pb")
    else:
        path = tmp_path / "model.tflite"
        path.write_bytes(b"TFL3 flatbuffer bytes")
    loader = {"savedmodel": "load_savedmodel", "tflite": "load_tflite"}[kind]
    with pytest.raises(ValueError,
                       match=rf"yolojax_torch\.serve\.{kind}\.{loader}"):
        load_artifact(str(path), device="cpu")
    assert callable(getattr(importlib.import_module(
        f"yolojax_torch.serve.{kind}"), loader))


# ---------------------------------------------------------------------------
# the dynamic batcher: every case of tests/unit/test_batching.py
# ---------------------------------------------------------------------------

DIM = 8
FILLER = np.zeros((DIM, DIM, 3), np.float32)


def _canvas(v):
    return np.full((DIM, DIM, 3), float(v), np.float32)


class RecordingInfer:
    """Fake device fn: echoes each canvas's fill value so per-slot routing
    is checkable; records every batch it saw."""

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail
        self.lock = threading.Lock()

    def __call__(self, canvases):
        with self.lock:
            self.batches.append(np.array(canvases))
        if self.fail:
            raise ValueError("device exploded")
        return {"tag": canvases[:, 0, 0, 0].copy()}


def _submit_concurrently(batcher, values):
    results = {}
    errors = {}

    def go(v):
        try:
            results[v] = batcher.submit(_canvas(v))
        except Exception as e:  # noqa: BLE001 — recorded for assertions
            errors[v] = e

    threads = [threading.Thread(target=go, args=(v,)) for v in values]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    return results, errors


def test_full_batch_dispatches_without_waiting_for_window():
    infer = RecordingInfer()
    b = DynamicBatcher(infer, batch=3, filler=FILLER, window_ms=10_000)
    t0 = time.monotonic()
    results, errors = _submit_concurrently(b, [1, 2, 3])
    assert not errors
    assert time.monotonic() - t0 < 5, "a full batch must not wait the window"
    assert len(infer.batches) == 1 and infer.batches[0].shape[0] == 3
    for v, (res, fill) in results.items():
        assert res["tag"] == pytest.approx(float(v))  # slot routing
        assert fill == 3
    b.close()


def test_partial_batch_dispatches_at_window_close_with_padding():
    infer = RecordingInfer()
    b = DynamicBatcher(infer, batch=4, filler=_canvas(-1), window_ms=150)
    results, errors = _submit_concurrently(b, [5, 6])
    assert not errors
    (batch,) = infer.batches
    assert batch.shape[0] == 4  # padded to the fixed batch size
    assert sorted(batch[:, 0, 0, 0].tolist()) == [-1.0, -1.0, 5.0, 6.0]
    assert all(fill == 2 for _, fill in results.values())
    b.close()


def test_queue_larger_than_batch_splits_into_chunks():
    infer = RecordingInfer()
    b = DynamicBatcher(infer, batch=2, filler=FILLER, window_ms=10_000)
    results, errors = _submit_concurrently(b, [1, 2, 3, 4, 5, 6])
    assert not errors and len(results) == 6
    assert len(infer.batches) == 3
    assert b.stats()["images"] == 6 and b.stats()["mean_fill"] == 2.0
    b.close()


def test_infer_error_propagates_to_every_submitter():
    infer = RecordingInfer(fail=True)
    b = DynamicBatcher(infer, batch=2, filler=FILLER, window_ms=50)
    results, errors = _submit_concurrently(b, [1, 2])
    assert not results and len(errors) == 2
    assert all("device exploded" in str(e) for e in errors.values())
    assert b.stats()["errors"] >= 1
    b.close()


def test_submit_after_close_raises():
    b = DynamicBatcher(RecordingInfer(), batch=1, filler=FILLER)
    b.close()
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(_canvas(1))


def test_batch_one_is_passthrough():
    infer = RecordingInfer()
    b = DynamicBatcher(infer, batch=1, filler=FILLER, window_ms=10_000)
    res, fill = b.submit(_canvas(7))
    assert fill == 1 and res["tag"] == pytest.approx(7.0)
    b.close()


def test_invalid_batch_rejected():
    with pytest.raises(ValueError, match=">= 1"):
        DynamicBatcher(RecordingInfer(), batch=0, filler=FILLER)


class BlockingInfer:
    """Holds the device call open until the test releases it, so queue
    depth is controllable deterministically."""

    def __init__(self):
        self.gate = threading.Event()
        self.started = threading.Event()

    def __call__(self, canvases):
        self.started.set()
        assert self.gate.wait(30)
        return {"tag": canvases[:, 0, 0, 0].copy()}


class OverlapInfer:
    """Proves two dispatches are in flight at the same time: the first
    call blocks until the second arrives (bounded wait so a broken
    pipeline fails the assertion instead of deadlocking)."""

    def __init__(self, want=2):
        self.want = want
        self.inflight = 0
        self.max_inflight = 0
        self.lock = threading.Lock()
        self.reached = threading.Event()

    def __call__(self, canvases):
        with self.lock:
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
            if self.inflight >= self.want:
                self.reached.set()
        self.reached.wait(5)
        with self.lock:
            self.inflight -= 1
        return {"tag": canvases[:, 0, 0, 0].copy()}


def test_pipeline_depth_overlaps_dispatches():
    infer = OverlapInfer(want=2)
    b = DynamicBatcher(infer, batch=1, filler=FILLER, window_ms=0,
                       pipeline_depth=2)
    results, errors = _submit_concurrently(b, [1, 2])
    assert not errors
    assert infer.max_inflight == 2, "depth=2 must run 2 batches at once"
    for v, (res, fill) in results.items():
        assert res["tag"] == pytest.approx(float(v)) and fill == 1
    b.close()


def test_pipeline_depth_bounds_inflight_and_routes_results():
    infer = OverlapInfer(want=2)
    b = DynamicBatcher(infer, batch=1, filler=FILLER, window_ms=0,
                       pipeline_depth=2)
    results, errors = _submit_concurrently(b, [1, 2, 3, 4, 5, 6])
    assert not errors and len(results) == 6
    assert infer.max_inflight == 2, "semaphore must cap in-flight at depth"
    for v, (res, _) in results.items():
        assert res["tag"] == pytest.approx(float(v))
    s = b.stats()
    assert s["images"] == 6 and s["errors"] == 0
    b.close()


def test_pipeline_close_drains_inflight():
    infer = RecordingInfer()
    b = DynamicBatcher(infer, batch=2, filler=FILLER, window_ms=20,
                       pipeline_depth=3)
    results, errors = _submit_concurrently(b, [1, 2, 3, 4, 5])
    b.close()
    assert not errors and len(results) == 5
    assert b.stats()["images"] == 5


def test_pipeline_error_isolated_per_batch():
    """A failing batch poisons only its own submitters, also under
    pipelining."""

    class FlakyInfer:
        def __call__(self, canvases):
            if float(canvases[0, 0, 0, 0]) == 13.0:
                raise ValueError("device exploded")
            return {"tag": canvases[:, 0, 0, 0].copy()}

    b = DynamicBatcher(FlakyInfer(), batch=1, filler=FILLER, window_ms=0,
                       pipeline_depth=2)
    # serialize submissions so the poison value sits alone in its batch
    ok1 = b.submit(_canvas(1))
    with pytest.raises(ValueError, match="device exploded"):
        b.submit(_canvas(13))
    ok2 = b.submit(_canvas(2))
    assert ok1[0]["tag"] == pytest.approx(1.0)
    assert ok2[0]["tag"] == pytest.approx(2.0)
    assert b.stats()["errors"] == 1
    b.close()


def test_invalid_pipeline_depth_rejected():
    with pytest.raises(ValueError, match="pipeline_depth"):
        DynamicBatcher(RecordingInfer(), batch=1, filler=FILLER,
                       pipeline_depth=0)


def test_backpressure_rejects_beyond_max_queue():
    infer = BlockingInfer()
    b = DynamicBatcher(infer, batch=1, filler=FILLER, window_ms=0,
                       max_queue=1)
    t_a = threading.Thread(target=lambda: b.submit(_canvas(1)))
    t_a.start()
    assert infer.started.wait(10)  # A is on the device, queue empty
    t_b = threading.Thread(target=lambda: b.submit(_canvas(2)))
    t_b.start()
    deadline = time.monotonic() + 10
    while b.stats()["queued"] < 1:  # B is waiting
        assert time.monotonic() < deadline
        time.sleep(0.01)
    with pytest.raises(QueueFull, match="retry later"):
        b.submit(_canvas(3))  # C: queue at capacity -> shed
    assert b.stats()["rejected"] == 1
    infer.gate.set()  # release the device; A then B complete
    t_a.join(30)
    t_b.join(30)
    assert not t_a.is_alive() and not t_b.is_alive()
    assert b.stats()["images"] == 2 and b.stats()["queued"] == 0
    b.close()


def test_close_race_fails_undispatched_group_instead_of_hanging():
    """If a wedged in-flight dispatch outlives close()'s join timeout, the
    worker can wake up after the pool is shut down; its next submit must
    fail the undispatched group explicitly (error + done set) rather than
    leave those submitters blocked forever. Such a group never reached the
    device: it counts as an error and not as a batch (yolojax counts it in
    both, which lowers ``mean_fill``)."""
    infer = BlockingInfer()
    b = DynamicBatcher(infer, batch=1, filler=FILLER, window_ms=0,
                       pipeline_depth=2, max_queue=8)
    outcomes = {}
    entered = [threading.Event() for _ in range(3)]

    def go(v):
        entered[v - 1].set()
        try:
            outcomes[v] = ("ok", b.submit(_canvas(v)))
        except Exception as e:  # noqa: BLE001 — recorded for assertions
            outcomes[v] = ("err", e)

    threads = [threading.Thread(target=go, args=(v,)) for v in (1, 2, 3)]
    for t in threads:
        t.start()
    # both in-flight slots fill with gate-blocked dispatches; the worker
    # takes the third group and blocks on the in-flight semaphore
    assert infer.started.wait(10)
    assert all(e.wait(10) for e in entered)
    time.sleep(0.1)  # each submit appends right after entering
    deadline = time.monotonic() + 10
    while b.stats()["queued"] > 0:
        assert time.monotonic() < deadline
        time.sleep(0.01)
    # close with a join timeout shorter than the wedge: worker outlives it
    closer = threading.Thread(target=lambda: b.close(timeout=0.2))
    closer.start()
    time.sleep(0.5)  # close() is now inside pool.shutdown(wait=True)
    infer.gate.set()  # un-wedge the device; in-flight batches complete
    closer.join(30)
    for t in threads:
        t.join(30)
        assert not t.is_alive(), "a submitter hung after close()"
    errs = [v for v, (kind, _) in outcomes.items() if kind == "err"]
    oks = [v for v, (kind, _) in outcomes.items() if kind == "ok"]
    # the wedged-but-dispatched groups complete; any group the worker
    # popped after shutdown gets an explicit error, never a hang
    assert len(oks) + len(errs) == 3
    for v in errs:
        assert "closed" in str(outcomes[v][1])
    s = b.stats()
    assert s["errors"] == len(errs)
    assert s["batches"] == len(oks) and s["images"] == len(oks)
    assert s["mean_fill"] == (1.0 if oks else 0.0)
