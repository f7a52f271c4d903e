"""The benchmark's YOLOv3 cell (``yolo3-coco-608.detect-v3-b128``): its
FLOP count, its five per-layer readers on traces made by hand, its files
resolved by name, a run of its driver on the CPU at a tiny size, and its
judge, whose ``correct`` is false with each detect fault planted in the
program."""

import copy
import importlib

import pytest
import torch

from benchmark import counts_v3, harness

CELL = "yolo3-coco-608.detect-v3-b128"
READERS = ("detect_v3_mfu", "residual_epilogue_roofline",
           "v3_conv_epilogue_roofline", "detect_v3.select_ms",
           "detect.topk_ms")
T0 = 1_800_000_000_000_000_000  # the window's start, unix ns
MS = 1_000_000

RESIDUAL = "void (anonymous namespace)::conv_epilogue_residual_kernel<8, false, true>(unsigned short const*, long, float const*, float const*, unsigned short const*, unsigned short*, long, int, float)"
PLAIN = "void (anonymous namespace)::conv_epilogue_kernel<8, false, true>(unsigned short const*, long, float const*, float const*, unsigned short*, long, int, float)"
SORT = "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::DeviceRadixSortPolicy<float, at::cuda::cub::detail::OpaqueType<8>, unsigned int, int>::Policy900, true, float, at::cuda::cub::detail::OpaqueType<8>, unsigned int, int, int, at_cuda_detail::cub::detail::identity_decomposer_t>(int*, int*, unsigned int*, unsigned int const*, float*, float const*, at::cuda::cub::detail::OpaqueType<8>*, at::cuda::cub::detail::OpaqueType<8> const*, int, int, int, at_cuda_detail::cub::detail::identity_decomposer_t)"
GATHER = "void at::native::_scatter_gather_elementwise_kernel<128, 8, at::native::_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4>, long>::operator()<at::native::TensorAssign>(at::TensorIterator&, long, long, long, at::native::TensorAssign const&)::{lambda(int)#1}>(int, at::native::_cuda_scatter_gather_internal_kernel<false, at::native::OpaqueType<4>, long>::operator()<at::native::TensorAssign>(at::TensorIterator&, long, long, long, at::native::TensorAssign const&)::{lambda(int)#1})"


TOPK = "void (anonymous namespace)::topk_select_kernel<true, false>(float const*, int, unsigned int const*, int const*, int, int, int, int, int, unsigned int*, int*, int, float*, long*)"
TOPK_FINAL = "void (anonymous namespace)::topk_select_kernel<false, true>(float const*, int, unsigned int const*, int const*, int, int, int, int, int, unsigned int*, int*, int, float*, long*)"
COPY = "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#10}::operator()() const::{lambda(c10::BFloat16)#1}> >(int, at::native::gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#10}::operator()() const::{lambda(c10::BFloat16)#1}> const&)"


def test_flops_are_darknets():
    config = harness.load_cell(CELL).config
    assert counts_v3.flops_per_image(config, 608) == pytest.approx(
        140.69e9, rel=1e-4)
    assert counts_v3.flops_per_image(config, 416) == pytest.approx(
        65.86e9, rel=1e-4)
    res, n_res = counts_v3.epilogue_bytes(config, 608, True)
    plain, n_plain = counts_v3.epilogue_bytes(config, 608, False)
    assert (n_res, n_plain) == (23, 52)
    # 31.05 M of the 83.72 M conv output values an image end in a shortcut
    assert res / 6 == pytest.approx(31.05e6, rel=1e-3)
    assert res / 6 + plain / 4 == pytest.approx(83.72e6, rel=1e-3)


def make_run(events=(), counters=None, busy_ms=None):
    trace = harness.DeviceTrace()
    trace.t0, trace.t1 = T0, T0 + 1000 * MS
    trace.events = [(n, T0 + round(a * MS), T0 + round(b * MS))
                    for n, a, b in events]
    rec = harness.Recorder()
    rec.counters.update(counters or {})
    out = harness.Outcome(0, 0, {}, {}, 0, rec, trace)
    summary = (None if busy_ms is None else
               harness.TraceSummary(busy_ms / 1e3, 1.0, [], []))
    return harness.Run(harness.load_cell(CELL), out, summary)


# one batch of 128 images: 23 residual launches of 0.5 ms, 52 plain ones
# of 0.25 ms, a sort of 4 ms and a gather of 1 ms, the top-K select's two
# launches of 0.5 and 0.25 ms, in 200 ms of busy time
BATCH = ([(RESIDUAL, k, k + 0.5) for k in range(23)]
         + [(PLAIN, 30 + k, 30.25 + k) for k in range(52)]
         + [(SORT, 100, 104), (GATHER, 104, 105),
            ("Memset (Device)", 105, 106), (COPY, 106, 110),
            (TOPK, 110, 110.5), (TOPK_FINAL, 110.5, 110.75)])


def want(name):
    config = harness.load_cell(CELL).config
    if name == "detect_v3_mfu":
        return (100.0 * 128 * counts_v3.flops_per_image(config, 608)
                / counts_v3.PEAK_BF16 / 0.2)
    if name == "residual_epilogue_roofline":
        return (100.0 * 128 * counts_v3.epilogue_bytes(config, 608, True)[0]
                / counts_v3.HBM_BYTES_PER_S / (23 * 0.5e-3))
    if name == "v3_conv_epilogue_roofline":
        return (100.0 * 128 * counts_v3.epilogue_bytes(config, 608, False)[0]
                / counts_v3.HBM_BYTES_PER_S / (52 * 0.25e-3))
    if name == "detect.topk_ms":
        return 0.75
    return 5.0


@pytest.mark.parametrize("name", READERS)
def test_reader_values(name):
    run = make_run(BATCH, {"images": 128, "batches": 1}, busy_ms=200)
    assert harness.load_reader(name)(run) == pytest.approx(want(name))


@pytest.mark.parametrize("name,empty", [(n, "no launches") for n in READERS]
                         + [("detect_v3_mfu", "no images"),
                            ("detect_v3.select_ms", "no images"),
                            ("detect.topk_ms", "no images")])
def test_reader_reads_nothing(name, empty):
    """A program without the kernels (one older than the cell), or a
    window that finished no batch."""
    if empty == "no launches":
        run = make_run([("other_kernel", 0, 1)], {"images": 128,
                                                  "batches": 1}, busy_ms=0)
    else:
        run = make_run(BATCH, {"images": 0, "batches": 0}, busy_ms=200)
    assert harness.load_reader(name)(run) is None


def test_cell_resolves():
    cell = harness.load_cell(CELL)
    assert cell.config["name"] == "yolo3-coco-608" and cell.chips == 1
    assert cell.config["reduced"] == [] and len(cell.config["layers"]) == 107
    assert cell.mix["kind"] == "detect_v3"
    importlib.import_module("benchmark.drivers.detect_v3")
    assert cell.limits and cell.limits["nms_faults"] == 0
    assert {m["name"] for m in cell.end_to_end} == {
        "detect_batch_device_ms", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(READERS)
    for m in cell.per_layer:
        assert m["moves"] == "detect_batch_device_ms"
        assert callable(harness.load_reader(m["name"]))


def tiny_cell():
    """The cell at a size the CPU runs in seconds: full widths, input 64,
    two batches of two small images."""
    cell = copy.deepcopy(harness.load_cell(CELL))
    cell.mix.update({"batch": 2, "pool_batches": 2, "sample_batches": 2,
                     "sizes": [[120, 90], [90, 120]]})
    cell.config["input"] = 64
    cell.config["ini"]["model.dim"] = "64"
    return cell


@pytest.fixture(scope="module")
def driver():
    """The driver, with torch held to 2 threads: the full-width network on
    the CPU beside the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield importlib.import_module("benchmark.drivers.detect_v3")
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def program(driver):
    """The context and the set-up of a tiny run: (ctx, config, weights,
    canvas pool, raw images, infer)."""
    ctx = harness.Context(tiny_cell(), 2 ** 31 + 17, 0.3, False,
                          torch.device("cpu"))
    return (ctx,) + driver.setup(ctx)


def test_run_reads_correct(driver):
    """A whole run of the driver, loop, sample and judge."""
    cell = tiny_cell()
    ctx = harness.Context(cell, 2 ** 31 + 19, 0.3, False, torch.device("cpu"))
    out = driver.run(ctx)
    assert out.attempted >= 2 and out.failed == 0
    assert harness.judge(out, cell.limits)[0], out.compared


def altered(kind):
    from yolojax_torch.eval import evaluator

    real = evaluator.postprocess_v3

    def post(*args, **kw):
        out = real(*args, **kw)
        if kind == "keep":       # one candidate's keep flag flipped
            out["keep"][0, 3] = ~out["keep"][0, 3]
        elif kind == "score":    # one candidate's score doubled
            out["scores"][0, 10] = out["scores"][0, 10] * 2
        elif kind == "class":    # every candidate's class changed
            out["classes"] = (out["classes"] + 7) % 80
        return out

    return post


def next_k(skip):
    """The K candidates after the best ``skip`` K: in score order, with
    their true scores and a sound NMS; only the choice is wrong."""
    from yolojax_torch.postprocess import nms

    real = nms._select_candidates

    def select(corners, scores, score_thresh, top_k, candidates="auto"):
        boxes, top, classes, valid = real(corners, scores, score_thresh,
                                          (skip + 1) * top_k, candidates)
        rows = slice(skip * top_k, None)
        return (boxes[:, rows], top[:, rows], classes[:, rows],
                valid[:, rows])

    return select


FAULTS = [None, "keep", "score", "class", "next-2k"] + (
    ["next-k"] if "topk_out_share" in harness.load_cell(CELL).limits
    else [])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_read_incorrect(fault, driver, program, monkeypatch):
    """Both pool batches through the program with the fault planted where
    its answer is produced, judged by the driver's judge."""
    from yolojax_torch.eval import evaluator
    from yolojax_torch.postprocess import nms

    if fault in ("keep", "score", "class"):
        monkeypatch.setattr(evaluator, "postprocess_v3", altered(fault))
    elif fault is not None:
        monkeypatch.setattr(nms, "_select_candidates",
                            next_k(2 if fault == "next-2k" else 1))
    ctx, cfg, weights, pool, raw, infer = program
    kept = [(n, infer(batch)) for n, batch in enumerate(pool)]
    compared = driver.judge(ctx, cfg, weights, raw, kept)
    out = harness.Outcome(4, 0, {}, compared, 0, ctx.recorder)
    correct, _ = harness.judge(out, ctx.cell.limits)
    assert correct == (fault is None), compared
