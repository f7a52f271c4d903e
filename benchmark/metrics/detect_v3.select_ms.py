"""Device milliseconds a batch of the YOLOv3 program's candidate
selection (``postprocess/nms.py::_select_candidates``): ``torch.sort``'s
kernels over the (N, M·C) scores, 1.82 M an image at 608, and the gather
of the K best boxes after them. They are matched by the names an H100's
trace gives them (torch 2.11.0+cu128): the sort runs each image's
segment through cub's radix sort (``DeviceRadixSortHistogramKernel``,
``DeviceRadixSortExclusiveSumKernel``, ``DeviceRadixSortOnesweepKernel``)
after ``fill_reverse_indices_kernel``, and the gather is
``_scatter_gather_elementwise_kernel``. The sort's memsets are copies,
left out as the busy time leaves them out."""

FRAGMENTS = ("DeviceRadixSort", "fill_reverse_indices_kernel",
             "_scatter_gather_elementwise_kernel")


def read(run):
    batches = run.outcome.recorder.counters.get("batches", 0)
    ms = sum(b - a for n, a, b in run.events
             if any(f in n for f in FRAGMENTS)) / 1e6
    if not batches or not ms:
        return None
    return ms / batches
