"""The bf16 train step's epilogue kernels together (``nn/train_epilogue.py``,
``csrc/bn_train.cu`` and ``conv_epilogue``): the least time their bytes
take at HBM bandwidth over their summed device time in the trace."""

from benchmark import counts

KERNELS = ("channel_sums_kernel", "finalize_kernel", "grad_apply_kernel",
           "conv_epilogue_kernel")


def read(run):
    seconds = launches = 0
    for name in KERNELS:
        s, n = run.kernel_seconds(name)
        seconds, launches = seconds + s, launches + n
    if not launches:
        return None
    per_image, per_step = counts.bn_train_bytes(run.cell.config,
                                                run.cell.mix["dim"])
    images = launches / per_step * run.cell.mix["batch"]
    return 100.0 * images * per_image / counts.HBM_BYTES_PER_S / seconds
