"""``conv_epilogue`` (``nn/cuda_epilogue.py``): the least time its bytes
take at HBM bandwidth (2 B read, 2 B written a conv output value) over
its device time in the trace. Bytes follow the launches seen: each
batch's launches cover every conv of the program once."""

from benchmark import counts


def read(run):
    seconds, launches = run.kernel_seconds("conv_epilogue_kernel")
    if not launches:
        return None
    per_image, per_batch = counts.conv_epilogue_bytes(
        run.cell.config, run.cell.config["input"],
        run.ini("detect.fuse_stem", "off") != "off")
    images = launches / per_batch * run.cell.mix["batch"]
    return 100.0 * images * per_image / counts.HBM_BYTES_PER_S / seconds
