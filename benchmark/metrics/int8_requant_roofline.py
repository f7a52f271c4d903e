"""``int8_requant`` (``quantize/cuda_int8.py``): the least time its bytes
take at HBM bandwidth (4 B read an int32 sum, 1 B written a code) over
its device time in the trace."""

from benchmark import counts


def read(run):
    seconds, launches = run.kernel_seconds("int8_requant_kernel")
    if not launches:
        return None
    per_image, per_batch = counts.int8_requant_bytes(
        run.cell.config, run.cell.config["input"],
        run.ini("detect.fuse_stem", "off") != "off")
    images = launches / per_batch * run.cell.mix["batch"]
    return 100.0 * images * per_image / counts.HBM_BYTES_PER_S / seconds
