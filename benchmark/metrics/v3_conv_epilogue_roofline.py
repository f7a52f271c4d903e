"""``conv_epilogue_kernel`` at YOLOv3's shapes: the least time its bytes
take at HBM bandwidth (2 B read, 2 B written a value of each conv that no
shortcut follows) over its device time in the trace. Bytes follow the
launches seen: each batch's launches cover every such conv once."""

from benchmark import counts_v3


def read(run):
    seconds, launches = run.kernel_seconds("conv_epilogue_kernel")
    if not launches:
        return None
    cfg = run.cell.config
    per_image, per_batch = counts_v3.epilogue_bytes(cfg, cfg["input"], False)
    images = launches / per_batch * run.cell.mix["batch"]
    return 100.0 * images * per_image / counts_v3.HBM_BYTES_PER_S / seconds
