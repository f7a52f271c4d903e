"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file under ``yolojax_torch/csrc/`` with a plain
C interface. It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under ``build/yolojax_torch/`` at first use and loaded with
``ctypes``; no PyTorch headers are involved, so a build takes seconds. The
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. A kernel's
own extra flags (``nms_greedy`` needs ``-fmad=false``) are passed by its
wrapper and are part of that hash.

This module imports nothing from CUDA: the CPU tests import it freely.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yolojax_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str        # nvcc's output (with -Xptxas -v: registers, smem)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the port's "
        "CUDA kernels are built from yolojax_torch/csrc at first use")


def build(name: str, flags: Sequence[str] = (), *,
          verbose: bool = False) -> BuildResult:
    """Compile ``csrc/<name>.cu`` with :data:`NVCC_FLAGS` plus the kernel's
    own ``flags`` unless that library is already built. ``verbose`` adds
    ``-Xptxas -v`` (the flag is not part of the hash)."""
    src = CSRC / f"{name}.cu"
    flags = (*NVCC_FLAGS, *flags)
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return BuildResult(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial .so
    return BuildResult(out, seconds, log)


@functools.lru_cache(maxsize=None)
def load(name: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library ``name`` built with ``flags``, built if needed,
    loaded once."""
    return ctypes.CDLL(str(build(name, flags).path))
