"""Weight loading for the inference CLIs (port of
``yolojax/utils/restore.py``).

This slice reads the ``.npz`` store (``convert/store.py``). The other
sources yolojax accepts raise :class:`NotImplementedError` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import logging
import os

from yolojax_torch.convert.store import load_network_npz
from yolojax_torch.models import Model
from yolojax_torch.nn.layers import Network

log = logging.getLogger(__name__)


def load_weights(path: str, model: Model) -> Network:
    """Return a CPU :class:`Network` for ``model`` from ``path``."""
    if path.endswith(".npz"):
        log.info("loading npz params: %s", path)
        return load_network_npz(path, model)
    if path.endswith(".weights"):
        raise NotImplementedError(
            "Darknet .weights import is not ported yet (ROADMAP queue 1, "
            "converters); convert to .npz with the yolojax package")
    if os.path.isdir(path):
        raise NotImplementedError(
            "Orbax checkpoint directories are not ported yet (ROADMAP "
            "queue 1, checkpoint and host data)")
    if os.path.exists(path + ".index") or ".ckpt" in os.path.basename(path):
        raise NotImplementedError(
            "TF1 checkpoint import is not ported yet (ROADMAP queue 1, "
            "converters)")
    raise ValueError(f"unrecognized weights source: {path}")
