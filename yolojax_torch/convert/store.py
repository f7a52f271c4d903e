"""Flat .npz store, the same layout as ``yolojax/convert/store.py``.

Keys are '/'-joined pytree paths, with params under 'params/' (conv
kernels HWIO) and BN state under 'state/'. A file written by either
package loads in the other. :func:`load_network_npz` and
:func:`save_network_npz` go through ``convert/interchange.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from yolojax_torch.convert.interchange import params_from_jax, params_to_jax


def _flatten(prefix: str, tree: Dict[str, Any], out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(key, v, out)
        else:
            out[key] = np.asarray(v)


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_params_npz(path: str, params: Any, bn_state: Any) -> None:
    flat: Dict[str, np.ndarray] = {}
    _flatten("params", params, flat)
    _flatten("state", bn_state, flat)
    np.savez(path, **flat)


def load_params_npz(path: str) -> Tuple[Any, Any]:
    with np.load(path, allow_pickle=False) as z:
        tree = _unflatten({k: z[k] for k in z.files})
    return tree.get("params", {}), tree.get("state", {})


def save_network_npz(path: str, model, net) -> None:
    save_params_npz(path, *params_to_jax(model, net))


def load_network_npz(path: str, model):
    """-> a CPU :class:`~yolojax_torch.nn.layers.Network` for ``model``."""
    return params_from_jax(model, *load_params_npz(path))
