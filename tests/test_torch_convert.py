"""Weights interchange between yolojax and the port: the .npz store, the
pytree <-> Network conversion and the BN fold, all bit-exact."""

import jax
import numpy as np
import pytest

from yolojax.convert import store as jax_store
from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.models import get_model as jax_get_model
from yolojax_torch.convert import store
from yolojax_torch.convert.fold import fold_bn
from yolojax_torch.convert.interchange import params_from_jax, params_to_jax
from yolojax_torch.models import get_model

from .test_torch_layers import random_jax_weights

MODELS = [("yolo2", "darknet", 64), ("yolo2", "tiny", 64),
          ("yolo", "tiny", 64), ("yolo", "yolo", 64)]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name,inference,dim", MODELS)
def test_params_round_trip_exact(name, inference, dim):
    params, state = random_jax_weights(jax_get_model(name, inference, 20),
                                       dim, seed=5)
    tm = get_model(name, inference, 20)
    back_params, back_state = params_to_jax(
        tm, params_from_jax(tm, params, state))
    assert_trees_equal(back_params, params)
    assert_trees_equal(back_state, state)


def test_npz_from_yolojax_loads_and_saves_back(tmp_path):
    jm = jax_get_model("yolo2", "darknet", 20)
    params, state = random_jax_weights(jm, 64, seed=6)
    src, dst = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_store.save_params_npz(src, params, state)
    tm = get_model("yolo2", "darknet", 20)
    net = store.load_network_npz(src, tm)
    assert tuple(net.conv_0.w.shape) == (32, 3, 3, 3)  # OIHW
    store.save_network_npz(dst, tm, net)
    with np.load(src) as a, np.load(dst) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    # and yolojax reads the port's file back to the same pytrees
    assert_trees_equal(jax_store.load_params_npz(dst)[0], params)


@pytest.mark.parametrize("name,inference", [("yolo2", "darknet"),
                                            ("yolo2", "tiny")])
def test_fold_bn_bit_identical(name, inference):
    jm = jax_get_model(name, inference, 20)
    params, state = random_jax_weights(jm, 64, seed=7)
    jm_f, want_params, want_state = jax_fold_bn(jm, params, state)
    tm = get_model(name, inference, 20)
    tm_f, net_f = fold_bn(tm, params_from_jax(tm, params, state))
    assert [type(s).__name__ for s in tm_f.specs] == \
        [type(s).__name__ for s in jm_f.specs]
    assert all(getattr(s, "bn", False) is False for s in tm_f.specs)
    got_params, got_state = params_to_jax(tm_f, net_f)
    assert_trees_equal(got_params, jax.tree_util.tree_map(np.asarray,
                                                          want_params))
    assert got_state == want_state == {}
