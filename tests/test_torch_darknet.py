"""The port's weight converters against yolojax's on the same numpy-seeded
weights: Darknet ``.weights`` read and written (``convert/darknet.py``),
Darknet ``.cfg`` parsing (``convert/cfg.py``), TF1 checkpoints
(``convert/tf1.py``), the weight sources of ``utils/restore.py`` and the
``cli.parse_darknet`` converter."""

import contextlib
import dataclasses
import io
import logging
import os
import sys

import numpy as np
import pytest
import torch

from yolojax.convert import cfg as jax_cfg
from yolojax.convert import darknet as jax_darknet
from yolojax.models import Model as JaxModel
from yolojax.models import get_model as jax_get_model
from yolojax.nn import layers as jax_layers
from yolojax_torch.convert import cfg as port_cfg
from yolojax_torch.convert.darknet import (
    load_darknet_weights,
    read_darknet_header,
    save_darknet_weights,
)
from yolojax_torch.convert.interchange import params_from_jax
from yolojax_torch.models import Model, get_model
from yolojax_torch.nn import layers
from yolojax_torch.utils.restore import load_weights

from .parity.test_cfg import TINY_YOLO_VOC_CFG, YOLO_VOC_CFG
from .test_torch_layers import random_jax_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REGISTRY = [("yolo", "yolo"), ("yolo", "tiny"), ("yolo2", "darknet"),
            ("yolo2", "tiny")]
# a v1 cfg with a route, dropout and two [connected] layers: the flatten
# the parser inserts shifts the later spec indices
V1_CFG = """
[net]
height=64
width=64
[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky
[maxpool]
size=2
stride=2
[convolutional]
filters=6
size=1
stride=1
pad=1
activation=leaky
[route]
layers=-1,-3
[connected]
output=32
activation=leaky
[dropout]
probability=.5
[connected]
output=98
activation=linear
[detection]
classes=4
side=7
num=1
"""


def _state(net):
    return {k: v.clone() for k, v in net.state_dict().items()}


def _assert_nets_equal(got, want):
    a, b = _state(got), _state(want)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _specs(model):
    """Specs comparable across the two packages' dataclasses."""
    return [(type(s).__name__, dataclasses.asdict(s)) for s in model.specs]


def _write_cfg(tmp_path, text, name="m.cfg"):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _model_pair(which, tmp_path):
    """(port model, yolojax model) for a registry key or a cfg text."""
    if isinstance(which, tuple):
        return get_model(*which, 20), jax_get_model(*which, 20)
    path = _write_cfg(tmp_path, which)
    return port_cfg.model_from_cfg(path), jax_cfg.model_from_cfg(path)


MODELS = REGISTRY + [TINY_YOLO_VOC_CFG]
MODEL_IDS = [".".join(k) for k in REGISTRY] + ["tiny-yolo-voc.cfg"]


@pytest.mark.parametrize("which", MODELS, ids=MODEL_IDS)
def test_yolojax_weights_load_bit_equal(which, tmp_path):
    """A ``.weights`` file yolojax writes loads in the port equal to
    ``params_from_jax`` of the same numpy weights; the port writes the
    same file byte for byte."""
    model, jmodel = _model_pair(which, tmp_path)
    dim = 64
    params, state = random_jax_weights(jmodel, dim, seed=11)
    path = str(tmp_path / "y.weights")
    jax_darknet.save_darknet_weights(jmodel, params, state, path, seen=321)
    net = load_darknet_weights(model, path, input_dim=dim)
    want = params_from_jax(model, params, state)
    _assert_nets_equal(net, want)
    mine = str(tmp_path / "p.weights")
    save_darknet_weights(model, want, mine, seen=321)
    with open(path, "rb") as f, open(mine, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("version", [(0, 1, 0), (0, 2, 0), (1, 0, 3)])
def test_header_versions_round_trip(version, tmp_path):
    """``seen`` is an int32 before version 0.2 and an int64 from it on;
    reading the header back and writing again gives the same bytes, and
    yolojax reads the port's file."""
    model, jmodel = _micro("v1")
    net = params_from_jax(model, *random_jax_weights(jmodel, 12, seed=2))
    path = str(tmp_path / "a.weights")
    seen = 2**33 + 5 if version[0] * 10 + version[1] >= 2 else 77
    save_darknet_weights(model, net, path, seen=seen, version=version)
    major, minor, revision, got_seen = read_darknet_header(path)
    assert ((major, minor, revision), got_seen) == (version, seen)
    size = os.path.getsize(path)
    n = sum(t.numel() for t in net.state_dict().values())
    assert size == 12 + (8 if seen > 77 else 4) + 4 * n
    again = str(tmp_path / "b.weights")
    save_darknet_weights(model, load_darknet_weights(model, path,
                                                     input_dim=12),
                         again, seen=got_seen, version=(major, minor, revision))
    with open(path, "rb") as f, open(again, "rb") as g:
        assert f.read() == g.read()
    params, state = jax_darknet.load_darknet_weights(jmodel, path,
                                                     input_dim=12)
    _assert_nets_equal(params_from_jax(model, params, state), net)


def test_short_file_and_extra_floats(tmp_path, caplog):
    model, jmodel = _micro("v2")
    net = model.init(torch.Generator().manual_seed(0), 32)
    path = str(tmp_path / "a.weights")
    save_darknet_weights(model, net, path)
    data = open(path, "rb").read()
    short = str(tmp_path / "short.weights")
    open(short, "wb").write(data[:-4 * 10])
    with pytest.raises(ValueError, match="weights file exhausted") as err:
        load_darknet_weights(model, short)
    with pytest.raises(ValueError) as jerr:
        jax_darknet.load_darknet_weights(jmodel, short)
    assert str(err.value) == str(jerr.value)
    extra = str(tmp_path / "extra.weights")
    open(extra, "wb").write(data + np.zeros(7, np.float32).tobytes())
    with caplog.at_level(logging.WARNING):
        got = load_darknet_weights(model, extra)
    assert "7 unread floats" in caplog.text
    _assert_nets_equal(got, net)


@pytest.mark.parametrize("which,dim", [
    (("yolo", "yolo"), 448), (("yolo", "yolo"), 96), (("yolo", "tiny"), 448),
    (("yolo2", "darknet"), 416), (("yolo2", "tiny"), 416),
    (V1_CFG, 64)], ids=["yolo.yolo@448", "yolo.yolo@96", "yolo.tiny@448",
                        "yolo2.darknet@416", "yolo2.tiny@416", "v1.cfg@64"])
def test_weight_shapes_walk(which, dim, tmp_path):
    """The shape walk the loaders use needs no network: it equals
    ``Model.init``'s kernel shapes, and (transposed) yolojax's
    ``init`` shapes, a v1 dense layer's input included."""
    import jax

    model, jmodel = _model_pair(which, tmp_path)
    got = layers.weight_shapes(model.specs, 3, (dim, dim))
    net = model.init(torch.Generator().manual_seed(0), dim)
    assert got == {k[:-2]: tuple(v.shape) for k, v in net.state_dict().items()
                   if k.endswith(".w")}
    jparams, _ = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                    dim))
    want = {k: (v["w"].shape[::-1] if k.startswith("dense") else
                tuple(np.array(v["w"].shape)[[3, 2, 0, 1]]))
            for k, v in jparams.items()}
    assert got == want


@pytest.mark.parametrize("text,registry", [
    (YOLO_VOC_CFG, ("yolo2", "darknet")), (TINY_YOLO_VOC_CFG, ("yolo2", "tiny")),
    (V1_CFG, None)], ids=["yolo-voc.cfg", "tiny-yolo-voc.cfg", "v1.cfg"])
def test_cfg_models_equal_yolojax(text, registry, tmp_path):
    """The official cfgs parse to yolojax's specs field by field (routes
    absolute) and to the port's registry model; the v1 cfg's flatten
    shifts the route remap and the dense layers as yolojax's does."""
    path = _write_cfg(tmp_path, text)
    got, want = port_cfg.model_from_cfg(path), jax_cfg.model_from_cfg(path)
    assert _specs(got) == _specs(want)
    for field in ("name", "inference", "kind", "num_classes", "downsample",
                  "anchors", "boxes_per_cell", "grid"):
        assert getattr(got, field) == getattr(want, field), field
    assert port_cfg.parse_cfg_sections(path) == jax_cfg.parse_cfg_sections(
        path)
    if registry is not None:
        ref = get_model(*registry, 20)
        assert got.anchors == ref.anchors and got.downsample == 32
        abs_routes = [
            layers.RouteSpec(tuple(r if r >= 0 else i + r for r in s.layers))
            if isinstance(s, layers.RouteSpec) else s
            for i, s in enumerate(ref.specs)]
        assert list(got.specs) == abs_routes
    else:
        names = [type(s).__name__ for s in got.specs]
        assert names == ["ConvSpec", "MaxPoolSpec", "ConvSpec", "RouteSpec",
                         "FlattenSpec", "DenseSpec", "DropoutSpec",
                         "DenseSpec"]
        assert got.specs[3] == layers.RouteSpec((2, 0))
        assert (got.kind, got.grid, got.downsample) == ("v1", 7, 64 // 7)


@pytest.mark.parametrize("text,match", [
    ("[net]\nheight=64\nwidth=64\n[local]\nsize=3\n", "local"),
    ("[net]\nheight=64\n[convolutional]\nfilters=8\nsize=3\npad=1\n"
     "activation=leaky\n", "region"),
    ("[net]\nheight=64\nwidth=64\n[convolutional]\nfilters=8\nsize=3\npad=1\n"
     "activation=leaky\n[region]\nnum=5\nclasses=20\nanchors=1.0,1.0 2.0,2.0\n",
     "anchor"),
    ("[net]\n[convolutional]\nfilters=8\nsize=3\npad=0\npadding=0\n"
     "activation=leaky\n[region]\n", "padding"),
    ("[net]\n[convolutional]\nfilters=8\nsize=3\npad=1\nactivation=mish\n",
     "activation"),
    ("[net]\n[gru]\noutput=64\n", "unknown cfg section"),
    ("[convolutional]\nfilters=8\n", r"\[net\]"),
], ids=["local", "no-head", "short-anchors", "padding", "activation",
        "unknown-section", "no-net"])
def test_cfg_errors_match_yolojax(text, match, tmp_path):
    path = _write_cfg(tmp_path, text)
    with pytest.raises(ValueError, match=match) as err:
        port_cfg.model_from_cfg(path)
    with pytest.raises(ValueError) as jerr:
        jax_cfg.model_from_cfg(path)
    assert str(err.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# TF1 checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def _micro(kind):
    """(port model, yolojax model): ``micro_v2`` of
    tests/parity/test_convert.py, or a v1 micro model whose first dense
    layer follows a flatten of a 3x3x5 map."""
    if kind == "v2":
        def specs(m):
            return (m.ConvSpec(8, 3), m.MaxPoolSpec(), m.ConvSpec(12, 3),
                    m.ConvSpec(10, 1, bn=False, act="linear"))
        args = dict(anchors=((1.0, 1.0), (2.0, 2.0)))
        head = ("yolo2", "micro", "v2")
    else:
        def specs(m):
            return (m.ConvSpec(6, 3), m.MaxPoolSpec(),
                    m.ConvSpec(5, 3, stride=2, bn=False), m.FlattenSpec(),
                    m.DenseSpec(16), m.DenseSpec(10, act="linear"))
        args = dict(boxes_per_cell=1, grid=1)
        head = ("yolo", "micro", "v1")
    return (Model(*head, specs(layers), 0 if kind == "v2" else 1, 4, **args),
            JaxModel(*head, specs(jax_layers), 0 if kind == "v2" else 1, 4,
                     **args))


def _slim_checkpoint(tf, model, dim, path, seed):
    """A slim-named TF1 checkpoint (convs ``net/Conv``, ``net/Conv_1``, ...
    as tests/parity/test_convert.py names them, dense layers
    ``net/fc_<k>``; ``.../weights``, ``.../BatchNorm/gamma`` ...,
    ``.../biases``) of numpy-seeded values for ``model``, with an optimizer
    slot that must be skipped. Returns the prefix and the layer scopes in
    order."""
    import jax

    jparams, _ = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                   dim))
    rng = np.random.RandomState(seed)
    scopes = []
    g = tf.Graph()
    with g.as_default():
        def var(name, shape):
            value = rng.normal(size=shape).astype(np.float32)
            tf.compat.v1.get_variable(name, initializer=tf.constant(value))

        for i, spec in enumerate(model.specs):
            if not isinstance(spec, (jax_layers.ConvSpec,
                                     jax_layers.DenseSpec)):
                continue
            k = len(scopes)
            if isinstance(spec, jax_layers.ConvSpec):
                base, name = "net/Conv" + (f"_{k}" if k else ""), f"conv_{i}"
            else:
                base, name = f"net/fc_{k}", f"dense_{i}"
            scopes.append(base)
            var(base + "/weights", jparams[name]["w"].shape)
            if getattr(spec, "bn", False):
                for suf in ("gamma", "beta", "moving_mean",
                            "moving_variance"):
                    var(f"{base}/BatchNorm/{suf}", (spec.out,))
                var(base + "/weights/Momentum", (1,))
            else:
                var(base + "/biases", (spec.out,))
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session(graph=g) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = saver.save(sess, path)
    return prefix, scopes


@pytest.mark.parametrize("kind,dim", [("v2", 32), ("v1", 12)])
def test_tf1_checkpoint_equal_to_yolojax(tf, kind, dim, tmp_path):
    """A slim TF1 checkpoint loads in the port equal to yolojax's load
    (HWIO kernels to OIHW; the v1 dense kernel after the flatten permuted
    from the NHWC to the NCHW flatten); ``name_map`` gives the same."""
    from yolojax.convert.tf1 import load_tf1_checkpoint as jax_load_tf1
    from yolojax_torch.convert.tf1 import load_tf1_checkpoint

    model, jmodel = _micro(kind)
    prefix, scopes = _slim_checkpoint(tf, jmodel, dim,
                                      str(tmp_path / "model.ckpt"), seed=7)
    net = load_tf1_checkpoint(model, prefix, input_dim=dim)
    want = params_from_jax(model, *jax_load_tf1(jmodel, prefix,
                                                input_dim=dim))
    _assert_nets_equal(net, want)
    w0 = tf.train.load_checkpoint(prefix).get_tensor(scopes[0] + "/weights")
    assert torch.equal(net.conv_0.w, torch.from_numpy(w0).permute(3, 2, 0, 1))
    _assert_nets_equal(load_tf1_checkpoint(model, prefix, input_dim=dim,
                                           name_map=scopes), want)
    with pytest.raises(ValueError, match="parameterized layers"):
        load_tf1_checkpoint(model, prefix, input_dim=dim,
                            name_map=scopes[:-1])


# ---------------------------------------------------------------------------
# restore and the parse_darknet CLI
# ---------------------------------------------------------------------------


def test_restore_reads_weights_and_tf1(tf, tmp_path):
    """``load_weights`` takes a ``.weights`` file (``input_dim`` sizing a
    v1 flatten) and a TF1 prefix, as yolojax's does."""
    from yolojax.convert.tf1 import load_tf1_checkpoint as jax_load_tf1

    model, jmodel = _micro("v1")
    params, state = random_jax_weights(jmodel, 12, seed=5)
    path = str(tmp_path / "v1.weights")
    jax_darknet.save_darknet_weights(jmodel, params, state, path)
    _assert_nets_equal(load_weights(path, model, 12),
                       params_from_jax(model, params, state))
    with pytest.raises(ValueError, match="exhausted"):
        load_weights(path, model, 16)  # a larger flatten than the file's
    model, jmodel = _micro("v2")
    prefix, _ = _slim_checkpoint(tf, jmodel, 32, str(tmp_path / "m.ckpt"),
                                 seed=3)
    _assert_nets_equal(load_weights(prefix, model, 32), params_from_jax(
        model, *jax_load_tf1(jmodel, prefix, input_dim=32)))


def test_orbax_logdir_names_the_npz_route(tmp_path):
    """A yolojax (Orbax) logdir is refused with the route through an
    ``.npz``, not "no checkpoint found"."""
    import jax.numpy as jnp

    from yolojax.train.checkpoint import Checkpointer

    ckpt = Checkpointer(str(tmp_path / "logdir" / "ckpt"))
    ckpt.save(3, {"params": {"conv_0": {"w": jnp.ones((3, 3, 3, 4))}},
                  "bn_state": {}}, force=True)
    ckpt.close()
    model = get_model("yolo2", "tiny", 20)
    for path in (tmp_path / "logdir", tmp_path / "logdir" / "ckpt"):
        with pytest.raises(ValueError, match="save_params_npz"):
            load_weights(str(path), model)


def _run_main(main, argv):
    saved = sys.argv
    sys.argv = ["parse_darknet", *argv]
    try:
        with contextlib.redirect_stdout(io.StringIO()) as out:
            main()
    finally:
        sys.argv = saved
    return out.getvalue()


@pytest.mark.parametrize("form", ["positional", "--weights", "--tf1",
                                  "--cfg"])
def test_parse_darknet_cli_equal_to_yolojax(form, tf, tmp_path):
    """``cli.parse_darknet`` writes the ``.npz`` yolojax's
    ``cli/parse_darknet.py`` writes, array by array, and prints the same
    line."""
    from cli.parse_darknet import main as jax_main
    from yolojax_torch.cli.parse_darknet import main
    from yolojax_torch.cli.parse_darknet_yolo2 import main as alias

    assert alias is main
    ini = tmp_path / "t.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n"
                   f"names_file = {REPO}/config/names/voc.txt\n")
    jmodel = jax_get_model("yolo2", "tiny", 20)
    extra = []
    if form == "--cfg":
        cfg_path = _write_cfg(tmp_path, TINY_YOLO_VOC_CFG)
        jmodel = jax_cfg.model_from_cfg(cfg_path)
        extra = ["--cfg", cfg_path]
    if form == "--tf1":
        src, _ = _slim_checkpoint(tf, jmodel, 64, str(tmp_path / "m.ckpt"),
                                  seed=4)
        source = ["--tf1", src]
    else:
        params, state = random_jax_weights(jmodel, 64, seed=9)
        src = str(tmp_path / "w.weights")
        jax_darknet.save_darknet_weights(jmodel, params, state, src)
        source = [src] if form == "positional" else ["--weights", src]
    printed = _run_main(main, ["-c", str(ini), *source, *extra, "-o",
                               str(tmp_path / "p.npz")])
    jprinted = _run_main(jax_main, ["-c", str(ini), *source, *extra, "-o",
                                    str(tmp_path / "j.npz")])
    assert printed.replace("p.npz", "j.npz") == jprinted
    assert printed.startswith(f"converted {src} -> ")
    with np.load(tmp_path / "p.npz") as got, np.load(tmp_path / "j.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
