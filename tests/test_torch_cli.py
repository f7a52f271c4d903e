"""The port's detect CLI: ``python -m yolojax_torch.cli.detect`` end to end
on the CPU with jax blocked, the settings it does not port yet (or that do
not apply to the weights given), which raise instead of being ignored, and
the int8 and ``--stdin`` paths, which once raised and now run."""

import dataclasses
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yolojax_torch.cli import detect
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.models import get_model
from yolojax_torch.nn.layers import ConvSpec
from yolojax_torch.utils.restore import load_weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    model = get_model("yolo2", "tiny", 20)
    npz = str(tmp / "tiny.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(3),
                                            64))
    ini = tmp / "tiny.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n"
                   f"names_file = {REPO}/config/names/voc.txt\n"
                   "[detect]\nthreshold = 0.005\n")
    return str(ini), npz, tmp


def test_detect_module_entry_point(tiny_setup):
    import cv2

    ini, npz, tmp = tiny_setup
    img = str(tmp / "a.png")
    out = str(tmp / "a_det.png")
    cv2.imwrite(img, np.random.RandomState(4).randint(0, 256, (90, 120, 3),
                                                      np.uint8))
    argv = ["detect", "-c", ini, "--weights", npz, "--image", img,
            "--out", out, "--device", "cpu"]
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["yolojax"] = None
        sys.argv = {argv!r}
        runpy.run_module("yolojax_torch.cli.detect", run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines and all(line.startswith("a.png: ") for line in lines)
    assert cv2.imread(out).shape == (90, 120, 3)


@pytest.mark.parametrize("overrides,error,match", [
    # the int8 trunk, calibrated on the given canvas: the path runs
    (["detect.use_int8=1"], None, None),
    # EMA weights live in training checkpoints, never in a weights file
    (["detect.use_ema=1"], ValueError, "use_ema needs a checkpoint dir"),
    (["detect.use_int8=1", "detect.fuse_stem=xla"],  # the int8 fused stem
     None, None),
], ids=["detect.use_int8=1", "detect.use_ema=1", "detect.fuse_stem=xla"])
def test_unported_detect_settings_raise(tiny_setup, overrides, error, match):
    """Each case of a setting the detect CLI once refused: ``use_ema`` on
    a weights file still raises, and the int8 cases (``error`` None) now
    build, serve and must not raise; the test keeps its name so each case
    keeps its identity. Their parity with yolojax is in
    tests/test_torch_int8_serving.py."""
    ini, npz, _ = tiny_setup
    cfg = load_config([ini], overrides)
    if error is not None:
        with pytest.raises(error, match=match):
            detect.build_detector(cfg, npz, device="cpu")
        return
    x = np.random.RandomState(6).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    out = detect.build_detector(cfg, npz, list(x[:1]), device="cpu")[2](x)
    assert out["keep"].shape == (2, cfg.detect.top_k)
    assert np.isfinite(out["scores"]).all() and out["keep"].any()
    if "detect.fuse_stem=xla" in overrides:  # the int8 stem is bit-exact
        cfg = load_config([ini], ["detect.use_int8=1"])
        ref = detect.build_detector(cfg, npz, list(x[:1]), device="cpu")[2](x)
        for key in ref:
            np.testing.assert_array_equal(out[key], ref[key])


@pytest.mark.parametrize("impl", ["xla", "pallas", "auto"])
def test_detect_fuse_stem(tiny_setup, impl):
    """detect.fuse_stem: the packed conv (xla) or, on the CPU, the plain
    version of the stem kernel (pallas, auto); the detections agree with
    the unfused program within the stem's bf16 rounding."""
    ini, npz, _ = tiny_setup
    x = np.random.RandomState(5).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    outs = {}
    for fuse in ("off", impl):
        cfg = load_config([ini], [f"detect.fuse_stem={fuse}"])
        _, _, infer_fn, net, _ = detect.build_serving(cfg, npz, device="cpu")
        assert (type(net.conv_0).__name__ == "StemLayer") == (fuse != "off")
        with torch.no_grad():
            outs[fuse] = infer_fn(net, torch.from_numpy(x))
    tol = 1e-5 if impl == "xla" else 3e-2
    np.testing.assert_allclose(outs[impl]["scores"], outs["off"]["scores"],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("flag", [["--artifact", "m.yjts"], ["--stdin"],
                                  ["--data-parallel"]])
def test_unported_detect_flags_raise(tiny_setup, monkeypatch, capsys, flag):
    """Each case of a flag the detect CLI once refused: --data-parallel
    runs on the one device (with a warning) and must print what the plain
    run prints; --stdin runs and must serve the paths it reads,
    answering an unreadable one in order; --artifact runs and must print
    what --weights prints for the same program (a CPU artifact exported
    from the same weights). The test keeps its name so each case keeps its
    identity; tests/test_torch_serve_cli.py covers the artifact paths."""
    import cv2

    ini, npz, tmp = tiny_setup
    if flag[0] == "--artifact":
        from yolojax_torch.serve import save_artifact

        img = str(tmp / "art.png")
        cv2.imwrite(img, np.random.RandomState(8).randint(
            0, 256, (50, 70, 3), np.uint8))
        cfg = load_config([ini])
        names, dim, infer_fn, net, dev = detect.build_serving(
            cfg, npz, device="cpu")
        art = str(tmp / flag[1])
        save_artifact(art, infer_fn, net, batch=1, dim=dim,
                      meta={"names": list(names), "stretch": False},
                      device=dev)
        printed = []
        for source in (["--weights", npz], ["--artifact", art]):
            monkeypatch.setattr(sys, "argv", ["detect", "-c", ini, *source,
                                              "--image", img, "--device",
                                              "cpu"])
            detect.main()
            printed.append(capsys.readouterr().out)
        assert printed[1] == printed[0] and printed[0].startswith("art.png: ")
        return
    if flag == ["--stdin"]:
        img = str(tmp / "s.png")
        cv2.imwrite(img, np.random.RandomState(7).randint(
            0, 256, (50, 70, 3), np.uint8))
        monkeypatch.setattr(sys, "stdin", io.StringIO(
            f"{img}\n{tmp / 'missing.png'}\n"))
        monkeypatch.setattr(sys, "argv", ["detect", "-c", ini, "--weights",
                                          npz, "--device", "cpu", *flag])
        detect.main()
        blocks = capsys.readouterr().out.split("\n\n")
        assert blocks[0] and all(line.startswith("s.png: ")
                                 for line in blocks[0].splitlines())
        assert blocks[1] == "missing.png: ERROR unreadable"
        return
    images = []
    for i in range(2):
        images += ["--image", str(tmp / f"dp{i}.png")]
        cv2.imwrite(images[-1], np.random.RandomState(20 + i).randint(
            0, 256, (50, 70, 3), np.uint8))
    printed = []
    for extra in ([], flag):
        monkeypatch.setattr(sys, "argv", ["detect", "-c", ini, "--weights",
                                          npz, "--device", "cpu", *images,
                                          "detect.threshold=0.005", *extra])
        detect.main()
        printed.append(capsys.readouterr().out)
    assert printed[0].startswith("dp0.png: ") and printed[1] == printed[0]


def test_unported_weight_sources_raise(tmp_path):
    """The weight sources that once raised now load: a Darknet ``.weights``
    file and a TF1 checkpoint prefix give the network they were written
    from. An empty directory and an unknown file still raise."""
    from yolojax_torch.convert.darknet import save_darknet_weights

    model = get_model("yolo2", "tiny", 20)
    net = model.init(torch.Generator().manual_seed(5), 64)
    weights = str(tmp_path / "w.weights")
    save_darknet_weights(model, net, weights)
    want = net.state_dict()
    got = load_weights(weights, model, 64).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    tf = pytest.importorskip("tensorflow")
    # a one-conv TF1 checkpoint: HWIO kernel and biases, slim names
    tiny = dataclasses.replace(model, specs=(ConvSpec(4, 3, bn=False),))
    rng = np.random.RandomState(1)
    w_hwio = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    graph = tf.Graph()
    with graph.as_default():
        tf.compat.v1.get_variable("net/Conv/weights",
                                  initializer=tf.constant(w_hwio))
        tf.compat.v1.get_variable("net/Conv/biases", initializer=tf.constant(b))
        with tf.compat.v1.Session(graph=graph) as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = tf.compat.v1.train.Saver().save(
                sess, str(tmp_path / "model.ckpt-1000"))
    tf1 = load_weights(prefix, tiny, 64)
    assert torch.equal(tf1.conv_0.w,
                       torch.from_numpy(w_hwio).permute(3, 2, 0, 1))
    assert torch.equal(tf1.conv_0.b, torch.from_numpy(b))
    # a directory is a training checkpoint dir (ported); this one has none
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        load_weights(str(tmp_path), model)
    with pytest.raises(ValueError, match="unrecognized"):
        load_weights(str(tmp_path / "w.bin"), model)
