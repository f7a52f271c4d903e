"""``python -m yolojax_torch.cli.qat`` on the CPU: a fine-tune on a
synthetic cache (detection loss with the augmentation, then ``--distill
--no-augment``) in a process where jax and yolojax cannot be imported,
its ``.npz`` scored by the port's int8 ``cli.eval`` and loaded by
yolojax; and the runs the CLI refuses."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from yolojax.convert.fold import fold_bn as jax_fold_bn
from yolojax.convert.store import load_params_npz as jax_load_npz
from yolojax.models import get_model as jax_get_model
from yolojax_torch.cli import qat as qat_cli
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data.cache import build_cache
from yolojax_torch.models import get_model
from yolojax_torch.quantize.qat import QatConfig

from .util import write_learnable_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 64


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Eight learnable VOC images cached as ``train`` and ``test``, a
    seeded tiny-v2 ``.npz`` (random BN statistics) and an INI for both."""
    tmp = tmp_path_factory.mktemp("qat")
    voc = str(tmp / "voc")
    write_learnable_voc(voc, n_images=8, size=DIM, seed=3)
    for phase, image_set in (("train", "trainval"), ("test", "trainval")):
        build_cache(str(tmp / "cache"), phase,
                    [{"kind": "voc", "root": voc, "image_set": image_set}])
    model = get_model("yolo2", "tiny", 20)
    gen = torch.Generator().manual_seed(8)
    net = model.init(gen, DIM)
    with torch.no_grad():
        for layer in net.children():
            if hasattr(layer, "mean"):
                layer.mean.normal_(0.0, 0.1, generator=gen)
                layer.var.uniform_(0.5, 1.5, generator=gen)
    npz = str(tmp / "w.npz")
    save_network_npz(npz, model, net)
    ini = tmp / "qat.ini"
    ini.write_text(
        "[model]\nmodel = yolo2\ninference = tiny\n"
        f"dim = {DIM}\nnames_file = {REPO}/config/names/voc.txt\n"
        f"[cache]\nbasedir = {tmp / 'cache'}\n"
        f"[queue]\nbatch_size = 4\ncanvas_dim = {DIM}\nmax_boxes = 8\n"
        "num_threads = 2\n[train]\nsummary_steps = 1\n"
        "[eval]\nbatch_size = 4\n")
    return {"tmp": tmp, "npz": npz, "ini": str(ini)}


def test_qat_cli_without_jax(workspace):
    """Three detection-loss steps with the augmentation and two distill
    steps without it, then ``cli.eval detect.use_int8=1`` on the first
    output, all in one process with jax and yolojax blocked. Each ``.npz``
    is an identity-BN store that yolojax loads and folds back to finite
    weights of the registry's layout."""
    tmp, ini, npz = workspace["tmp"], workspace["ini"], workspace["npz"]
    out_a, out_b = str(tmp / "qat.npz"), str(tmp / "distill.npz")
    runs = [
        ("qat", ["--weights", npz, "--output", out_a, "--steps", "3",
                 "--lr", "1e-4"]),
        ("qat", ["--weights", npz, "--output", out_b, "--steps", "2",
                 "--distill", "--no-augment"]),
        ("eval", ["--weights", out_a, "detect.use_int8=1"]),
    ]
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["yolojax"] = None
        for mod, extra in {runs!r}:
            sys.argv = [mod, "-c", {ini!r}, "--device", "cpu", *extra]
            runpy.run_module("yolojax_torch.cli." + mod, run_name="__main__")
        loaded = [m for m in sys.modules if sys.modules[m] is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "yolojax")]
        assert not loaded, loaded
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    log = proc.stderr
    assert log.count("qat step 1/") == 2 and "qat step 3/3 loss" in log
    assert log.count("QAT done") == 2
    assert "calibrated on 4 images (percentile 100, 8-bit grid)" in log
    metrics = json.loads(proc.stdout.splitlines()[-1])
    assert metrics["num_images"] == 8 and 0.0 <= metrics["map"] <= 1.0
    jm = jax_get_model("yolo2", "tiny", 20)
    for path in (out_a, out_b):
        with np.load(npz) as want, np.load(path) as got:
            assert sorted(got.files) == sorted(want.files)
        params, state = jax_load_npz(path)
        for name, st in state.items():
            np.testing.assert_array_equal(st["mean"], 0.0)
            np.testing.assert_array_equal(
                st["var"], np.float32(1.0 - 1e-5))
            np.testing.assert_array_equal(params[name]["scale"], 1.0)
        _, folded, _ = jax_fold_bn(jm, params, state)
        assert all(np.isfinite(np.asarray(v)).all()
                   for v in jax.tree_util.tree_leaves(folded))


@pytest.mark.parametrize("case", ["bits", "grain", "non-finite"])
def test_qat_cli_refusals(workspace, case):
    """``--bits`` outside [2, 8] is refused before any step; a loss that
    goes non-finite ends the run with SystemExit and writes no ``.npz``.
    ``queue.loader=grain``, once refused, now reads the train cache through
    the grain loader and must write the ``.npz`` (the test keeps its name
    so each case keeps its identity)."""
    out = str(workspace["tmp"] / f"refused_{case}.npz")
    overrides = ["queue.loader=grain"] if case == "grain" else []
    cfg = load_config([workspace["ini"]], overrides)
    kw = dict(device="cpu", augment=False)
    if case == "bits":
        with pytest.raises(SystemExit, match="--bits must be in"):
            qat_cli.run_qat(cfg, workspace["npz"], out, QatConfig(steps=1),
                            bits=9, **kw)
    elif case == "grain":
        first, last = qat_cli.run_qat(cfg, workspace["npz"], out,
                                      QatConfig(steps=1), **kw)
        assert np.isfinite([first, last]).all() and os.path.exists(out)
        return
    else:
        with pytest.raises(SystemExit, match="non-finite QAT loss at step"):
            qat_cli.run_qat(cfg, workspace["npz"], out,
                            QatConfig(steps=4, learning_rate=1e30,
                                      grad_clip_norm=0.0), **kw)
    assert not os.path.exists(out)
