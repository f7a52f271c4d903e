"""The training entry point of the port on the CPU: the checkpointer
against yolojax's, the config sections against yolojax's parser, and
``python -m yolojax_torch.cli.train --device cpu`` end to end (train,
resume, in-training eval, then ``cli.eval`` / ``cli.detect`` on the logdir,
with and without the EMA weights) in a process where jax and yolojax cannot
be imported."""

import dataclasses
import glob
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from yolojax.config import load_config as jax_load_config
from yolojax.train import step as jax_step
from yolojax.train.checkpoint import Checkpointer as JaxCheckpointer
from yolojax_torch.cli import train as train_cli
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.data.cache import build_cache
from yolojax_torch.models import get_model
from yolojax_torch.train import step
from yolojax_torch.train.checkpoint import Checkpointer

from .pipeline.test_train_step import micro_model as jax_micro_model
from .test_torch_train_steps import micro_model
from .util import write_learnable_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "config", "*.ini"))) + [
    os.path.join(REPO, "config.ini")]


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def port_state(opt_cfg=step.OptimizerConfig()):
    tx = step.make_optimizer(opt_cfg)
    return step.init_train_state(micro_model(), tx,
                                 torch.Generator().manual_seed(0), 32)


def test_checkpointer_interval_and_keep_n_match_yolojax(tmp_path):
    """The same step sequence through both checkpointers: the same
    should_save answers (the first step saves, as Orbax's initial-save
    policy does), the same steps kept, the same latest step."""
    jts = jax_step.init_train_state(
        jax_micro_model(), jax_step.make_optimizer(jax_step.OptimizerConfig()),
        jax.random.PRNGKey(0), 32)
    jck = JaxCheckpointer(str(tmp_path / "jax"), max_to_keep=2,
                          save_interval_steps=3)
    tck = Checkpointer(str(tmp_path / "port"), max_to_keep=2,
                       save_interval_steps=3)
    ts = port_state()
    assert jck.latest_step() is None and tck.latest_step() is None
    answers = []
    for s in range(1, 11):
        want = jck.should_save(s)
        answers.append(want)
        assert tck.should_save(s) == want, s
        assert jck.save(s, jts) == tck.save(s, ts) == want
        jck.wait()
    assert answers == [s == 1 or s % 3 == 0 for s in range(1, 11)]
    assert jck.save(10, jts, force=True) and tck.save(10, ts, force=True)
    jck.wait()
    assert tck.steps() == sorted(jck._mgr.all_steps()) == [9, 10]
    assert tck.latest_step() == jck.latest_step() == 10
    for s, want in ((10, False), (11, False), (12, True)):
        assert tck.should_save(s) == jck.should_save(s) == want, s
    jck.close()


def test_checkpoint_round_trip_partial_dirs_and_layout_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ts = port_state(step.OptimizerConfig(optimizer="adam"))
    ts.step = 7
    ts.opt_state["count"] = 3
    with torch.no_grad():
        ts.net.conv_0.w.add_(1.0)
    assert ck.save(7, ts)
    # a half-written step (no state file, or still under its temporary
    # name) is never taken as the latest
    os.makedirs(tmp_path / "ckpt" / "20")
    os.makedirs(tmp_path / "ckpt" / ".21.tmp-1")
    torch.save({}, tmp_path / "ckpt" / ".21.tmp-1" / "state.pt")
    assert ck.latest_step() == 7
    fresh = port_state(step.OptimizerConfig(optimizer="adam"))
    got_step, got = ck.restore_latest(fresh)
    assert got_step == 7 and got.step == 7 and got.opt_state["count"] == 3
    assert torch.equal(got.net.conv_0.w, ts.net.conv_0.w)
    assert torch.equal(got.opt_state["mu"]["conv_0.w"],
                       ts.opt_state["mu"]["conv_0.w"])
    for flag, cfg in (("ema_decay", dict(ema_decay=0.9)),
                      ("grad_accum", dict(grad_accum=2))):
        with pytest.raises(RuntimeError, match=flag):
            ck.restore_latest(port_state(step.OptimizerConfig(
                optimizer="adam", **cfg)))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_parse_like_yolojax(path):
    overrides = ["summary.scalar=7", "train.gamma=0.5"]
    got = load_config([path], overrides)
    want = jax_load_config([path], overrides)
    for section in ("model", "cache", "queue", "augment", "optimizer",
                    "train", "detect", "eval"):
        assert (dataclasses.asdict(getattr(got, section))
                == dataclasses.asdict(getattr(want, section))), section
    assert got.train.summary_steps == 7 and got.optimizer.gamma == 0.5
    assert got.loss_config().__dict__ == want.loss_config().__dict__


@pytest.mark.parametrize("override", [
    "train.mesh_model=2", "train.mesh_data=2", "train.zero=1",
    "train.coordinator=localhost:1234", "queue.loader=grain",
    "train.num_processes=2", "train.profile_port=9999",
    "eval.data_parallel=on"])
def test_unported_train_settings_raise(override, workspace, tmp_path):
    """Each case of a setting the train CLI once refused (the test keeps
    its name so each case keeps its identity). In one process a mesh
    larger than its one device raises yolojax's ``make_mesh`` text, and
    ``train.profile_port`` stays refused (torch has no profiler server);
    the others must run a step and its in-training eval: ZeRO-1 without a
    data axis, a coordinator or a process count alone (no process group),
    the grain loader, and ``eval.data_parallel=on`` on one device.
    tests/test_torch_parallel_train.py runs them over two processes."""
    _, ini = workspace
    cfg = load_config([ini], [override, "train.steps=1", "train.eval_steps=1",
                              f"train.logdir={tmp_path}", "train.ema_decay=0",
                              "train.keep_checkpoints=1"])
    errors = {
        "train.mesh_model=2": (ValueError,
                               "1 devices not divisible by model=2"),
        "train.mesh_data=2": (ValueError, "mesh 2x1 needs data\\*model = 2 "
                                          "devices, have 1"),
        "train.profile_port=9999": (NotImplementedError,
                                    "train.profile_port")}
    if override in errors:
        error, match = errors[override]
        with pytest.raises(error, match=match):
            train_cli.train(cfg, device="cpu")
        return
    ts = train_cli.train(cfg, device="cpu")
    assert ts.step == 1 and ts.plan is None
    logdir = tmp_path / "yolo2_tiny"
    with open(logdir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "total" in r] == [1]
    assert [r["step"] for r in rows if "val_map" in r] == [1]
    shutil.rmtree(logdir)  # a checkpoint of tiny v2 is ~0.1 GB


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    ws = tmp_path_factory.mktemp("train_cli")
    write_learnable_voc(str(ws / "voc"), n_images=16, size=64, seed=0)
    write_learnable_voc(str(ws / "voc"), n_images=4, size=64, seed=1,
                        image_set="val")
    ini = ws / "t.ini"
    ini.write_text(textwrap.dedent(f"""
        [model]
        model = yolo2
        inference = tiny
        dim = 64
        names_file = {REPO}/config/names/voc.txt
        [cache]
        basedir = {ws}/cache
        train = voc:{ws}/voc:trainval
        val = voc:{ws}/voc:val
        [queue]
        batch_size = 8
        canvas_dim = 64
        max_boxes = 8
        num_threads = 2
        [train]
        logdir = {ws}/logdir
        save_steps = 2
        summary_steps = 1
        eval_steps = 4
        ema_decay = 0.9
        compute_dtype = float32
        optimizer = momentum
        learning_rate = 1e-4
        warmup_steps = 2
        [detect]
        threshold = 0.0
        [eval]
        batch_size = 4
        """))
    cfg = load_config([str(ini)])
    for phase in ("train", "val"):
        build_cache(cfg.cache.basedir, phase, cfg.cache_datasets(phase),
                    cfg.names())
    yield ws, str(ini)
    shutil.rmtree(ws)  # ~0.2 GB a checkpoint of tiny v2 with its EMA


def test_train_resume_eval_detect_without_jax(workspace):
    ws, ini = workspace
    logdir = str(ws / "logdir" / "yolo2_tiny")
    image = str(ws / "voc" / "JPEGImages" / "val_000000.jpg")
    runs = [
        ("cache", []),
        ("train", ["--device", "cpu", "train.steps=4",
                   "train.histogram_steps=2", "train.image_summary_steps=4",
                   "train.profile_steps=1", "train.keep_checkpoints=2"]),
        ("train", ["--device", "cpu", "train.steps=6",
                   "train.keep_checkpoints=2"]),
        ("eval", ["--device", "cpu", "--weights", logdir, "--phase", "val"]),
        ("eval", ["--device", "cpu", "--weights", logdir, "--phase", "val",
                  "detect.use_ema=1"]),
        ("detect", ["--device", "cpu", "--weights", logdir, "--image",
                    image]),
        ("detect", ["--device", "cpu", "--weights", logdir, "--image", image,
                    "detect.use_ema=1"]),
    ]
    code = textwrap.dedent(f"""
        import runpy, sys
        sys.modules["jax"] = None
        sys.modules["yolojax"] = None
        for mod, extra in {runs!r}:
            print("=== " + mod, flush=True)
            sys.argv = [mod, "-c", {ini!r}, *extra]
            runpy.run_module("yolojax_torch.cli." + mod, run_name="__main__")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO,
                                   OMP_NUM_THREADS="2"),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "resumed from step 4" in proc.stderr
    assert proc.stderr.count("using EMA (Polyak-averaged) weights") == 2
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    loss_steps = [r["step"] for r in rows if "total" in r]
    assert loss_steps == [1, 2, 3, 4, 5, 6]  # each step logged once
    assert all(np.isfinite(r["total"]) and r["images_per_sec"] > 0
               for r in rows if "total" in r)
    assert [r["step"] for r in rows if "val_map" in r] == [4]
    hist = [r for r in rows if "hist/conv_0/w" in r]
    assert [r["step"] for r in hist] == [2, 4]
    assert sum("hist/grad/conv_0/w" in r for r in rows) == 2
    with open(os.path.join(logdir, "sample_00000004.png"), "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    with open(os.path.join(logdir, "profile", "trace.json")) as f:
        events = json.load(f)["traceEvents"]  # train.profile_steps
    # the step's optimizer span, beside the ops it ran
    assert any(e.get("name") == "train.update" for e in events)
    assert sorted(os.listdir(os.path.join(logdir, "ckpt"))) == ["4", "6"]
    sections = proc.stdout.split("=== ")[1:]
    evals = [s for s in sections if s.startswith("eval")]
    detects = [s for s in sections if s.startswith("detect")]
    metrics = [json.loads(s.strip().splitlines()[-1]) for s in evals]
    assert all(m["num_images"] == 4 for m in metrics)
    # the EMA weights are another network: other detections
    assert all(len(s.splitlines()) > 1 for s in detects)
    assert detects[0] != detects[1]


def test_nonfinite_loss_halts_with_a_forensic_save(workspace, monkeypatch):
    ws, ini = workspace
    cfg = load_config([ini], [f"train.logdir={ws}/diverge", "train.steps=4",
                              "train.eval_steps=0", "train.ema_decay=0"])
    real = step.make_train_step

    def poisoned(*args, **kwargs):
        fn = real(*args, **kwargs)

        def run(ts, batch, seed, dim, with_grads=False):
            ts, m = fn(ts, batch, seed, dim, with_grads)
            if ts.step == 3:
                m["total"] = m["total"] * float("nan")
            return ts, m

        return run

    monkeypatch.setattr(train_cli, "make_train_step", poisoned)
    with pytest.raises(SystemExit) as exc:
        train_cli.train(cfg, device="cpu")
    assert exc.value.code == 3
    logdir = os.path.join(ws, "diverge", "yolo2_tiny")
    assert os.listdir(os.path.join(logdir, "diverged")) == ["3"]
    assert Checkpointer(os.path.join(logdir, "ckpt")).latest_step() == 2


def test_init_weights_with_transfer(workspace):
    """``--init-weights`` copies an ``.npz``'s layers except those named
    in ``--transfer``, and the EMA starts as a copy of the loaded
    weights."""
    ws, ini = workspace
    cfg = load_config([ini], [f"train.logdir={ws}/init", "train.steps=0"])
    model = get_model("yolo2", "tiny", 20)
    src = model.init(torch.Generator().manual_seed(9), 64)
    npz = str(ws / "init.npz")
    save_network_npz(npz, model, src)
    head = f"conv_{len(model.specs) - 1}"
    ts = train_cli.train(cfg, device="cpu", init_weights=npz,
                         transfer=head)
    got, want = ts.params(), dict(src.named_parameters())
    assert torch.equal(got["conv_0.w"], want["conv_0.w"])
    assert not torch.equal(got[f"{head}.w"], want[f"{head}.w"])
    assert torch.equal(ts.net.conv_0.mean, src.conv_0.mean)
    assert all(torch.equal(ts.opt_state["ema_params"][k], p)
               for k, p in got.items())


def test_v1_tiny_trains_with_dropout(workspace):
    """``cli.train`` on a v1 model: the v1 loss and dropout's generator
    on the train path; two finite steps and a checkpoint."""
    ws, ini = workspace
    cfg = load_config([ini], [f"train.logdir={ws}/v1", "model.model=yolo",
                              "train.steps=2", "train.eval_steps=0",
                              "train.ema_decay=0", "train.keep_checkpoints=1"])
    ts = train_cli.train(cfg, device="cpu")
    assert ts.step == 2
    with open(os.path.join(ws, "v1", "yolo_tiny", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["total"]) for r in rows)
