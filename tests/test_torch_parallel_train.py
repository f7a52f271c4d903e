"""Data-, tensor-parallel and ZeRO-1 training of the port on two ``gloo``
ranks on the CPU, against one rank and against yolojax.

One spawn of two ranks (``parallel/launch.py``, one thread each, a free
port, a time limit) runs every configuration: data parallel on tiny v2
@64, the rest on yolojax's micro v2 (its ZeRO-1 and TP tests' model, TP
at their ``tp_threshold=16``) and a micro v1 with dropout; rank 0 writes
each run's full train state (gathered from the ranks' pieces) and the
tests hold them against one-rank runs in this process:

* data parallel with augmentation: loss rtol 1e-5, params atol 1e-5, BN
  statistics rtol 1e-5 (tests/pipeline/test_train_step.py:92-117);
* data parallel against yolojax's jitted step on a 2-device CPU mesh,
  ``augment=False``, within tests/test_torch_train_steps.py's tolerances;
* ZeRO-1 against the replicated two-rank run: bit-equal without a clip,
  1e-6 relative with ``grad_clip_norm`` (the global norm sums its
  pieces in another order);
* tensor parallel (``model=2``) against one rank;
* checkpoints: a ZeRO-1 and a TP checkpoint resume on one rank, and a
  one-rank checkpoint on two ranks, to the same next step.
"""

import os

import numpy as np
import pytest
import torch

from yolojax_torch.models import Model, get_model
from yolojax_torch.nn.layers import (
    ConvSpec,
    DenseSpec,
    DropoutSpec,
    FlattenSpec,
    MaxPoolSpec,
)
from yolojax_torch.parallel import launch
from yolojax_torch.parallel.mesh import make_mesh, shard_batch
from yolojax_torch.parallel.sharding import Plan
from yolojax_torch.train import step
from yolojax_torch.train.checkpoint import Checkpointer, _tree

BATCH, STEPS = 8, 3
# bounds of tests/pipeline/test_train_step.py:92-117 (one rank vs two)
LOSS_RTOL, PARAM_ATOL, BN_RTOL = 1e-5, 1e-5, 1e-5
CLIP_RTOL = 1e-6
MOMENTUM = dict(optimizer="momentum", learning_rate=1e-3,
                weight_decay=5e-4, ema_decay=0.9)
CLIPPED = dict(optimizer="adam", learning_rate=1e-3, weight_decay=0.0,
               grad_clip_norm=1.0)
SGD = dict(optimizer="sgd", learning_rate=1e-4, weight_decay=0.0)
SPAWN_TIMEOUT = 240


def micro_v1():
    """A small YOLOv1 with a dense head and dropout (2x2 grid, 3
    classes, one box)."""
    specs = (ConvSpec(8, 3, bn=False), MaxPoolSpec(), ConvSpec(16, 3),
             MaxPoolSpec(), FlattenSpec(), DenseSpec(32), DropoutSpec(0.5),
             DenseSpec(2 * 2 * (3 + 5), act="linear"))
    return Model("yolo", "micro", "v1", specs, 3, 16, boxes_per_cell=1,
                 grid=2)


def micro_v2():
    """yolojax's micro YOLOv2 (tests/pipeline/test_train_step.py)."""
    anchors = ((1.0, 1.0), (2.5, 2.5))
    specs = (ConvSpec(8, 3), MaxPoolSpec(), ConvSpec(16, 3), MaxPoolSpec(),
             ConvSpec(len(anchors) * (5 + 3), 1, bn=False, act="linear"))
    return Model("yolo2", "micro", "v2", specs, 3, 4, anchors=anchors)


def models():
    return {"tiny": get_model("yolo2", "tiny", 20), "v1": micro_v1(),
            "micro": micro_v2()}


# input dim of each net
DIMS = {"tiny": 64, "v1": 32, "micro": 32}


def batch(seed, n=BATCH, dim=64, classes=20):
    rng = np.random.RandomState(seed)
    images = rng.uniform(0, 1, (n, dim, dim, 3)).astype(np.float32)
    boxes = np.zeros((n, 4, 4), np.float32)
    boxes[:, 0] = [0.4, 0.5, 0.3, 0.3]
    boxes[:, 1] = [0.7, 0.3, 0.2, 0.2]
    cls = rng.randint(0, classes, (n, 4)).astype(np.int32)
    valid = np.zeros((n, 4), bool)
    valid[:, :2] = True
    return tuple(torch.from_numpy(a) for a in (images, boxes, cls, valid))


def fresh_state(arch, opt):
    model = models()[arch]
    tx = step.make_optimizer(step.OptimizerConfig(**opt))
    return model, tx, step.init_train_state(
        model, tx, torch.Generator().manual_seed(0), DIMS[arch])


def host_tree(tree):
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def run_steps(model, tx, ts, steps, *, augment, start=0, ckpt=None):
    """Steps ``start .. start + steps - 1`` on the seeded global batches
    (a mesh rank takes its rows); -> per-step metrics."""
    fn = step.make_train_step(model, tx, augment=augment,
                              compute_dtype=torch.float32)
    dim = DIMS[model.inference]
    out = []
    for i in range(start, start + steps):
        b = batch(i, dim=dim, classes=model.num_classes)
        if ts.plan is not None and ts.plan.mesh.data > 1:
            b = shard_batch(ts.plan.mesh, b)
        ts, m = fn(ts, b, 1, dim)
        out.append({k: float(v) for k, v in m.items()})
        if ckpt is not None and ckpt.should_save(i + 1):
            ckpt.save(i + 1, ts)
    return out


# (name, arch, data, model, zero, optimizer, augment, steps, checkpoint at 2)
RUNS = (
    ("dp_aug", "tiny", 2, 1, False, MOMENTUM, True, STEPS, False),
    ("dp_micro", "micro", 2, 1, False, MOMENTUM, True, STEPS, False),
    ("zero_aug", "micro", 2, 1, True, MOMENTUM, True, STEPS, True),
    ("dp_clip", "micro", 2, 1, False, CLIPPED, False, STEPS, False),
    ("zero_clip", "micro", 2, 1, True, CLIPPED, False, STEPS, False),
    ("tp_aug", "micro", 1, 2, False, MOMENTUM, True, STEPS, True),
    ("dp_jax", "micro", 2, 1, False, MOMENTUM, False, STEPS, False),
    ("v1_dp", "v1", 2, 1, False, SGD, True, STEPS, False),
    ("v1_tp", "v1", 1, 2, False, SGD, True, STEPS, False),
)


def _ranks(rank, out_dir, jax_start):
    """Every configuration on this rank; rank 0 saves each run's full
    state to ``out_dir/<name>.pt``. -> {name: per-step metrics}."""
    metrics = {}
    for name, arch, data, model_ax, zero, opt, augment, steps, ck in RUNS:
        model, tx, ts = fresh_state(arch, opt)
        if name == "dp_jax":  # yolojax's initial state, carried over
            saved = torch.load(jax_start, weights_only=False)
            ts.net.load_state_dict(saved["net"])
            ts.opt_state = saved["opt"]
            ts.step = saved["step"]
        mesh = make_mesh(data=data, model=model_ax)
        # the micro nets split their 16- and 32-wide layers
        Plan(mesh, zero=zero, tp_threshold=1024 if arch == "tiny" else 16
             ).shard(ts)
        ckpt = (Checkpointer(os.path.join(out_dir, f"{name}_ckpt"),
                             save_interval_steps=2, primary=rank == 0)
                if ck else None)
        metrics[name] = run_steps(model, tx, ts, steps, augment=augment,
                                  start=ts.step, ckpt=ckpt)
        full = ts.plan.gather(ts) if ts.plan.sharded else _tree(ts)
        if rank == 0:
            torch.save(host_tree(full), os.path.join(out_dir, f"{name}.pt"))
    # a one-rank checkpoint at step 2, resumed on a ZeRO-1 mesh
    model, tx, ts = fresh_state("micro", MOMENTUM)
    Plan(make_mesh(data=2), zero=True, tp_threshold=16).shard(ts)
    start, ts = Checkpointer(os.path.join(out_dir, "one_ckpt"),
                             primary=rank == 0).restore_latest(ts)
    metrics["resume_on_two"] = run_steps(model, tx, ts, 1, augment=True,
                                         start=start)
    full = ts.plan.gather(ts)
    if rank == 0:
        torch.save(host_tree(full), os.path.join(out_dir,
                                                 "resume_on_two.pt"))
    return metrics


def _one_rank(arch, opt, augment, steps, ckpt_dir=None):
    model, tx, ts = fresh_state(arch, opt)
    ckpt = (Checkpointer(ckpt_dir, save_interval_steps=2, max_to_keep=None)
            if ckpt_dir else None)
    m = run_steps(model, tx, ts, steps, augment=augment, ckpt=ckpt)
    return m, numpy_tree(host_tree(_tree(ts)))


def _jax_start(path):
    """yolojax's micro v2 train state after init, in the port's layout."""
    import jax

    from yolojax.train import step as jax_step
    from yolojax_torch.convert.interchange import train_state_from_jax

    from .pipeline.test_train_step import micro_model as jax_micro_model

    jm = jax_micro_model()
    jtx = jax_step.make_optimizer(jax_step.OptimizerConfig(**MOMENTUM))
    jts = jax_step.init_train_state(jm, jtx, jax.random.PRNGKey(0),
                                    DIMS["micro"])
    _, ttx, _ = fresh_state("micro", MOMENTUM)
    tts = train_state_from_jax(models()["micro"], jts, ttx)
    torch.save({"net": tts.net.state_dict(), "opt": tts.opt_state,
                "step": tts.step}, path)
    return jm, jtx, jts


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("parallel_train")
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        jax_parts = _jax_start(str(out / "jax_start.pt"))
        ref = {"tiny": _one_rank("tiny", MOMENTUM, True, STEPS),
               "micro": _one_rank("micro", MOMENTUM, True, STEPS,
                                  str(out / "one_ckpt")),
               "v1": _one_rank("v1", SGD, True, STEPS)}
        got = launch.run(_ranks, 2, args=(str(out), str(out / "jax_start.pt")),
                         device="cpu", timeout=SPAWN_TIMEOUT)
    finally:
        torch.set_num_threads(prev)
    two = {name: numpy_tree(torch.load(out / f"{name}.pt"))
           for name in [r[0] for r in RUNS] + ["resume_on_two"]}
    yield {"ref": ref, "metrics": got, "two": two, "dir": out,
           "jax": jax_parts}


def assert_like_one_rank(metrics, tree, ref_metrics, ref_tree):
    assert len(metrics) == len(ref_metrics)
    for i, (a, b) in enumerate(zip(metrics, ref_metrics)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    for k, want in ref_tree["params"].items():
        np.testing.assert_allclose(tree["params"][k], want, atol=PARAM_ATOL,
                                   err_msg=k)
    for k, want in ref_tree["bn_state"].items():
        np.testing.assert_allclose(tree["bn_state"][k], want, rtol=BN_RTOL,
                                   atol=1e-7, err_msg=k)


def test_ranks_agree(runs):
    """Every rank logs the same global metrics."""
    m0, m1 = runs["metrics"]
    assert m0 == m1


@pytest.mark.parametrize("name,arch", [("dp_aug", "tiny"),
                                       ("dp_micro", "micro"),
                                       ("tp_aug", "micro")])
def test_two_ranks_match_one_rank(runs, name, arch):
    """Data parallel (the batch split, augmentation draws of the global
    batch) and tensor parallel (the wide convs split over two ranks) take
    the one-rank steps on the global batch."""
    metrics, ref = runs["metrics"][0], runs["ref"][arch]
    assert_like_one_rank(metrics[name], runs["two"][name], *ref)
    for key in ("trace", "ema_params"):
        for k, want in ref[1]["opt_state"][key].items():
            got = runs["two"][name]["opt_state"][key][k]
            scale = max(np.abs(want).max(), 1e-6)
            assert np.abs(got - want).max() <= 1e-4 * scale, (key, k)


@pytest.mark.parametrize("name", ["v1_dp", "v1_tp"])
def test_dropout_and_dense_head_match_one_rank(runs, name):
    """A v1 with dropout: the two ranks draw the global batch's masks; TP
    (threshold 16) also splits the dense layer's bias."""
    assert_like_one_rank(runs["metrics"][0][name], runs["two"][name],
                         *runs["ref"]["v1"])


def test_zero1_equals_replicated_bit_for_bit(runs):
    """ZeRO-1 is a layout: without a clip the params, BN statistics and
    every optimizer buffer equal the replicated run's bit for bit."""
    a, b = runs["two"]["zero_aug"], runs["two"]["dp_micro"]
    for sec in ("params", "bn_state"):
        for k in b[sec]:
            np.testing.assert_array_equal(a[sec][k], b[sec][k], err_msg=k)
    for key, value in b["opt_state"].items():
        if isinstance(value, dict):
            for k in value:
                np.testing.assert_array_equal(a["opt_state"][key][k],
                                              value[k], err_msg=(key, k))
        else:
            assert a["opt_state"][key] == value
    assert runs["metrics"][0]["zero_aug"] == runs["metrics"][0]["dp_micro"]


def test_zero1_with_clip_within_1e6(runs):
    """With ``grad_clip_norm`` the clip's global norm sums the ranks'
    pieces in another order: the params stay within 1e-6 relative."""
    a, b = runs["two"]["zero_clip"], runs["two"]["dp_clip"]
    for k, want in b["params"].items():
        scale = max(np.abs(want).max(), 1e-6)
        assert np.abs(a["params"][k] - want).max() <= CLIP_RTOL * scale, k
    got, want = runs["metrics"][0]["zero_clip"], runs["metrics"][0]["dp_clip"]
    assert got[0] == want[0]  # the first step's loss and norm: unsplit
    for x, y in zip(got, want):
        for k in y:
            np.testing.assert_allclose(x[k], y[k], rtol=LOSS_RTOL)


def test_data_parallel_matches_yolojax_mesh(runs):
    """The port's two-rank step against yolojax's jitted step over a
    2-device CPU mesh, ``augment=False``, from the same initial state."""
    import jax
    import jax.numpy as jnp

    from yolojax.parallel.mesh import make_mesh as jax_make_mesh
    from yolojax.parallel.mesh import replicated, shard_batch as jax_shard
    from yolojax.train import step as jax_step
    from yolojax_torch.convert.interchange import train_state_to_jax

    from .test_torch_train_steps import BN_RTOL as J_BN_RTOL
    from .test_torch_train_steps import LOSS_RTOL as J_LOSS_RTOL
    from .test_torch_train_steps import STATE_RTOL, close_trees

    jm, jtx, jts = runs["jax"]
    mesh = jax_make_mesh(jax.devices()[:2], data=2, model=1)
    jfn = jax_step.make_train_step(jm, jtx, augment=False,
                                   compute_dtype=jnp.float32)
    jts = jax.device_put(jts, replicated(mesh))
    want = []
    dim = DIMS["micro"]
    for i in range(STEPS):
        b = jax_shard(mesh, tuple(np.asarray(t) for t in
                                  batch(i, dim=dim, classes=3)))
        jts, m = jfn(jts, b, jax.random.PRNGKey(1), dim=dim)
        want.append({k: float(v) for k, v in m.items()})
    for i, (got, w) in enumerate(zip(runs["metrics"][0]["dp_jax"], want)):
        for k in w:
            np.testing.assert_allclose(got[k], w[k], rtol=J_LOSS_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    model, tx, ts = fresh_state("micro", MOMENTUM)
    tree = runs["two"]["dp_jax"]
    ts.net.load_state_dict({**{k: torch.from_numpy(v)
                               for k, v in tree["params"].items()},
                            **{k: torch.from_numpy(v)
                               for k, v in tree["bn_state"].items()}})
    got = train_state_to_jax(model, ts)
    jts = jax.device_get(jts)
    close_trees(got["params"], jts.params, STATE_RTOL, "params")
    close_trees(got["bn_state"], jts.bn_state, J_BN_RTOL, "bn_state")


@pytest.mark.parametrize("name", ["zero_aug", "tp_aug"])
def test_sharded_checkpoint_resumes_on_one_rank(runs, name):
    """A checkpoint a ZeRO-1 or TP run wrote at step 2 (full layout,
    primary only) resumes on one rank to the two ranks' step 3."""
    ck = Checkpointer(str(runs["dir"] / f"{name}_ckpt"))
    assert ck.latest_step() == 2
    model, tx, ts = fresh_state("micro", MOMENTUM)
    start, ts = ck.restore_latest(ts)
    assert start == 2 and ts.step == 2
    m = run_steps(model, tx, ts, 1, augment=True, start=2)
    np.testing.assert_allclose(m[0]["total"],
                               runs["metrics"][0][name][2]["total"],
                               rtol=LOSS_RTOL)
    tree = numpy_tree(host_tree(_tree(ts)))
    for k, want in runs["two"][name]["params"].items():
        np.testing.assert_allclose(tree["params"][k], want, atol=PARAM_ATOL,
                                   err_msg=k)


def test_one_rank_checkpoint_resumes_on_two_ranks(runs):
    """The one-rank run's step-2 checkpoint, cut into a ZeRO-1 mesh of two
    ranks, steps to the one-rank run's step 3."""
    ref_m, ref_tree = runs["ref"]["micro"]
    got = runs["metrics"][0]["resume_on_two"]
    np.testing.assert_allclose(got[0]["total"], ref_m[2]["total"],
                               rtol=LOSS_RTOL)
    tree = runs["two"]["resume_on_two"]
    assert tree["step"] == STEPS
    for k, want in ref_tree["params"].items():
        np.testing.assert_allclose(tree["params"][k], want, atol=PARAM_ATOL,
                                   err_msg=k)


def test_two_process_cli_train_then_eval(tmp_path, monkeypatch, capsys):
    """tests/e2e/test_multiprocess.py's run on the port: two ``python -m
    yolojax_torch.cli.train`` processes (``gloo``, a free port) train tiny
    v2 @64 for two steps with the distributed in-training eval; the
    primary alone writes the metrics rows, the image summary and the
    checkpoint, which ``cli.eval`` then loads as ``--weights``."""
    import json
    import subprocess
    import sys

    from yolojax_torch.cli import cache as cache_cli
    from yolojax_torch.cli import eval as eval_cli

    from .util import write_synthetic_voc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    voc = tmp_path / "voc"
    write_synthetic_voc(str(voc), n_images=8, size=(96, 64))
    ini = tmp_path / "mp.ini"
    ini.write_text(f"""
[model]
model = yolo2
inference = tiny
dim = 64
names_file = {repo}/config/names/voc.txt
anchors = 1.08,1.19 3.42,4.41
[cache]
basedir = {tmp_path}/cache
train = voc:{voc}:trainval
val = voc:{voc}:trainval
[queue]
batch_size = 8
canvas_dim = 64
max_boxes = 8
num_threads = 2
[eval]
batch_size = 4
distributed = 1
[train]
logdir = {tmp_path}/logdir
steps = 2
save_steps = 10
summary_steps = 1
eval_steps = 2
image_summary_steps = 2
compute_dtype = float32
optimizer = sgd
learning_rate = 1e-4
weight_decay = 0
coordinator = 127.0.0.1:{launch.free_port()}
num_processes = 2
""")
    monkeypatch.setattr(sys, "argv", ["cache", "-c", str(ini)])
    cache_cli.main()
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "yolojax_torch.cli.train", "-c", str(ini),
         "--device", "cpu", f"train.process_id={pid}"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"process {i}:\n{outs[i][-3000:]}"
    logdir = tmp_path / "logdir" / "yolo2_tiny"
    with open(logdir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "total" in r] == [1, 2]
    assert all(np.isfinite(r["total"]) for r in rows if "total" in r)
    maps = [r["val_map"] for r in rows if "val_map" in r]
    assert len(maps) == 1 and np.isfinite(maps[0])
    assert "mesh: {'data': 2, 'model': 1}" in outs[0]
    assert "(shard 0/2)" in outs[0] and "(shard 1/2)" in outs[1]
    assert "step 1 dim 64" in outs[0] and "step 1 dim 64" not in outs[1]
    assert list(logdir.glob("sample_*.png"))
    assert Checkpointer(str(logdir / "ckpt")).latest_step() == 2
    monkeypatch.setattr(sys, "argv", [
        "eval", "-c", str(ini), "--weights", str(logdir), "--phase", "val",
        "--device", "cpu", "train.num_processes=1"])
    metrics = eval_cli.main()
    capsys.readouterr()
    # the in-training eval scored the same weights: the step-2 state
    np.testing.assert_allclose(metrics["map"], maps[0], atol=1e-6)
