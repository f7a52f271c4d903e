"""The port's grain loader (``data/grain_loader.py``) against yolojax's, and
``queue.loader=grain`` through ``cli.train`` (with an exact mid-epoch
resume) and ``cli.qat``."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import yolojax.data.native
from yolojax.data.grain_loader import GrainLoader as JaxGrainLoader
from yolojax.data.loader import LoaderConfig as JaxLoaderConfig
from yolojax_torch.cli import train as train_cli
from yolojax_torch.config import load_config
from yolojax_torch.data import cache, grain_loader, loader, native
from yolojax_torch.train.checkpoint import Checkpointer

from .util import write_synthetic_voc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def voc_cache(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grain")
    write_synthetic_voc(str(tmp / "voc"), n_images=11, size=(64, 64),
                        seed=3, difficult_frac=0.3)
    c = cache.build_cache(str(tmp / "c"), "train",
                          [{"kind": "voc", "root": str(tmp / "voc"),
                            "image_set": "trainval"}])
    return tmp, c


@pytest.mark.parametrize("drop,shard", [(False, (0, 1)), (True, (1, 2)),
                                        (False, (0, 2))])
def test_grain_batches_match_yolojax(voc_cache, monkeypatch, drop, shard):
    """One shuffled epoch through grain on both sides: the same order and
    batches (images of the canvas size, so the canvases are the decoded
    pixels, 1e-6 as tests/test_torch_data.py holds the default loader)."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(yolojax.data.native, "available", lambda: False)
    _, c = voc_cache
    kw = dict(batch_size=3, canvas_dim=64, max_boxes=3, num_threads=2,
              drop_remainder=drop, seed=5, shard_index=shard[0],
              shard_count=shard[1])
    port = grain_loader.GrainLoader(c, loader.LoaderConfig(**kw))
    ref = JaxGrainLoader(c, JaxLoaderConfig(**kw))
    got, want = list(port.epoch(1)), list(ref.epoch(1))
    assert len(got) == len(want) == len(port) == len(ref) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        for a, b in zip(g[1:], w[1:]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_stream_state_resumes_mid_epoch(voc_cache):
    """``get_state`` after two batches, ``set_state`` on a fresh stream:
    the next batches are the ones the first stream goes on to, across the
    epoch boundary; the state is yolojax's, byte for byte."""
    _, c = voc_cache
    cfg = loader.LoaderConfig(batch_size=4, canvas_dim=64, max_boxes=3,
                              seed=2)
    port = grain_loader.GrainLoader(c, cfg).stream()
    ref = JaxGrainLoader(c, JaxLoaderConfig(**vars(cfg))).stream()
    for _ in range(2):
        next(port), next(ref)
    state = port.get_state()
    assert state == ref.get_state()
    ahead = [next(port) for _ in range(3)]  # 2 batches an epoch: crosses
    again = grain_loader.GrainLoader(c, cfg).stream()
    again.set_state(state)
    for a, b in zip(ahead, [next(again) for _ in range(3)]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_make_loader_kinds_and_missing_grain(voc_cache, monkeypatch):
    _, c = voc_cache
    cfg = loader.LoaderConfig(batch_size=2, canvas_dim=64)
    assert isinstance(grain_loader.make_loader(c, cfg, "native"),
                      loader.Loader)
    assert isinstance(grain_loader.make_loader(c, cfg, "grain"),
                      grain_loader.GrainLoader)
    with pytest.raises(ValueError, match="unknown loader kind"):
        grain_loader.make_loader(c, cfg, "tfrecord")
    monkeypatch.setitem(sys.modules, "grain.python", None)
    with pytest.raises(ImportError, match="needs the grain package"):
        grain_loader.make_loader(c, cfg, "grain")


def test_train_with_grain_resumes_exactly(voc_cache):
    """``queue.loader=grain`` through ``cli.train``: the stream state is
    saved beside each checkpoint as ``<step>.p0.bin`` (an older ``<step>.bin``
    is taken on resume and then removed); the resumed run logs every step
    once and ends where an uninterrupted run ends."""
    tmp, _ = voc_cache
    ini = tmp / "grain.ini"
    ini.write_text(f"""
[model]
model = yolo2
inference = tiny
dim = 64
names_file = {REPO}/config/names/voc.txt
[cache]
basedir = {tmp / 'c'}
[queue]
batch_size = 4
canvas_dim = 64
max_boxes = 8
loader = grain
[train]
steps = 3
save_steps = 2
keep_checkpoints = 1
summary_steps = 1
compute_dtype = float32
optimizer = sgd
learning_rate = 1e-4
weight_decay = 0
""")

    def run(logdir, steps):
        cfg = load_config([str(ini)], [f"train.logdir={logdir}",
                                       f"train.steps={steps}"])
        return train_cli.train(cfg, device="cpu")

    straight = run(tmp / "straight", 5)
    run(tmp / "resumed", 3)
    states = tmp / "resumed" / "yolo2_tiny" / "loader_state"
    assert sorted(os.listdir(states)) == ["3.p0.bin"]
    os.rename(states / "3.p0.bin", states / "3.bin")  # the older layout
    resumed = run(tmp / "resumed", 5)
    assert sorted(os.listdir(states)) == ["5.p0.bin"]
    with open(tmp / "resumed" / "yolo2_tiny" / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [1, 2, 3, 4, 5]
    for (k, a), b in zip(straight.net.state_dict().items(),
                         resumed.net.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert Checkpointer(str(tmp / "resumed" / "yolo2_tiny" / "ckpt")
                        ).steps() == [5]
