"""The port stands alone: every ``yolojax_torch`` module, and what
``chip_smoke.py`` imports, loads in a process where ``jax`` and ``yolojax``
cannot be imported; and its entry points refuse to fall back to the CPU."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from yolojax_torch.cli.detect import build_detector
from yolojax_torch.config import load_config
from yolojax_torch.convert.store import save_network_npz
from yolojax_torch.models import get_model
from yolojax_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None       # any `import jax...` now raises
    sys.modules["yolojax"] = None
""")


def _run_blocked(body: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", _BLOCKED + textwrap.dedent(body), *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    proc = _run_blocked("""
        import importlib, pkgutil
        import yolojax_torch
        names = sorted(m.name for m in pkgutil.walk_packages(
            yolojax_torch.__path__, "yolojax_torch."))
        for name in names:
            importlib.import_module(name)
        import chip_smoke  # its imports; main() runs only as a script
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "yolojax",
                                          "tensorflow")]
        assert not loaded, loaded
        print(" ".join(names))
    """)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 30  # every module was walked
    assert {"yolojax_torch.cli.train", "yolojax_torch.train.losses",
            "yolojax_torch.train.step", "yolojax_torch.train.checkpoint",
            "yolojax_torch.utils.metrics", "yolojax_torch.utils.profiling",
            "yolojax_torch.data.augment", "yolojax_torch.quantize.qat",
            "yolojax_torch.cli.qat", "yolojax_torch.serve",
            "yolojax_torch.serve.batching", "yolojax_torch.cli.export",
            "yolojax_torch.cli.serve", "yolojax_torch.kernels.ops",
            "yolojax_torch.convert.darknet", "yolojax_torch.convert.cfg",
            "yolojax_torch.convert.tf1", "yolojax_torch.utils.restore",
            "yolojax_torch.utils.flops", "yolojax_torch.data.anchors",
            "yolojax_torch.__main__", "yolojax_torch.cli.parse_darknet",
            "yolojax_torch.cli.parse_darknet_yolo2",
            "yolojax_torch.cli.kmeans_anchors",
            "yolojax_torch.cli.demo_data_augmentation",
            "yolojax_torch.cli.detect_camera",
            "yolojax_torch.utils.metrics", "yolojax_torch.parallel",
            "yolojax_torch.parallel.mesh", "yolojax_torch.parallel.distributed",
            "yolojax_torch.parallel.collectives",
            "yolojax_torch.parallel.sharding",
            "yolojax_torch.parallel.launch",
            "yolojax_torch.data.grain_loader", "yolojax_torch.serve.tf_graph",
            "yolojax_torch.serve.savedmodel",
            "yolojax_torch.serve.tflite"} <= names


@pytest.mark.parametrize("fmt", ["savedmodel", "tflite"])
def test_tf_export_without_tensorflow_writes_nothing(tmp_path, fmt):
    """With tensorflow (and jax, yolojax) blocked, ``cli.export --format
    savedmodel|tflite`` exits non-zero naming tensorflow and leaves no
    output behind, as on a card host without it."""
    model = get_model("yolo2", "tiny", 20)
    npz = str(tmp_path / "tiny.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(0),
                                            64))
    ini = tmp_path / "t.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n")
    out = str(tmp_path / ("sm" if fmt == "savedmodel" else "m.tflite"))
    proc = _run_blocked("""
        import runpy
        sys.modules["tensorflow"] = None
        sys.argv = ["export", *sys.argv[1:]]
        runpy.run_module("yolojax_torch.cli.export", run_name="__main__")
    """, "-c", str(ini), "--weights", npz, "--out", out, "--format", fmt,
        "--device", "cpu")
    assert proc.returncode != 0
    assert "needs tensorflow" in proc.stderr, proc.stderr[-2000:]
    assert not os.path.exists(out) and not os.path.exists(out + ".json")


def test_multi_device_paths_run_without_jax(tmp_path):
    """With jax and yolojax blocked: four ``gloo`` ranks (``launch.run``,
    which imports this script in each) build a 2x2 mesh and take a ZeRO-1
    and tensor-parallel step, and agree; the grain loader batches a cache
    (grain uses jax when it can import it, and runs without)."""
    script = tmp_path / "blocked_mesh.py"
    script.write_text(_BLOCKED + textwrap.dedent("""
        import json, os
        import numpy as np, torch
        from yolojax_torch.data.cache import build_cache
        from yolojax_torch.data.grain_loader import make_loader
        from yolojax_torch.data.loader import LoaderConfig, write_ppm
        from yolojax_torch.models import get_model
        from yolojax_torch.parallel import launch
        from yolojax_torch.parallel.mesh import make_mesh, shard_batch
        from yolojax_torch.parallel.sharding import Plan
        from yolojax_torch.train import step


        def step_on_mesh(rank, batch):
            model = get_model("yolo2", "tiny", 1)
            tx = step.make_optimizer(step.OptimizerConfig(ema_decay=0.9))
            ts = step.init_train_state(model, tx,
                                       torch.Generator().manual_seed(0), 32)
            Plan(make_mesh(data=2, model=2), zero=True).shard(ts)
            fn = step.make_train_step(model, tx, compute_dtype=torch.float32)
            ts, m = fn(ts, shard_batch(ts.plan.mesh, batch), 1, 32)
            return float(m["total"])


        if __name__ == "__main__":
            tmp = os.path.dirname(os.path.abspath(__file__))
            os.makedirs(tmp + "/images")
            images, anns = [], []
            for i in range(4):
                write_ppm(f"{tmp}/images/{i}.ppm", np.full((24, 32, 3), 9 * i,
                                                          np.uint8))
                images.append({"id": i, "file_name": f"{i}.ppm",
                               "width": 32, "height": 24})
                anns.append({"id": i + 1, "image_id": i, "category_id": 1,
                             "bbox": [4, 4, 8, 8], "iscrowd": 0})
            with open(tmp + "/ann.json", "w") as f:
                json.dump({"images": images, "annotations": anns,
                           "categories": [{"id": 1, "name": "aeroplane"}]}, f)
            cache = build_cache(tmp + "/cache", "train", [{
                "kind": "coco", "ann_json": tmp + "/ann.json",
                "image_dir": tmp + "/images"}])
            grain = make_loader(cache, LoaderConfig(batch_size=2,
                                                    canvas_dim=32), "grain")
            shapes = [b[0].shape for b in grain.epoch(0)]
            assert shapes == [(2, 32, 32, 3)] * 2, shapes
            loaded = [m for m, mod in sys.modules.items() if mod is not None
                      and m.split(".")[0] in ("jax", "yolojax")]
            assert not loaded, loaded
            print("grain batches")
            g = torch.Generator().manual_seed(0)
            batch = (torch.rand((4, 32, 32, 3), generator=g),
                     torch.full((4, 2, 4), 0.3),
                     torch.zeros((4, 2), dtype=torch.int32),
                     torch.ones((4, 2), dtype=torch.bool))
            losses = launch.run(step_on_mesh, 4, args=(batch,),
                                device="cpu", timeout=120)
            assert len(set(losses)) == 1, losses
            print("ranks agree", losses[0])
    """))
    proc = subprocess.run([sys.executable, str(script)], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "grain batches" in proc.stdout and "ranks agree" in proc.stdout


def test_pyproject_lists_every_port_package():
    """A non-editable install carries only the packages ``pyproject.toml``
    lists: every directory of ``yolojax_torch/`` with an ``__init__.py``
    must be there."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        listed = set(tomllib.load(f)["tool"]["setuptools"]["packages"])
    found = {os.path.relpath(d, REPO).replace(os.sep, ".")
             for d, _, files in os.walk(os.path.join(REPO, "yolojax_torch"))
             if "__init__.py" in files}
    assert {"yolojax_torch.quantize", "yolojax_torch.serve",
            "yolojax_torch.train"} <= found
    assert found <= listed, sorted(found - listed)


def test_eval_and_cache_entry_points_run_without_jax(tmp_path):
    """``cli.cache`` then ``cli.eval --device cpu`` with the fused stem, in
    a process where jax and yolojax cannot be imported."""
    proc = _run_blocked(f"""
        import json, os, runpy
        import numpy as np, torch
        from yolojax_torch.convert.store import save_network_npz
        from yolojax_torch.data.loader import write_ppm
        from yolojax_torch.models import get_model
        tmp = {str(tmp_path)!r}
        os.makedirs(tmp + "/images")
        rng = np.random.RandomState(0)
        images, anns = [], []
        for i in range(3):
            write_ppm(f"{{tmp}}/images/{{i}}.ppm",
                      rng.randint(0, 256, (40 + 8 * i, 64, 3), np.uint8))
            images.append({{"id": i, "file_name": f"{{i}}.ppm", "width": 64,
                           "height": 40 + 8 * i}})
            anns.append({{"id": i + 1, "image_id": i, "category_id": 1,
                         "bbox": [4, 4, 20, 20], "iscrowd": 0}})
        with open(tmp + "/ann.json", "w") as f:
            json.dump({{"images": images, "annotations": anns,
                       "categories": [{{"id": 1, "name": "aeroplane"}}]}}, f)
        model = get_model("yolo2", "tiny", 1)
        save_network_npz(tmp + "/w.npz", model,
                         model.init(torch.Generator().manual_seed(0), 64))
        with open(tmp + "/t.ini", "w") as f:
            f.write("[model]\\nmodel = yolo2\\ninference = tiny\\ndim = 64\\n"
                    "num_classes = 1\\n[cache]\\nbasedir = " + tmp + "/cache\\n"
                    "test = coco:" + tmp + "/ann.json:" + tmp + "/images\\n"
                    "[eval]\\nbatch_size = 2\\n")
        for mod, extra in (("cache", []), ("eval", [
                "--weights", tmp + "/w.npz", "--device", "cpu",
                "detect.fuse_stem=auto"])):
            sys.argv = [mod, "-c", tmp + "/t.ini", *extra]
            runpy.run_module("yolojax_torch.cli." + mod, run_name="__main__")
    """)
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout.splitlines()[-1])
    assert metrics["num_images"] == 3 and "map" in metrics


def test_entry_points_refuse_the_cpu_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")
    model = get_model("yolo2", "tiny", 20)
    npz = str(tmp_path / "tiny.npz")
    save_network_npz(npz, model, model.init(torch.Generator().manual_seed(0),
                                            64))
    ini = tmp_path / "t.ini"
    ini.write_text("[model]\nmodel = yolo2\ninference = tiny\ndim = 64\n")
    cfg = load_config([str(ini)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_detector(cfg, npz)
    names, dim, infer = build_detector(cfg, npz, device="cpu")
    out = infer(np.full((1, 64, 64, 3), 0.5, np.float32))
    assert out["keep"].shape == (1, 256) and out["boxes"].shape == (1, 256, 4)
