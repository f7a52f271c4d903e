"""Tests of the benchmark itself. ``card`` marks a test that needs a CUDA
card: it skips elsewhere, decided inside the fixture, never at import.
On the card: ``python3 -m pytest benchmark/tests -m card``."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
HELD_BACK = json.loads((Path(__file__).parent / "held_back.json").read_text())
# BENCHMARK.json with the entries of the cells held back from it: the
# tests run every cell the benchmark has code for
ALL = {**SPEC, **{k: SPEC[k] + HELD_BACK[k] for k in
                  ("configs", "workloads", "end_to_end", "per_layer")}}
CELLS = {w["name"]: w["traffic"] for w in ALL["workloads"]}


def load_cell(name: str) -> harness.Cell:
    return harness.load_cell(name, ALL)

# each mix cut to a size the CPU runs in seconds; the configurations keep
# their widths (the train cell its canvas and dim too: 96 and 64)
TINY = {
    "detect": {"batch": 2, "pool_batches": 2, "sample_batches": 2,
               "calib_images": 2, "sizes": [[120, 90], [90, 120]]},
    "http": {"pool": 4, "sample": 4, "rate": 4, "connections": 4,
             "wait_s": 30, "sizes": [[120, 90], [90, 120]]},
    "train": {"images": 8, "batch": 4, "dim": 64,
              "sizes": [[120, 90], [90, 120]]},
}
TINY_INI = {"train": {"queue.batch_size": "4", "queue.canvas_dim": "96",
                      "queue.num_threads": "2"}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the card with -m card)")
    return torch.device("cuda", 0)


def tiny_cell(name: str, **ini) -> harness.Cell:
    """The cell ``name`` at a size the CPU runs quickly."""
    cell = copy.deepcopy(load_cell(name))
    kind = cell.mix["kind"]
    cell.mix.update(TINY[kind])
    cell.mix["ini"] = {**cell.mix.get("ini", {}), **TINY_INI.get(kind, {}),
                       **ini}
    return cell


def cpu_run(cell, seed=2 ** 31 + 17, control=None, **kw):
    import importlib

    import torch

    driver = importlib.import_module(
        f"benchmark.drivers.{cell.mix['kind']}")
    ctx = harness.Context(cell, seed, 0.5, False, torch.device("cpu"))
    out = driver.run(ctx, control=control, **kw)
    return ctx, out
