"""BENCHMARK.json and the files it names, with the cells held back from
it (held_back.json): every cell resolves to its configuration, mix,
driver and limits by name, every per-layer metric to its reader; the
yardstick's FLOP counts are Darknet's."""

import importlib
import json
import re

import pytest

from benchmark import counts, harness

from conftest import ALL, HELD_BACK, SPEC, load_cell

CELLS = [w["name"] for w in ALL["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][1:] == ["benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    # every configuration BENCHMARK.json lists has a cell there, and every
    # metric there applies to a cell there
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert set(HELD_BACK) - {"why"} == {"configs", "workloads",
                                        "end_to_end", "per_layer"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = load_cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in ALL["workloads"] if w["name"] == name)
    importlib.import_module(f"benchmark.drivers.{cell.mix['kind']}")
    assert cell.limits, "every cell has its limits"
    assert cell.chips == 1
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["per_layer"]])
def test_reader_resolves(metric):
    m = next(x for x in ALL["per_layer"] if x["name"] == metric)
    assert callable(harness.load_reader(metric))
    assert set(m["workloads"]) <= set(CELLS)


def test_names_and_units():
    metrics = ALL["end_to_end"] + ALL["per_layer"]
    names = ([m["name"] for m in metrics] + CELLS
             + [c["name"] for c in ALL["configs"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in ALL["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in ALL["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("config,gflop", [("yolo2-voc-416", 29.36),
                                          ("yolo2-tiny-voc-416", 6.97)])
def test_flops_are_darknets(config, gflop):
    c = json.loads((harness.BENCH / "configs" / f"{config}.json").read_text())
    assert counts.flops_per_image(c, 416) / 1e9 == pytest.approx(gflop,
                                                                 abs=5e-3)


def test_kernel_bytes_follow_shapes():
    c = json.loads((harness.BENCH / "configs" / "yolo2-voc-416.json"
                    ).read_text())
    # 1.33 G bf16 conv outputs a b128@416 batch, 22 of 23 convs with the
    # fused stem: 2 B read and 2 B written each
    per_image, launches = counts.conv_epilogue_bytes(c, 416, True)
    assert launches == 22 and per_image * 128 == pytest.approx(5.44e9,
                                                              rel=1e-2)
    assert counts.int8_requant_bytes(c, 416, False)[1] == 22
