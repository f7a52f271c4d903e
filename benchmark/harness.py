"""The benchmark's frame: finds a cell's files by name, times set-up and
the window, traces the device, reduces the trace, runs the per-layer
readers and prints the result.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``benchmark/configs/<config>.json``) under a traffic mix
(``benchmark/mixes/<traffic>.json``). The mix's ``kind`` names the
driver that generates it (``benchmark/drivers/<kind>.py``); the limits of
the comparison that decides ``correct`` are the cell's own
(``benchmark/limits/<cell>.json``); each per-layer metric is a reader in
``benchmark/metrics/<metric>.py``. Adding a cell or a metric adds files
and entries; no file here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"

# the value of a compared number that a run did not give
MISSING = 1e30

# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "yolojax")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc), so that
    set-up counts the interpreter's and the imports' start too."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = spec if spec is not None else load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have "
                         + ", ".join(sorted(cells)))
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    mix = load_json(BENCH / "mixes" / f"{w['traffic']}.json")
    limits_path = BENCH / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(name, config, mix, int(w["chips"]),
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)],
                limits)


def ini_overrides(cell: Cell) -> List[str]:
    """The port's ``section.key=value`` settings: the configuration's,
    then the mix's."""
    merged = {**cell.config["ini"], **cell.mix.get("ini", {})}
    return [f"{k}={v}" for k, v in merged.items()]


class Recorder:
    """Spans (name, start, end in unix ns, the profiler's clock) and
    counters, kept in memory."""

    def __init__(self):
        self.spans: List[Tuple[str, int, int]] = []
        self.counters: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def add(self, name: str, t0: int, t1: int) -> None:
        self.spans.append((name, t0, t1))

    def total_s(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name) / 1e9


class DeviceTrace:
    """``torch.profiler`` over the window, device activity only; the
    events are read as (name, start ns, end ns) on the host's unix clock."""

    def __init__(self):
        self.events: List[Tuple[str, int, int]] = []
        self.t0 = self.t1 = 0
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self.t0 = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self._prof.stop()
        kineto = self._prof.profiler.kineto_results
        cuda = torch.autograd.DeviceType.CUDA
        self.events = [(e.name(), e.start_ns(), e.end_ns())
                       for e in kineto.events()
                       if e.device_type() == cuda]
        self._prof = None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list, return type and
    template arguments, at most 60 characters."""
    raw = name
    name = name.replace("(anonymous namespace)", "anon").split("(")[0]
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">" and depth > 0
    return ("".join(out).strip() or raw)[:60]


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def busy_intervals(trace: DeviceTrace) -> List[Tuple[int, int]]:
    """The union of the kernels' intervals within the window: a copy
    engine moving bytes leaves the SMs idle, so copies are left out."""
    t0, t1 = trace.t0, trace.t1
    return merge([(max(a, t0), min(b, t1)) for n, a, b in trace.events
                  if b > t0 and a < t1 and not is_copy(n)])


def busy_seconds(trace: DeviceTrace) -> float:
    return sum(b - a for a, b in busy_intervals(trace)) / 1e9


def summarize(trace: DeviceTrace, spans: List[Tuple[str, int, int]]
              ) -> TraceSummary:
    """Busy seconds (the union of the kernels' intervals: a copy engine
    moving bytes leaves the SMs idle, so copies count as idle and are
    listed apart), the device operations that took most time, copies
    included, and the idle time by what the host was doing: the innermost
    harness span around each gap's middle."""
    t0, t1 = trace.t0, trace.t1
    busy = busy_intervals(trace)
    by_op: Dict[str, float] = {}
    for name, a, b in trace.events:
        key = short_name(name)
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e9
    gaps, at = [], t0
    for a, b in busy + [(t1, t1)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    ordered = sorted(spans, key=lambda s: s[1])
    by_host: Dict[str, float] = {}
    active: list = []
    j = 0
    for a, b in gaps:  # in time order: a sweep over the spans
        mid = (a + b) // 2
        while j < len(ordered) and ordered[j][1] <= mid:
            active.append(ordered[j])
            j += 1
        active = [s for s in active if s[2] > mid]
        label = (min(active, key=lambda s: s[2] - s[1])[0] if active
                 else "outside every span")
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(sum(b - a for a, b in busy) / 1e9, (t1 - t0) / 1e9,
                        top, idle)


@dataclasses.dataclass
class Outcome:
    """What a driver returns: end-to-end values by the host's clock, the
    window's work, the numbers compared and the device's trace."""

    attempted: int
    failed: int
    e2e: Dict[str, float]
    compared: Dict[str, float]
    memory_peak_bytes: int
    recorder: Recorder
    trace: Optional[DeviceTrace] = None


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees."""

    cell: Cell
    outcome: Outcome
    summary: Optional[TraceSummary]

    @property
    def events(self) -> List[Tuple[str, int, int]]:
        t = self.outcome.trace
        return t.events if t is not None else []

    def idle_pct(self) -> Optional[float]:
        """Share of the traced window with no kernel running."""
        if self.summary is None or not self.summary.window_s:
            return None
        return 100.0 * (1.0 - self.summary.busy_s / self.summary.window_s)

    def ini(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """The cell's setting of the port's ``section.key``."""
        merged = {**self.cell.config["ini"], **self.cell.mix.get("ini", {})}
        return merged.get(key, default)

    def kernel_seconds(self, fragment: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        ``fragment``."""
        hits = [(b - a) for n, a, b in self.events if fragment in n]
        return sum(hits) / 1e9, len(hits)


class Context:
    """A driver's handle on the run: its settings, its recorder, and the
    window around the timed loop."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, rate: Optional[float] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.rate = rate  # the sweep's arrival rate in place of the mix's
        self.trace_on, self.device = bool(trace), device
        # an end-to-end metric read from the device's trace has the window
        # traced in every run on the card, not only in a traced one
        self.trace_window = self.trace_on or (device.type == "cuda" and any(
            m["source"] == "device_trace" for m in cell.end_to_end))
        self.recorder = Recorder()
        self.setup_s: Optional[float] = None
        self.trace: Optional[DeviceTrace] = None

    @contextlib.contextmanager
    def window(self):
        """Marks the end of set-up, resets the peak-memory counter and,
        in a traced run or for an end-to-end metric of the trace, traces
        the device until the window closes."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        self.setup_s = process_age()
        if self.trace_window:
            self.trace = DeviceTrace()
            self.trace.start()
        try:
            yield
        finally:
            if self.trace is not None:
                self.trace.stop()

    def peak_bytes(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())


def load_reader(name: str) -> Callable[[Run], Optional[float]]:
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def checks(compared: Dict[str, float], limits: Dict[str, float],
           failed: int) -> Dict[str, Dict[str, float]]:
    """The cell's numbers, those its limits name, each beside its limit;
    a request or batch that failed is a number too (limit 0). A number
    the limits name that the run did not give fails."""
    out = {"failed": {"value": float(failed), "limit": 0.0}}
    for k, limit in limits.items():
        out[k] = {"value": float(compared.get(k, MISSING)),
                  "limit": float(limit)}
    return out


def judge(outcome: Outcome, limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``correct`` and the checks it was decided by: every number the
    limits name within its limit, and no request or batch failed."""
    chk = checks(outcome.compared, limits, outcome.failed)
    return all(c["value"] <= c["limit"] for c in chk.values()), chk


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def device_name_and_limit() -> Tuple[str, str]:
    import torch

    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "unknown"
    return name, limit


def result(ctx: Context, outcome: Outcome) -> dict:
    """The result line's object; ``checks`` comes last."""
    cell = ctx.cell
    summary = (summarize(outcome.trace, outcome.recorder.spans)
               if ctx.trace_on and outcome.trace is not None else None)
    metrics: Dict[str, dict] = {}
    if not ctx.trace_on:
        values = {**outcome.e2e, "setup_s": ctx.setup_s}
        for m in cell.end_to_end:
            if m["name"] in values:  # a trace's metric: only on a card
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        run = Run(cell, outcome, summary)
        for m in cell.per_layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    name, power = device_name_and_limit()
    device = {"platform": "gpu", "kind": name, "count": cell.chips,
              "memory_peak_bytes": outcome.memory_peak_bytes,
              "power_limit": power}
    out: Dict[str, Any] = {}
    if summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    correct, chk = judge(outcome, cell.limits)
    return {"correct": correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device,
            **out, "checks": chk}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             rate: Optional[float] = None) -> int:
    import torch

    cell = load_cell(name)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"benchmark: {name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    driver = importlib.import_module(f"benchmark.drivers.{cell.mix['kind']}")
    ctx = Context(cell, seed, seconds, trace, torch.device("cuda", 0), rate)
    outcome = driver.run(ctx)
    found = forbidden_modules()
    if found:
        print("benchmark: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    res = result(ctx, outcome)
    for k, v in outcome.compared.items():
        if k not in res["checks"]:
            print(f"number {k} {v!r} (not compared in this cell)",
                  file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
