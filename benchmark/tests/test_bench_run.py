"""The command: it fails without a card and prints no result, and no
module a run loads has the top-level name jax, jaxlib, flax or yolojax."""

import json
import os
import subprocess
import sys
import textwrap

from benchmark import harness

ROOT = str(harness.ROOT)


def test_run_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "yolo2-voc-416.detect-b128", "--seed", "2147483999",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert not any(line.startswith("{") for line in
                   proc.stdout.splitlines())


def test_a_run_loads_no_jax():
    """A whole cell on the CPU (its set-up, window, reference and
    readers) in a process where importing jax or yolojax fails."""
    body = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax", "yolojax"):
            sys.modules[name] = None
        sys.path.insert(0, "benchmark/tests")
        from conftest import cpu_run, tiny_cell
        from benchmark import harness
        for name in ("yolo2-tiny-voc-416.http-poisson",
                     "yolo2-voc-416.detect-int8-b128"):
            ctx, out = cpu_run(tiny_cell(name))
            for m in ctx.cell.per_layer:
                harness.load_reader(m["name"])
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and m.split(".")[0] in harness.FORBIDDEN]
        print(json.dumps(loaded))
    """)
    proc = subprocess.run([sys.executable, "-c", "import json\n" + body],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []
