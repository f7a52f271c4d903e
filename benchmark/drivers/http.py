"""The HTTP daemon under open-loop Poisson arrivals: ``cli/serve.py``'s
``build_server`` in this process (loopback, port 0, its default batcher),
``serve_forever`` on a thread, and clients that POST one PPM image a
request on a seeded schedule.

Mix keys: ``rate`` (requests/s; ``--rate`` replaces it for the sweep),
``sizes`` (image sizes, drawn in equal shares), ``pool`` (distinct
images, their order seeded), ``connections`` (client threads, each with
one keep-alive connection, in a process of their own:
``benchmark/loadgen.py``), ``sample`` (replies compared with the
reference, drawn from the seed, plus the first request of the largest
size), ``wait_s`` (how long after the window replies are awaited),
``batch`` and ``window_ms`` (the daemon's batching, 0 = its default
batch), ``control`` and ``ini`` as in ``detect``.

The arrivals are the same for every seed in another order: the gaps are
the quantiles (k + 0.5) / n of the exponential distribution, shuffled.
A request is timed from when it was due to when its reply arrived, so a
stall of the sender counts; how late the sender ran is recorded too. A
request that fails or gets no reply counts as missing: infinitely slow.
"""

from __future__ import annotations

import gc
import http.client
import json
import math
import pickle
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark import compare
from benchmark.drivers.detect import program_weights
from benchmark.harness import Context, Outcome, ini_overrides
from benchmark.inputs import make_images, make_weights, seeded_order, size_list
from benchmark.reference import detect as ref_detect
from benchmark.reference import network as ref_net


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds): shuffled exponential quantile gaps."""
    n = int(math.ceil(rate * seconds * 1.25)) + 1
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    due = np.cumsum(gaps[seeded_order(seed + 3, n)])
    return due[due < seconds]


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(values)
    return s[max(int(math.ceil(q / 100.0 * len(s))) - 1, 0)]


def post(port: int, body: bytes) -> int:
    """One request on a connection of its own; its status."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/detect", body,
                     {"Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        resp.read()
        return resp.status
    finally:
        conn.close()


class LoadGenerator:
    """``benchmark/loadgen.py`` in a process of its own, handed its job
    at set-up and started when the window opens."""

    def __init__(self, job: dict):
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve().parent.parent
                                 / "loadgen.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        pickle.dump(job, self.proc.stdin)
        self.proc.stdin.flush()
        if self.proc.stdout.readline() != b"ready\n":
            self.close()
            raise RuntimeError("benchmark: the load generator did not start")

    def run(self) -> Dict[int, tuple]:
        """Sends the schedule; the results by request."""
        self.proc.stdin.write(b"go\n")
        self.proc.stdin.flush()
        try:
            return pickle.load(self.proc.stdout)
        except (EOFError, pickle.UnpicklingError):
            return {}

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.proc.stdin.close()
        self.proc.stdout.close()


def get_json(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def reference_replies(ctx: Context, cfg, weights, bodies: List[bytes],
                      precision: str = "float32") -> List[dict]:
    """The reference's parse, letterbox, forward and decode of each body
    (its candidates), and its own top-K and NMS (its kept detections)."""
    config, dev, dim = ctx.cell.config, ctx.device, cfg.model.dim
    raws = [ref_detect.parse_ppm(b) for b in bodies]
    with torch.no_grad(), ref_net.float32_exact():
        folded = ref_net.fold(config, weights)
        canv = torch.stack([ref_detect.letterbox(
            torch.from_numpy(r.copy()).to(dev), dim) for r in raws])
        head = ref_net.forward_blocks(
            config, folded, canv,
            round_operands=None if precision == "float32" else precision)
        corners, scores = ref_detect.decode(head, config["anchors"])
        det = ref_detect.detections(corners, scores, top_k=cfg.detect.top_k,
                                    score_thresh=cfg.detect.threshold,
                                    iou_thresh=cfg.detect.nms_iou)
    return [{"corners": corners[j], "scores": scores[j], "w": raw.shape[1],
             "h": raw.shape[0], "dim": dim,
             "kept": {k: v[j][det["keep"][j]] for k, v in det.items()}}
            for j, raw in enumerate(raws)]


def as_replies(refs: List[dict]) -> List[dict]:
    """Reference detections written as the daemon writes its replies."""
    out = []
    for r in refs:
        k = r["kept"]
        px = ref_detect.to_pixels(k["boxes"], r["w"], r["h"], r["dim"])
        out.append({"detections": [
            {"class": int(c), "score": round(float(s), 5),
             "box": [round(float(v), 2) for v in box]}
            for c, s, box in zip(k["classes"], k["scores"], px)]})
    return out


def run(ctx: Context, control: Optional[dict] = None) -> Outcome:
    from yolojax_torch.cli.serve import build_server
    from yolojax_torch.config import load_config

    mix, rec, dev = ctx.cell.mix, ctx.recorder, ctx.device
    cfg = load_config([], ini_overrides(ctx.cell))
    weights = make_weights(ctx.cell.config, ctx.seed, dev)
    sizes = size_list(mix["sizes"], mix["pool"], ctx.seed)
    bodies = [ref_detect.encode_ppm(im.cpu().numpy())
              for im in make_images(sizes, ctx.seed, dev)]
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/weights.npz"
        program_weights(cfg, weights, path)
        httpd, batcher = build_server(
            cfg, "127.0.0.1", 0, weights=path, batch=mix["batch"],
            window_ms=mix["window_ms"], device=dev)
    server = threading.Thread(target=httpd.serve_forever,
                              name="bench-daemon", daemon=True)
    server.start()
    port = httpd.server_address[1]
    gen = None
    try:
        for size in {s: j for j, s in enumerate(sizes)}.values():
            post(port, bodies[size])  # each size's host path once
        due = schedule(ctx.rate or mix["rate"], ctx.seconds, ctx.seed)
        order = [j % len(bodies) for j in range(len(due))]
        rng = np.random.default_rng(ctx.seed + 4)
        sample = set(rng.choice(len(due), min(mix["sample"], len(due)),
                                replace=False).tolist())
        largest = max(range(len(sizes)),
                      key=lambda j: sizes[j][0] * sizes[j][1])
        sample.update([j for j, b in enumerate(order) if b == largest][:1])
        gen = LoadGenerator({
            "port": port, "connections": mix["connections"],
            "bodies": bodies, "order": order, "due": due.tolist(),
            "sample": sorted(sample), "wait_s": mix["wait_s"]})
        batch = get_json(port, "/healthz")["batch"]
        before = get_json(port, "/stats")
        with ctx.window():
            t0 = time.perf_counter()
            results = gen.run()
            elapsed = time.perf_counter() - t0
        after = get_json(port, "/stats")
    finally:
        if gen is not None:
            gen.close()
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        server.join(timeout=30)
    for r in results.values():
        rec.add("request in flight", r[4], r[5])
    peak = ctx.peak_bytes()
    del httpd, batcher
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ok = {j: r for j, r in results.items() if r[0] == 200}
    lat = [ok[j][1] if j in ok else math.inf for j in range(len(due))]
    failed = len(due) - len(ok)
    batches = after["batches"] - before["batches"]
    rec.counters.update(
        requests=len(due), seconds=elapsed, batches=batches,
        images=after["images"] - before["images"], batch=batch,
        p50_ms=percentile(lat, 50) * 1e3,
        lag_p95_ms=percentile([r[2] for r in results.values()], 95) * 1e3
        if results else math.inf)
    picked = sorted(j for j in sample if j in ok)
    refs = reference_replies(ctx, cfg, weights,
                             [bodies[order[j]] for j in picked])
    if control is not None:
        replies = as_replies(reference_replies(
            ctx, cfg, weights, [bodies[order[j]] for j in picked],
            control["reference"]))
    else:
        replies = [json.loads(ok[j][3]) for j in picked]
    compared = compare.compare_replies(
        replies, refs, score_thresh=cfg.detect.threshold,
        iou_thresh=cfg.detect.nms_iou, top_k=cfg.detect.top_k)
    third = max(len(lat) // 3, 1)
    print(f"http: {len(replies)} replies compared, "
          f"{sum(len(r['detections']) for r in replies)} detections; "
          f"{len(ok) / elapsed:.2f} replies/s; median latency of the last "
          f"third over the first: "
          f"{percentile(lat[-third:], 50) / percentile(lat[:third], 50):.3f}",
          file=sys.stderr)
    p95 = percentile(lat, 95)
    return Outcome(attempted=len(due), failed=failed,
                   e2e={"http_p95_ms": float(p95 if p95 < math.inf
                                              else mix["wait_s"] + ctx.seconds)
                        * 1e3,
                        "peak_mem_gib": peak / 2 ** 30},
                   compared=compared, memory_peak_bytes=peak, recorder=rec,
                   trace=ctx.trace)
