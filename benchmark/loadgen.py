"""The HTTP cell's clients, in a process of their own, so that they share
no interpreter lock with the daemon they load: a user's clients run
elsewhere. The driver (``drivers/http.py``) starts this module, writes it
the job (a pickle on standard input), waits for ``ready``, then writes
``go`` when its window opens; this process sends every request on its
schedule, waits for the replies, writes the results (a pickle on standard
output) and exits.

The job: ``port``, ``connections`` (client threads, each with one
keep-alive connection), ``bodies`` (the distinct request bodies),
``order`` (the body of each request), ``due`` (each request's due time,
seconds after ``go``), ``sample`` (requests whose reply bytes are kept)
and ``wait_s`` (how long after the last due time replies are awaited).

A result, by request: (HTTP status or 0, seconds from due to reply,
seconds from due to send, the reply's bytes if sampled, send and reply
times in unix ns). A request with no reply by the deadline has none.
"""

from __future__ import annotations

import http.client
import os
import pickle
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait


def main() -> None:
    job = pickle.load(sys.stdin.buffer)
    local = threading.local()
    lock = threading.Lock()
    results = {}
    bodies, order, sample = job["bodies"], job["order"], set(job["sample"])

    def send(j: int, at: float) -> None:
        t_send = time.perf_counter()
        s0 = time.time_ns()
        conn = getattr(local, "conn", None)
        if conn is None:
            conn = local.conn = http.client.HTTPConnection(
                "127.0.0.1", job["port"], timeout=120)
        try:
            conn.request("POST", "/detect", bodies[order[j]],
                         {"Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            status, data = resp.status, resp.read()
        except (OSError, http.client.HTTPException):
            conn.close()
            local.conn = None
            status, data = 0, b""
        t_done = time.perf_counter()
        with lock:
            results[j] = (status, t_done - at, t_send - at,
                          data if j in sample else b"", s0, time.time_ns())

    pool = ThreadPoolExecutor(max_workers=job["connections"],
                              thread_name_prefix="bench-client")
    sys.stdout.buffer.write(b"ready\n")
    sys.stdout.buffer.flush()
    sys.stdin.buffer.readline()
    t0 = time.perf_counter()
    futures = []
    for j, d in enumerate(job["due"]):
        delay = t0 + d - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.append(pool.submit(send, j, t0 + d))
    wait(futures, timeout=max(t0 + job["due"][-1] + job["wait_s"]
                              - time.perf_counter(), 0.001)
         if len(job["due"]) else 0.001)
    with lock:
        done = dict(results)
    pickle.dump(done, sys.stdout.buffer)
    sys.stdout.buffer.flush()
    # a reply still missing leaves its thread blocked: exit without it
    os._exit(0)


if __name__ == "__main__":
    main()
