"""Open-loop HTTP load generator, standard library only, run as its own
process so that it shares no interpreter lock with the server.

    python3 perfbench/loadgen.py <plan.json> <records.json>

The plan holds ``port``, ``path``, ``connections``, ``offsets`` (seconds
after the start at which each request is due) and ``bodies`` (the JSON
bodies to POST). The generator opens its persistent connections, prints
``ready``, and starts the schedule when a line arrives on standard input.
A dispatcher hands each request, at its due time, to the first free
connection; a request is timed from its due time to the last byte of the
answer, so a late start counts against the system. Once every request has
an answer or ``deadline`` seconds have passed since the start, it writes
one record per request (due, sent and done times on the monotonic clock,
HTTP status, body) and prints its bookkeeping: requests sent, succeeded and
failed, and how late it sent them.
"""

from __future__ import annotations

import http.client
import json
import queue
import sys
import threading
import time


def main(plan_path: str, out_path: str) -> int:
    with open(plan_path) as f:
        plan = json.load(f)
    offsets, bodies = plan["offsets"], plan["bodies"]
    n = len(offsets)
    records: list[dict | None] = [None] * n
    jobs: queue.Queue = queue.Queue()
    conns = [http.client.HTTPConnection("127.0.0.1", plan["port"], timeout=plan["deadline"])
             for _ in range(plan["connections"])]
    for c in conns:
        c.connect()
    start = [0.0]

    def worker(conn: http.client.HTTPConnection) -> None:
        while True:
            i = jobs.get()
            if i is None:
                return
            sent = time.perf_counter()
            status, body = 0, ""
            try:
                conn.request("POST", plan["path"], bodies[i].encode(),
                             {"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read().decode()
                status = resp.status
            except (OSError, http.client.HTTPException) as exc:
                body = f"{type(exc).__name__}: {exc}"
                conn.close()
            done = time.perf_counter()
            records[i] = {"due": start[0] + offsets[i], "sent": sent, "done": done,
                          "status": status, "body": body}

    threads = [threading.Thread(target=worker, args=(c,), daemon=True) for c in conns]
    for t in threads:
        t.start()
    print("ready", flush=True)
    sys.stdin.readline()
    start[0] = t0 = time.perf_counter()
    for i, off in enumerate(offsets):
        wait = t0 + off - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        jobs.put(i)
    for _ in threads:
        jobs.put(None)
    end = t0 + plan["deadline"]
    for t in threads:
        t.join(timeout=max(0.0, end - time.perf_counter()))
    for c in conns:
        c.close()
    late = sorted((r["sent"] - r["due"]) for r in records if r is not None)
    ok = sum(1 for r in records if r is not None and r["status"] == 200)
    with open(out_path, "w") as f:
        json.dump({"start": t0, "records": records}, f)
    summary = {"loadgen_sent": n, "loadgen_answered": sum(r is not None for r in records),
               "loadgen_succeeded": ok, "loadgen_failed": n - ok,
               "loadgen_late_p50_ms": 1e3 * late[len(late) // 2] if late else None,
               "loadgen_late_max_ms": 1e3 * late[-1] if late else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
