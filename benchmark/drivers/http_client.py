"""One open-loop HTTP client process of the serving driver. It imports no
torch: it reads its share of the schedule, builds each request's body from
the seeded image pool, sends it when it is due (from a pool of sender
threads, so a slow answer never holds back the next send), and prints one
JSON line with every request's record: its index, when it was due, how late
it was sent, when its answer came (all on CLOCK_MONOTONIC, which every
process of the machine shares), its status, and the answer's rows.

    python3 -m benchmark.drivers.http_client <plan.json>
"""

from __future__ import annotations

import http.client
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SENDERS = 48  # threads per client process
TIMEOUT_S = 90.0


def image_pool(seed: int, size: int, n: int) -> np.ndarray:
    """(n, size, size, 3) uint8: image j is
    `np.random.default_rng((seed, 7, j)).integers(0, 256, ...)`."""
    return np.stack([np.random.default_rng((seed, 7, j)).integers(0, 256, (size, size, 3),
                                                                    dtype=np.uint8)
                     for j in range(n)])


def request_images(pool: np.ndarray, start: int, n: int) -> np.ndarray:
    return pool[(start + np.arange(n)) % len(pool)]


def send(port: int, path: str, body: bytes, shape) -> tuple[int, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT_S)
    try:
        conn.request("POST", path, body=body,
                     headers={"X-Image-Shape": ",".join(map(str, shape)),
                              "Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, (json.loads(data) if resp.status == 200 else {})
    finally:
        conn.close()


def main(plan_path: str) -> int:
    with open(plan_path) as f:
        plan = json.load(f)
    pool = image_pool(plan["seed"], plan["image_size"], plan["pool"])
    t0 = plan["t0"]
    keep = plan.get("keep", "rows")
    records, lock = [], threading.Lock()

    def one(req):
        i, due, start, n = req
        imgs = request_images(pool, start, n)
        sent = time.monotonic()
        try:
            status, body = send(plan["port"], plan["path"], imgs.tobytes(), imgs.shape)
        except (OSError, http.client.HTTPException, ValueError) as e:
            status, body = -1, {"error": repr(e)}
        done = time.monotonic()
        rec = {"i": i, "due": due, "late": sent - (t0 + due), "done": done - t0,
               "status": status}
        if status == 200 and keep == "rows":
            rec["indices"], rec["scores"] = body.get("indices"), body.get("scores")
            rec["request_id"] = body.get("request_id")
        with lock:
            records.append(rec)

    with ThreadPoolExecutor(max_workers=SENDERS) as ex:
        futures = []
        for req in plan["requests"]:
            wait = t0 + req[1] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            futures.append(ex.submit(one, req))
        for fut in futures:
            fut.result()
    if "torch" in sys.modules:  # the load generator must stay light
        raise RuntimeError("the client process imported torch")
    print(json.dumps({"records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
