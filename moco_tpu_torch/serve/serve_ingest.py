"""Stream a live training run's dictionary into a serving replica, the
port of scripts/serve_ingest.py.

    python -m moco_tpu_torch.serve.serve_ingest --ckpt-dir /run/workdir \\
        --server http://127.0.0.1:8000 [--poll-s 10] [--block 512] [--once] \\
        [--fanout]

The training queue and the serving index share their FIFO write
(serve/index.py `fifo_write`). This tails a training run's checkpoint
directory and FIFO-ingests the freshly enqueued queue rows into a running
replica over its `/ingest` endpoint, so a long-lived replica tracks the
dictionary the trainer is still building without a restart.

Per new checkpoint step: read the newest checkpoint's queue and write head
(utils/checkpoint.py; no encoder is built), take the block enqueued since
the last head seen (`fresh_rows`: `[old_ptr, new_ptr)` circularly; the
first sighting sends the whole queue oldest-first so the replica starts
aligned), and POST it as raw f32 rows in blocks of `--block`, each with
the checkpoint step as `X-Ckpt-Step` and through the retry layer
(`utils/retry.py`, site `ingest.post`). The replica's IVF cells and int8
mirror follow each ingest, and `serve/ingested_rows`,
`serve/ingest_ckpt_step` and `serve/row_age_max_s` move in its flush.

Assumes fewer than K rows are enqueued between polled checkpoints (a whole
turnover of the queue with the same head looks like no change; shorten
`--poll-s` if the trainer outruns it).

With `--fanout`, `--server` is a fleet router (serve/router.py): the
replicas are read off its `/admin/replicas` (`discover_replicas`) and each
block goes to every one of them under its own retry site `ingest.post.r<i>`
(`fanout_rows`); a replica whose retries run out is reported and skipped,
the others still get the block, and the supervisor's warm replay realigns
it when it restarts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.request
from typing import Optional

import numpy as np

DEFAULT_BLOCK = 512  # rows per POST: bounds the request size

# injectable for tests (a flaky replica is simulated by swapping this)
_urlopen = urllib.request.urlopen


def fresh_rows(queue: np.ndarray, old_ptr, new_ptr: int) -> np.ndarray:
    """The block the trainer enqueued since the last sighting, in FIFO
    (oldest-first) order. `old_ptr=None` is the first sighting: the whole
    queue, oldest-first from the write head."""
    if old_ptr is None:
        return np.concatenate([queue[new_ptr:], queue[:new_ptr]])
    old_ptr = int(old_ptr)
    if new_ptr == old_ptr:
        return queue[:0]
    if new_ptr > old_ptr:
        return queue[old_ptr:new_ptr]
    return np.concatenate([queue[old_ptr:], queue[:new_ptr]])


def post_rows(server: str, rows: np.ndarray, block: int = DEFAULT_BLOCK,
              site: str = "ingest.post", ckpt_step: Optional[int] = None) -> int:
    """POST `rows` to the replica's `/ingest` in blocks of `block` rows;
    returns the replica's index row count after the last block.
    `ckpt_step` travels as `X-Ckpt-Step` (the replica's
    `serve/ingest_ckpt_step`). Each POST retries through `utils/retry.py`
    at `site`: urllib's errors are OSErrors, so a replica restart or a
    reset connection is a logged retry, not a lost block."""
    from moco_tpu_torch.utils import retry

    def _post(chunk: np.ndarray) -> int:
        headers = {"X-Rows-Shape": f"{chunk.shape[0]},{chunk.shape[1]}"}
        if ckpt_step is not None:
            headers["X-Ckpt-Step"] = str(int(ckpt_step))
        req = urllib.request.Request(server.rstrip("/") + "/ingest", data=chunk.tobytes(),
                                     headers=headers)
        with _urlopen(req, timeout=60) as r:
            return json.loads(r.read())["index_rows"]

    index_rows = -1
    for lo in range(0, rows.shape[0], block):
        chunk = np.ascontiguousarray(rows[lo : lo + block], np.float32)
        index_rows = retry.retry_call(_post, chunk, site=site)
    return index_rows


def discover_replicas(router: str) -> dict:
    """{replica index: base URL} from a fleet router's `/admin/replicas`:
    every replica it knows, draining or not."""
    with _urlopen(router.rstrip("/") + "/admin/replicas", timeout=10) as r:
        body = json.loads(r.read())
    return {int(rep["index"]): rep["url"] for rep in body["replicas"]}


def fanout_rows(router: str, rows: np.ndarray, block: int = DEFAULT_BLOCK,
                ckpt_step: Optional[int] = None) -> dict:
    """POST `rows` to every replica behind `router`, each under its own
    retry site (`ingest.post.r<i>`). Returns {index: index_rows, or None
    for a replica whose retries ran out (reported; the others still got
    the block)}."""
    results: dict = {}
    for index, url in sorted(discover_replicas(router).items()):
        try:
            results[index] = post_rows(url, rows, block, site=f"ingest.post.r{index}",
                                       ckpt_step=ckpt_step)
        except OSError as e:
            print(f"WARNING: replica {index} ({url}) dropped an ingest block after "
                  f"retries: {e!r}", flush=True)
            results[index] = None
    return results


def read_queue(ckpt_dir: str, step: Optional[int] = None) -> tuple[np.ndarray, int]:
    """The (K, dim) f32 queue rows and the write head of the checkpoint at
    `step` (the newest good one by default), read from its state dict."""
    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    payload, _ = CheckpointManager(ckpt_dir).restore(step)
    sd = payload["state_dict"]
    if "module.queue" not in sd:
        raise ValueError(f"the checkpoint under {ckpt_dir} holds no queue (a v3 run?)")
    queue = sd["module.queue"].t().float().contiguous().numpy()  # stored (dim, K)
    return queue, int(sd["module.queue_ptr"].reshape(-1)[0])


def poll_once(ckpt_dir: str, server: str, seen: dict, block: int = DEFAULT_BLOCK,
              fanout: bool = False) -> int:
    """One tail step: ingest anything new; returns the rows ingested.
    `seen` carries {"step", "ptr"} across polls. With `fanout`, `server` is
    a router and the block goes to every replica behind it."""
    from moco_tpu_torch.utils.checkpoint import CheckpointManager

    step = CheckpointManager(ckpt_dir).latest_step()
    if step is None or step == seen.get("step"):
        return 0
    queue, new_ptr = read_queue(ckpt_dir, step)
    rows = fresh_rows(queue, seen.get("ptr"), new_ptr)
    if rows.shape[0] and fanout:
        results = fanout_rows(server, rows, block, ckpt_step=step)
        summary = ", ".join(f"r{i}={'FAILED' if n is None else n}"
                            for i, n in sorted(results.items()))
        print(f"step {step}: fanned {rows.shape[0]} fresh rows to {len(results)} replicas "
              f"(index_rows: {summary})", flush=True)
    elif rows.shape[0]:
        index_rows = post_rows(server, rows, block, ckpt_step=step)
        print(f"step {step}: ingested {rows.shape[0]} fresh rows "
              f"(replica index_rows={index_rows})", flush=True)
    seen["step"], seen["ptr"] = step, new_ptr
    return int(rows.shape[0])


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="tail a training checkpoint dir into a serving replica (PyTorch port)")
    ap.add_argument("--ckpt-dir", required=True, help="the training run's workdir")
    ap.add_argument("--server", required=True, help="replica base URL, e.g. http://127.0.0.1:8000")
    ap.add_argument("--poll-s", type=float, default=10.0)
    ap.add_argument("--block", type=int, default=DEFAULT_BLOCK, help="rows per /ingest POST")
    ap.add_argument("--once", action="store_true", help="one poll, then exit")
    ap.add_argument("--fanout", action="store_true",
                    help="--server is a fleet router: discover the replicas through "
                    "/admin/replicas and ingest into every one")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from moco_tpu_torch.utils import retry

    seen: dict = {}
    while True:
        poll_once(args.ckpt_dir, args.server, seen, args.block, fanout=args.fanout)
        retries = retry.snapshot()
        if retries:
            print(f"io_retries: {json.dumps(retries)}", flush=True)
        if args.once:
            return 0
        time.sleep(args.poll_s)


if __name__ == "__main__":
    sys.exit(main())
