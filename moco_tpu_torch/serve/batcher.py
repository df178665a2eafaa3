"""Continuous batching under a latency SLO, the counterpart of
moco_tpu/serve/batcher.py (standard library only).

Requests enqueue from any number of client threads; one batcher thread
coalesces them into micro-batches, flushing when the pending rows reach
`max_batch` (the engine's largest bucket) or when the oldest pending
request has waited `slo_ms / 2`, runs the engine call on its own thread,
and scatters the result rows back to each request's future.

The submit queue is bounded, every blocking put polls a stop flag,
`close()` fails all pending futures with `BatcherClosedError` and joins
the thread, and `drain()` flushes what was accepted before it closes.

A `warmup` callable runs on the batcher thread before it takes its first
request, and `wait_warm()` blocks until it has (re-raising its error).
PyTorch keeps state per thread behind each convolution shape (not just
its cuDNN and cuBLAS handles), so a warm-up on the thread that built the
engine leaves the thread that serves cold: on an H100 its first flush of
each bucket paid over a second (PERF.md §5). The server's pass runs every
prepared shape once on this thread; `warm_thread_ident` records which
thread ran it.

Request tracing (obs/reqtrace.py): a future may carry a `RequestTrace`;
the batcher thread stamps `queue_wait` (per request) and the stages its
flush shares with every rider (`batch_assemble`, `engine_execute`,
`index_query`, `scatter`) onto it, perf_counter pairs only. A `run_batch`
with a keyword-only `stages` parameter splits `engine_execute` from
`index_query` (the engine waits on the card inside each stage's window
to do so). With `reqtrace=True` the batcher allocates traces for submits
that carry none; with tracing off the per-request cost is a `None` check.
`ServeMetrics` keeps the stage means (`serve/trace_<stage>_ms`), the SLO
burn rates of an attached `SLOBurnTracker` (`serve/burn_rate_<w>s`), the
sampled online recall (`serve/recall_estimate`) and the p99 exemplar.
The `slow@site=serve.batch_assemble` and `serve.scatter` faults sleep
inside their stages.
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from bisect import bisect_left
from collections import deque
from typing import Callable, Optional

import numpy as np

from moco_tpu_torch.obs.reqtrace import RequestIdAllocator, RequestTrace
from moco_tpu_torch.utils import faults
from moco_tpu_torch.utils.locks import make_lock

# cumulative latency histogram bounds (ms) of `serve/latency_hist`
LATENCY_BUCKETS_MS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
)
LATENCY_WINDOW = 2048  # requests behind the p50 / p99 gauges


class BatcherClosedError(RuntimeError):
    """The batcher shut down before (or while) handling this request."""


def _responsive_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that stays responsive to a stop flag; False = stopped."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class ServeFuture:
    """Single-assignment result handle: `result(timeout)` blocks until
    the batcher scatters this request's rows back (or fails it)."""

    def __init__(self, num_rows: int, submitted_at: float, want_neighbors: bool,
                 mode: Optional[str] = None, trace: Optional[RequestTrace] = None):
        self.num_rows = num_rows
        self.submitted_at = submitted_at
        self.want_neighbors = want_neighbors
        self.mode = mode  # neighbor tier this rider asked for (None = default)
        self.trace = trace  # request-scoped waterfall (None = tracing off)
        self._done = threading.Event()
        self._value: Optional[dict] = None
        self._error: Optional[BaseException] = None
        self.latency_s: Optional[float] = None

    def _resolve(self, value: dict) -> None:
        self.latency_s = time.perf_counter() - self.submitted_at
        self._value = value
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self.latency_s = time.perf_counter() - self.submitted_at
        self._error = error
        self._done.set()

    def result(self, timeout: Optional[float] = None) -> dict:
        if not self._done.wait(timeout):
            raise TimeoutError("serve request still pending")
        if self._error is not None:
            raise self._error
        return self._value


class ServeMetrics:
    """Thread-safe serving gauges; `payload()` is the `serve/*` line. `burn`
    (obs/slo.py) gets one ok/violation observation per completed request."""

    def __init__(self, slo_ms: float, burn=None):
        self.slo_ms = float(slo_ms)
        self._lock = make_lock("serve.metrics")
        self._latencies_ms: deque = deque(maxlen=LATENCY_WINDOW)
        self._recalls: deque = deque(maxlen=LATENCY_WINDOW)
        self.burn = burn
        self._exemplar: Optional[tuple[float, str]] = None  # (ms, request_id)
        # per-stage request-trace sums over the current payload window
        self._stage_sums_ms: dict[str, float] = {}
        self._stage_reqs = 0
        self._bucket_counts: dict[int, int] = {}
        self._valid_rows = 0
        self._padded_rows = 0
        self._completed = 0
        self._violations = 0
        self._win_t0 = time.perf_counter()
        self._win_completed = 0
        self._hist_counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)
        self._hist_sum_ms = 0.0
        # per-tier request counts: explicit ?mode= riders under their tier,
        # the rest under "default"
        self._mode_counts: dict[str, int] = {}

    def record_recall(self, recall: float) -> None:
        """One sampled recall@k observation of the approximate tier against
        the exact one on the same queries; `serve/recall_estimate` is the
        window's mean."""
        with self._lock:
            self._recalls.append(float(recall))

    def record_request(self, latency_s: float, request_id: Optional[str] = None,
                       trace: Optional[RequestTrace] = None,
                       mode: Optional[str] = None) -> None:
        ms = latency_s * 1e3
        with self._lock:
            key = mode or "default"
            self._mode_counts[key] = self._mode_counts.get(key, 0) + 1
            self._latencies_ms.append(ms)
            self._completed += 1
            self._win_completed += 1
            if ms > self.slo_ms:
                self._violations += 1
            self._hist_counts[bisect_left(LATENCY_BUCKETS_MS, ms)] += 1
            self._hist_sum_ms += ms
            if request_id is not None and (self._exemplar is None or ms > self._exemplar[0]):
                self._exemplar = (ms, request_id)
            if trace is not None:
                for stage, dur_ms in trace.stage_ms().items():
                    self._stage_sums_ms[stage] = self._stage_sums_ms.get(stage, 0.0) + dur_ms
                self._stage_reqs += 1
        if self.burn is not None:
            self.burn.record(ms <= self.slo_ms)

    def record_flush(self, executed: list[tuple[int, int]]) -> None:
        with self._lock:
            for bucket, valid in executed:
                self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1
                self._padded_rows += bucket
                self._valid_rows += valid

    def payload(self) -> dict:
        """`serve/*` fields; qps, the stage means and the exemplar are over
        the window since the previous payload() call."""
        with self._lock:
            now = time.perf_counter()
            qps = self._win_completed / max(now - self._win_t0, 1e-9)
            self._win_t0, self._win_completed = now, 0
            lat = sorted(self._latencies_ms)
            pct = lambda p: (
                lat[min(int(p * (len(lat) - 1) + 0.5), len(lat) - 1)] if lat else None
            )
            out = {
                "serve/p50_ms": pct(0.50),
                "serve/p99_ms": pct(0.99),
                "serve/qps": qps,
                "serve/occupancy": (
                    self._valid_rows / self._padded_rows if self._padded_rows else None
                ),
                "serve/requests": self._completed,
                "serve/slo_violations": self._violations,
                "serve/slo_ms": self.slo_ms,
                # null until the first sample (and without the estimator)
                "serve/recall_estimate": (
                    sum(self._recalls) / len(self._recalls) if self._recalls else None
                ),
                "serve/latency_hist": {
                    "le": list(LATENCY_BUCKETS_MS),
                    "counts": list(self._hist_counts),
                    "sum": round(self._hist_sum_ms, 3),
                    "count": self._completed,
                    **({"exemplar": {"request_id": self._exemplar[1],
                                     "latency_ms": round(self._exemplar[0], 3)}}
                       if self._exemplar is not None else {}),
                },
                # the window's worst request (null with tracing off)
                "serve/p99_exemplar": self._exemplar[1] if self._exemplar is not None else None,
                "serve/p99_exemplar_ms": (
                    round(self._exemplar[0], 3) if self._exemplar is not None else None
                ),
            }
            if self._stage_reqs:
                for stage, total in sorted(self._stage_sums_ms.items()):
                    out[f"serve/trace_{stage}_ms"] = round(total / self._stage_reqs, 3)
                out["serve/trace_requests"] = self._stage_reqs
            self._exemplar = None
            self._stage_sums_ms = {}
            self._stage_reqs = 0
            for bucket, count in sorted(self._bucket_counts.items()):
                out[f"serve/bucket_{bucket}"] = count
            for m, count in sorted(self._mode_counts.items()):
                out[f"serve/mode_{m}"] = count
        if self.burn is not None:
            out.update(self.burn.payload())
        return out


class ContinuousBatcher:
    """Micro-batch coalescing front end over an engine-shaped callable.

    `run_batch(images, want_neighbors) -> (dict of row-arrays, executed)`;
    a `run_batch` with three positional parameters also receives the
    sorted tuple of the neighbor modes the micro-batch's riders asked for,
    and one with a keyword-only `stages` parameter gets a dict to
    accumulate `engine_execute` / `index_query` seconds in when a rider is
    traced. Every returned array's rows align with the input rows, so the
    scatter is a slice. `max_batch` is normally the engine's largest
    bucket; `reqtrace=True` allocates a trace (ids `r<replica_index>-<n>`)
    for each submit that carries none."""

    def __init__(
        self,
        run_batch: Callable,
        max_batch: int,
        slo_ms: float = 100.0,
        queue_depth: int = 256,
        metrics: Optional[ServeMetrics] = None,
        reqtrace: bool = False,
        replica_index: int = 0,
        warmup: Optional[Callable[[], None]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        params = inspect.signature(run_batch).parameters
        positional = [
            p for p in params.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ]
        self._pass_modes = len(positional) >= 3
        self._pass_stages = "stages" in params
        self._ids = RequestIdAllocator(replica_index) if reqtrace else None
        self.max_batch = int(max_batch)
        self.slo_ms = float(slo_ms)
        # half the SLO budget may be spent coalescing; the rest belongs
        # to the compute + scatter
        self.deadline_s = self.slo_ms / 2e3
        self.metrics = metrics or ServeMetrics(slo_ms)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drained = threading.Event()
        self._warmup = warmup
        self._warm = threading.Event()
        # the warm-up's error, written on the batcher thread and read on the
        # callers': one lock on both sides
        self._warm_lock = threading.Lock()
        self._warm_error: Optional[BaseException] = None
        self.warm_thread_ident: Optional[int] = None  # the thread the warm-up ran on
        self.warm_s: Optional[float] = None  # how long it took
        self._thread = threading.Thread(target=self._loop, name="serve_batcher", daemon=True)
        self._thread.start()

    # -- warm-up ---------------------------------------------------------

    def _run_warmup(self) -> bool:
        """The batcher thread's own warm-up, before any request; False when
        it raised (the batcher then stops, and `wait_warm` re-raises)."""
        t0 = time.perf_counter()
        try:
            if self._warmup is not None:
                self._warmup()
                self.warm_thread_ident = threading.get_ident()
        except BaseException as e:  # surfaced by wait_warm on the caller's thread
            with self._warm_lock:
                self._warm_error = e
            self._stop.set()
            return False
        finally:
            self.warm_s = time.perf_counter() - t0
            self._warm.set()
        return True

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        """Block until the batcher thread's warm-up has run: True once it
        has, False on timeout; its error, if it raised, is raised here."""
        done = self._warm.wait(timeout)
        with self._warm_lock:
            err = self._warm_error
        if err is not None:
            raise err
        return done

    @property
    def warm(self) -> bool:
        """The warm-up ran, without error."""
        with self._warm_lock:
            return self._warm.is_set() and self._warm_error is None

    # -- client side -----------------------------------------------------

    def submit(self, images: np.ndarray, want_neighbors: bool = False,
               mode: Optional[str] = None, trace: Optional[RequestTrace] = None) -> ServeFuture:
        """Enqueue an (n, H, W, C) uint8 request; returns its future. `trace`
        is an ingress-stamped RequestTrace (allocated under reqtrace=True
        when None). Raises BatcherClosedError when the batcher is shut or
        draining."""
        images = np.asarray(images, np.uint8)
        if images.ndim != 4 or images.shape[0] < 1:
            raise ValueError(f"request must be (n>=1, H, W, C) uint8, got {images.shape}")
        if trace is None and self._ids is not None:
            trace = self._ids.new_trace(images.shape[0])
        fut = ServeFuture(images.shape[0], time.perf_counter(), want_neighbors, mode, trace)
        if self._draining.is_set():
            raise BatcherClosedError("batcher is draining")
        if self._stop.is_set() or not _responsive_put(self._q, self._stop, (images, fut)):
            raise BatcherClosedError("batcher is closed")
        return fut

    # -- batcher thread --------------------------------------------------

    def _flush(self, pending: list) -> None:
        if not pending:
            return
        # queue_wait closes for every rider as its flush begins; the other
        # stages are shared by the flush's riders (obs/reqtrace.py)
        t_flush = time.perf_counter()
        tracing = any(f.trace is not None for _, f in pending)
        if tracing:
            for _, fut in pending:
                if fut.trace is not None:
                    fut.trace.stamp("queue_wait", fut.submitted_at, t_flush)
        faults.maybe_slow("serve.batch_assemble")
        images = np.concatenate([img for img, _ in pending])
        t_assembled = time.perf_counter()
        want_neighbors = any(f.want_neighbors for _, f in pending)
        kw = {"stages": {}} if (tracing and self._pass_stages) else {}
        try:
            t_run0 = time.perf_counter()
            if self._pass_modes:
                modes = tuple(sorted(
                    {f.mode for _, f in pending if f.want_neighbors and f.mode}
                ))
                results, executed = self._run_batch(images, want_neighbors, modes, **kw)
            else:
                results, executed = self._run_batch(images, want_neighbors, **kw)
            t_run1 = time.perf_counter()
        except Exception as e:  # the batch's riders get the error, the thread lives on
            for _, fut in pending:
                fut._fail(e)
            return
        self.metrics.record_flush(executed)
        if tracing:
            # contiguous engine / query intervals from the run's start: the
            # durations are exact; host time the stages did not cover rides
            # the engine stage
            stages = kw.get("stages")
            if stages:
                engine_s = stages.get("engine_execute", 0.0)
                query_s = stages.get("index_query", 0.0)
                engine_s += max((t_run1 - t_run0) - engine_s - query_s, 0.0)
            else:
                engine_s, query_s = t_run1 - t_run0, 0.0
        faults.maybe_slow("serve.scatter")
        t_scatter = time.perf_counter()
        offset = 0
        for _, fut in pending:
            rows = slice(offset, offset + fut.num_rows)
            tr = fut.trace
            if tr is not None:
                tr.stamp("batch_assemble", t_flush, t_assembled)
                tr.stamp("engine_execute", t_run0, t_run0 + engine_s)
                if query_s > 0.0:
                    tr.stamp("index_query", t_run0 + engine_s, t_run0 + engine_s + query_s)
                # scatter closes at THIS request's resolve, so its stage sum
                # tracks its measured latency
                tr.stamp("scatter", t_scatter, time.perf_counter())
            fut._resolve({k: v[rows] for k, v in results.items()})
            offset += fut.num_rows
            self.metrics.record_request(fut.latency_s,
                                        request_id=tr.req_id if tr is not None else None,
                                        trace=tr, mode=fut.mode)

    def _loop(self) -> None:
        pending: list = []
        rows = 0
        if not self._run_warmup():
            self._fail_queued("batcher warm-up failed")
            self._drained.set()
            return
        while not self._stop.is_set():
            draining = self._draining.is_set()
            if pending:
                timeout = self.deadline_s - (time.perf_counter() - pending[0][1].submitted_at)
                # draining with an empty queue: nobody else is coming, so
                # flush now instead of idling out the deadline
                if timeout <= 0 or rows >= self.max_batch or (draining and self._q.empty()):
                    self._flush(pending)
                    pending, rows = [], 0
                    continue
            elif draining and self._q.empty():
                break  # graceful exit: everything accepted was flushed
            else:
                timeout = 0.05  # idle poll so close() never waits long
            try:
                images, fut = self._q.get(timeout=min(timeout, 0.05))
            except queue.Empty:
                continue
            pending.append((images, fut))
            rows += fut.num_rows
            if rows >= self.max_batch:
                self._flush(pending)
                pending, rows = [], 0
        # on stop, everything still queued or pending fails fast so no
        # client blocks on a future that will never resolve
        for _, fut in pending:
            fut._fail(BatcherClosedError("batcher closed with request pending"))
        self._fail_queued("batcher closed with request queued")
        self._drained.set()

    def _fail_queued(self, why: str) -> None:
        while True:
            try:
                _, fut = self._q.get_nowait()
            except queue.Empty:
                return
            fut._fail(BatcherClosedError(why))

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown: stop intake, flush every accepted rider, then
        close. True when the flush finished inside `timeout`."""
        self._draining.set()
        drained = self._drained.wait(timeout)
        self.close()
        return drained

    def close(self, timeout: float = 10.0) -> None:
        """Stop, fail all pending/queued futures, join the thread."""
        self._stop.set()
        self._thread.join(timeout=timeout)
        # a producer may have enqueued between the thread's drain and its exit
        self._fail_queued("batcher is closed")

    @property
    def closed(self) -> bool:
        return self._stop.is_set()


__all__ = [
    "BatcherClosedError",
    "ContinuousBatcher",
    "LATENCY_BUCKETS_MS",
    "ServeFuture",
    "ServeMetrics",
]
