"""ReplicaSupervisor: spawn, watch and resurrect serving replicas, the
port of moco_tpu/serve/fleet.py.

The router (serve/router.py) decides where requests go; the supervisor
keeps replicas there to send them to. It spawns N
`moco_tpu_torch.serve.replica_main` processes on ports claimed up front
(each port is taken in the parent and released just before the spawn, so
a replica's URL outlives its process and the router's handles never
move), on `device` (the card by default; the CPU tests pass "cpu"), then
a monitor thread polls the children:

- A replica that exits (a crash, the `kill@replica` fault, OOM) is
  respawned after a per-replica backoff that doubles per crash (reset
  once the reborn process answers healthy), its `MOCO_FAULTS` scrubbed of
  `kill@replica` rules (`utils/faults.strip_replica_kills`), so one chaos
  rule is one death, not a crash loop.
- After every (re)spawn the supervisor waits for `/healthz` (a replica
  binds its port only after its warm-up, so a refused connection means
  still warming) and replays the index bootstrap through the replica's
  `/ingest` in blocks of `WARM_INGEST_BLOCK` rows (`warm_rows_fn`; retry
  site `fleet.warm_ingest`): a reborn replica rejoins with a warm
  dictionary.
- `restart_replica(i)` is the graceful path the router's drain worker
  calls: SIGTERM (`replica_main` drains its batcher, so every accepted
  request is answered), wait for the exit (SIGKILL after a timeout),
  respawn, wait healthy, re-warm.

Every transition lands in `events()` (spawn, exit, warm, restart, with
exit codes), which the chaos check reads: `kill@replica=1` gives exactly
one exit with KILL_EXIT_CODE and one respawn. `set_ckpt_dir` retargets
the next spawns (the promotion swap).

Threading: one lock (`fleet.supervisor`) guards the child table and the
event log; spawns, waits and HTTP polls happen outside it. The monitor
thread is joined in `close()`.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, Optional

import numpy as np

from moco_tpu_torch.analysis.contracts import COVERAGE_FILE
from moco_tpu_torch.utils import faults, retry
from moco_tpu_torch.utils.locks import make_lock

WARM_INGEST_BLOCK = 512  # rows per /ingest POST during a warm replay


def free_port(host: str = "127.0.0.1") -> int:
    """Claim an ephemeral port and release it — the classic pre-spawn
    port reservation. Races are possible but vanishingly rare on a
    smoke host, and a lost race surfaces as a loud bind failure in the
    child's log, not a silent misroute."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        return s.getsockname()[1]


def default_replica_argv(
    ckpt_dir: str,
    workdir: Optional[str],
    index: int,
    port: int,
    host: str = "127.0.0.1",
    buckets=(1, 8, 32),
    slo_ms: float = 1000.0,
    fresh_max_age_s: float = 0.0,
    device: str = "cuda",
) -> list:
    """argv for one `moco_tpu_torch.serve.replica_main` child, serving on
    `device` (the card unless the caller asks for another)."""
    argv = [
        sys.executable, "-m", "moco_tpu_torch.serve.replica_main",
        "--ckpt-dir", str(ckpt_dir),
        "--host", host,
        "--port", str(port),
        "--replica-index", str(index),
        "--buckets", ",".join(str(b) for b in buckets),
        "--slo-ms", str(slo_ms),
        "--device", str(device),
    ]
    if fresh_max_age_s:
        argv += ["--fresh-max-age-s", str(float(fresh_max_age_s))]
    if workdir:
        argv += ["--workdir", os.path.join(workdir, f"replica{index}")]
    return argv


class _Child:
    """Supervisor-side state for one replica slot (mutated only under
    the supervisor lock; the Popen handle itself is poll()ed lock-free
    — poll() is thread-safe and the handle is replaced atomically)."""

    def __init__(self, index: int, port: int):
        self.index = index
        self.port = port
        self.proc: Optional[subprocess.Popen] = None
        self.restarting = False
        self.restarts = 0
        self.backoff_s = 0.0
        self.healthy_since: Optional[float] = None


class ReplicaSupervisor:
    """Spawn + supervise N replica processes (module docstring).

    Either pass `ckpt_dir` (children run `replica_main` with
    `default_replica_argv`) or an `argv_for(index, port) -> argv`
    callable for custom children (tests use a stdlib-only fake).
    `warm_rows_fn() -> (n, d) float32 rows` is the index bootstrap
    replayed into a reborn replica's `/ingest`; None skips the warm
    replay. `extra_env` maps replica index -> env overrides (the chaos
    smoke plants per-replica `MOCO_FAULTS` here).
    """

    def __init__(
        self,
        num_replicas: int,
        ckpt_dir: Optional[str] = None,
        argv_for: Optional[Callable[[int, int], list]] = None,
        workdir: Optional[str] = None,
        host: str = "127.0.0.1",
        buckets=(1, 8, 32),
        slo_ms: float = 1000.0,
        env: Optional[dict] = None,
        extra_env: Optional[dict] = None,
        warm_rows_fn: Optional[Callable[[], np.ndarray]] = None,
        boot_timeout_s: float = 180.0,
        term_timeout_s: float = 30.0,
        monitor_interval_s: float = 0.5,
        restart_backoff_s: float = 0.5,
        restart_backoff_cap_s: float = 10.0,
        auto_restart: bool = True,
        fresh_max_age_s: float = 0.0,
        device: str = "cuda",
    ):
        if num_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        # the SWAPPABLE checkpoint dir: the promotion pipeline calls
        # `set_ckpt_dir(candidate)` and then restarts replicas one at a
        # time — each respawn reads the CURRENT value, which is how a
        # staged rollout (and its rollback) changes the served encoder
        # without changing the replica's URL
        self._ckpt_dir = str(ckpt_dir) if ckpt_dir is not None else None
        self._custom_argv = argv_for is not None
        if argv_for is None:
            if ckpt_dir is None:
                raise ValueError("need ckpt_dir or argv_for")
            argv_for = lambda index, port: default_replica_argv(
                self._ckpt_dir, workdir, index, port,
                host=host, buckets=buckets, slo_ms=slo_ms,
                fresh_max_age_s=fresh_max_age_s, device=device,
            )
        self._argv_for = argv_for
        self.host = host
        self.workdir = workdir
        self._env = dict(env) if env is not None else dict(os.environ)
        self._extra_env = {int(k): dict(v) for k, v in (extra_env or {}).items()}
        self._warm_rows_fn = warm_rows_fn
        self.boot_timeout_s = float(boot_timeout_s)
        self.term_timeout_s = float(term_timeout_s)
        self.monitor_interval_s = float(monitor_interval_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.auto_restart = bool(auto_restart)
        self._lock = make_lock("fleet.supervisor")
        self._children = [
            _Child(i, free_port(host)) for i in range(int(num_replicas))
        ]
        self._events: list = []
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None

    # -- topology ---------------------------------------------------------

    def ckpt_dir(self) -> Optional[str]:
        """The checkpoint dir the NEXT (re)spawn serves from."""
        with self._lock:
            return self._ckpt_dir

    def set_ckpt_dir(self, path: str) -> None:
        """Point future (re)spawns at a different checkpoint dir — the
        promotion swap. Running replicas are untouched; the staged
        rollout restarts them one at a time through the router's drain
        path. Raises with a custom `argv_for` (the supervisor can't know
        how to thread the dir into a caller-built argv)."""
        if self._custom_argv:
            raise RuntimeError(
                "set_ckpt_dir needs the default replica argv (a custom "
                "argv_for owns its own checkpoint wiring)"
            )
        with self._lock:
            self._ckpt_dir = str(path)
        self._record("ckpt_swap", -1, ckpt_dir=str(path))

    def clear_extra_env(self, index: int) -> None:
        """Drop the per-replica env overrides for slot `index` so its
        NEXT respawn comes up clean — the chaos harness healing a
        replica. Persistent fault rules (e.g. a slow@ stage injected via
        MOCO_FAULTS) otherwise re-install on every respawn, and a
        staged rollout soaking on fleet burn gauges would (correctly)
        refuse to promote into a permanently-burning fleet."""
        with self._lock:
            self._extra_env.pop(int(index), None)
        self._record("heal", int(index))

    def url(self, index: int) -> str:
        return f"http://{self.host}:{self._children[index].port}"

    def urls(self) -> list:
        return [self.url(i) for i in range(len(self._children))]

    def events(self) -> list:
        with self._lock:
            return [dict(e) for e in self._events]

    def _record(self, kind: str, index: int, **extra) -> None:
        with self._lock:
            self._events.append(
                {"kind": kind, "replica": index, "t": time.monotonic(), **extra}
            )

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        """Spawn every replica, wait until ALL report healthy, then
        start the crash monitor. Boot is parallel across children (they
        warm up concurrently); the healthy-wait is sequential — by the
        time the first replica answers, the others are mid-warmup. A
        slot's contract-coverage dump (`<workdir>/replica<i>/`, where the
        default argv puts the replica's workdir) left by an earlier run is
        removed first: its respawns add to it from here."""
        for child in self._children:
            if self.workdir is not None:
                path = os.path.join(self.workdir, f"replica{child.index}", COVERAGE_FILE)
                if os.path.exists(path):
                    os.remove(path)
            self._spawn(child.index, scrub_kills=False)
        for child in self._children:
            self._wait_healthy(child.index)
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet_supervisor", daemon=True
        )
        self._monitor.start()

    def _child_env(self, index: int, scrub_kills: bool) -> dict:
        env = dict(self._env)
        with self._lock:
            overrides = dict(self._extra_env.get(index, {}))
        env.update(overrides)
        if scrub_kills and env.get("MOCO_FAULTS"):
            # a kill@replica rule already fired for this slot: the
            # reborn process must not inherit its own death warrant
            env["MOCO_FAULTS"] = faults.strip_replica_kills(env["MOCO_FAULTS"])
            if not env["MOCO_FAULTS"]:
                del env["MOCO_FAULTS"]
        return env

    def _spawn(self, index: int, scrub_kills: bool) -> None:
        child = self._children[index]
        argv = self._argv_for(index, child.port)
        proc = subprocess.Popen(argv, env=self._child_env(index, scrub_kills))
        with self._lock:
            child.proc = proc
            child.healthy_since = None
        self._record("spawn", index, pid=proc.pid, port=child.port)

    def _wait_healthy(self, index: int, timeout: Optional[float] = None) -> None:
        """Block until the replica answers /healthz ok (it binds HTTP
        only after AOT warmup, so connection-refused = still booting).
        Raises RuntimeError when the child died or the timeout passed."""
        child = self._children[index]
        deadline = time.monotonic() + (timeout or self.boot_timeout_s)
        url = self.url(index) + "/healthz"
        while time.monotonic() < deadline:
            proc = child.proc
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(
                    f"replica {index} exited rc={proc.returncode} during boot"
                )
            try:
                with urllib.request.urlopen(url, timeout=2.0) as r:
                    if json.loads(r.read()).get("ok"):
                        with self._lock:
                            child.healthy_since = time.monotonic()
                            child.backoff_s = 0.0  # recovery resets the backoff
                        return
            except (OSError, ValueError):
                pass
            time.sleep(0.2)
        raise RuntimeError(f"replica {index} not healthy after {self.boot_timeout_s}s")

    def _warm(self, index: int) -> int:
        """Re-play the index bootstrap into a reborn replica's /ingest
        (retry-wrapped, site fleet.warm_ingest) — the warm-dictionary
        guarantee. Returns rows replayed."""
        if self._warm_rows_fn is None:
            return 0
        rows = np.ascontiguousarray(self._warm_rows_fn(), np.float32)
        if rows.size == 0:
            return 0
        url = self.url(index) + "/ingest"

        def _post(chunk: np.ndarray) -> None:
            req = urllib.request.Request(
                url,
                data=chunk.tobytes(),
                headers={"X-Rows-Shape": f"{chunk.shape[0]},{chunk.shape[1]}"},
            )
            with urllib.request.urlopen(req, timeout=60) as r:
                r.read()

        for lo in range(0, rows.shape[0], WARM_INGEST_BLOCK):
            retry.retry_call(
                _post, rows[lo : lo + WARM_INGEST_BLOCK], site="fleet.warm_ingest"
            )
        self._record("warm", index, rows=int(rows.shape[0]))
        return int(rows.shape[0])

    def restart_replica(self, index: int, graceful: bool = True) -> None:
        """The drain worker's restart: SIGTERM (graceful — replica_main
        drains its batcher so accepted requests flush), wait for exit
        (SIGKILL past `term_timeout_s`), respawn with kill@replica
        rules scrubbed, wait healthy, re-warm the index. Blocking."""
        child = self._children[index]
        with self._lock:
            if child.restarting:
                return
            child.restarting = True
        try:
            proc = child.proc
            if proc is not None and proc.poll() is None:
                proc.send_signal(signal.SIGTERM if graceful else signal.SIGKILL)
                try:
                    proc.wait(timeout=self.term_timeout_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait(timeout=10.0)
            self._record(
                "exit", index,
                rc=proc.returncode if proc is not None else None,
                reason="restart",
            )
            with self._lock:
                child.restarts += 1
            self._spawn(index, scrub_kills=True)
            self._wait_healthy(index)
            self._warm(index)
            self._record("restart", index, graceful=graceful)
        finally:
            with self._lock:
                child.restarting = False

    # -- crash monitor ----------------------------------------------------

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.monitor_interval_s):
            for child in self._children:
                with self._lock:
                    restarting = child.restarting
                    proc = child.proc
                if restarting or proc is None:
                    continue
                rc = proc.poll()
                if rc is None:
                    continue
                self._record("exit", child.index, rc=rc, reason="crash")
                if not self.auto_restart or self._stop.is_set():
                    continue
                self._respawn_crashed(child, rc)

    def _respawn_crashed(self, child: _Child, rc: int) -> None:
        with self._lock:
            child.restarting = True
            child.restarts += 1
            backoff = child.backoff_s = min(
                self.restart_backoff_cap_s,
                child.backoff_s * 2 if child.backoff_s else self.restart_backoff_s,
            )
        print(
            f"supervisor: replica {child.index} exited rc={rc}; "
            f"respawning in {backoff:.1f}s",
            flush=True,
        )
        try:
            # the backoff sleep polls the stop flag so close() is prompt
            if self._stop.wait(backoff):
                return
            self._spawn(child.index, scrub_kills=True)
            self._wait_healthy(child.index)
            self._warm(child.index)
            self._record("restart", child.index, graceful=False, rc=rc)
        except Exception as e:  # the monitor must survive a failed respawn
            print(
                f"supervisor: respawn of replica {child.index} failed: {e!r}",
                flush=True,
            )
            self._record("respawn_failed", child.index, error=repr(e))
        finally:
            with self._lock:
                child.restarting = False

    def close(self) -> None:
        """Stop the monitor (joined — JX011), SIGTERM every child
        (graceful: their batchers drain), SIGKILL stragglers."""
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout=self.restart_backoff_cap_s + 30.0)
        for child in self._children:
            proc = child.proc
            if proc is None or proc.poll() is not None:
                continue
            proc.terminate()
        for child in self._children:
            proc = child.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=self.term_timeout_s)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)


__all__ = [
    "ReplicaSupervisor",
    "default_replica_argv",
    "free_port",
]
