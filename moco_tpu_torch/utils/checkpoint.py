"""Checkpoint save and restore: the semantics of moco_tpu/utils/checkpoint.py
on `torch.save` / `torch.load` instead of Orbax.

- One file per global step, `<dir>/checkpoint_<step:08d>.pth.tar`, written
  under a temporary name, fsynced and `os.replace`d into place, so a
  reader sees the whole file or none of it.
- The last `keep` files are kept (`keep <= 0` keeps every one).
- `latest_step` runs a structural check (a non-empty file whose extras
  read back). A torn or unreadable newest file is quarantined under
  `<dir>/quarantine/` and the next older one answers; `restore` with no
  `step` falls back the same way through full reads, and raises
  `CheckpointCorruptionError` when every file fails. An explicit `step`
  never falls back. `validate_extra` runs before the state read, and its
  error propagates without quarantining anything: an incompatible config
  is not a corrupt file.
- `async_save=True` overlaps the write with training: `save()` returns
  once every tensor of the payload is copied into host buffers (pinned
  when the state is on the card) that no step touches, and the write,
  fsync, `os.replace` and keep-N pruning run on a background thread.
  The step updates the state in place, so the copy must be whole before
  `save()` returns: a background write of device tensors, or of host
  buffers the next snapshot refills, would mix two steps. The buffers are
  reused, so a save first waits for the previous write. `wait()` blocks
  until the write is durable and raises its error, if any; `latest_step`,
  `all_steps`, `read_extra`, `restore`, `close` and the `ckpt_truncate`
  fault wait first.
- `save_best` / `restore_best` / `best_exists`: the probe's `model_best`.

The pretraining payload is the reference's `.pth.tar` layout
(`main_moco.py:~L312-320`, `{'epoch', 'arch', 'state_dict', 'optimizer'}`):
`state_dict` holds `module.encoder_q.*` and `module.encoder_k.*` under
torchvision names (backbone keys bare, the projection head under `fc.*`),
`module.queue` as (dim, K) columns and `module.queue_ptr`, so
moco_tpu/import_torch.py reads a port checkpoint as it reads the
reference's. Beside them: `step`, the v3 `predictor` where there is one,
and `extra`, the JSON extras (`epoch`, `config`) as a string. `epoch` is
the reference's: the number of finished epochs. Files are read with
`weights_only=True`: a payload holds only tensors, numbers, strings, lists
and dicts.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Callable, Optional

import torch

from moco_tpu_torch.core.moco import TrainState
from moco_tpu_torch.models.heads import ProjectionHead
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.utils import faults, retry

_NAME = re.compile(r"^checkpoint_(\d+)\.pth\.tar$")
BEST_NAME = "model_best.pth.tar"


class CheckpointCorruptionError(RuntimeError):
    """Every checkpoint under the directory failed to restore (all
    quarantined): unlike a missing directory, never taken for a fresh
    start."""


def _write_atomic(path: str, payload: dict) -> None:
    tmp = os.path.join(os.path.dirname(path), f".{os.path.basename(path)}.tmp-{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load(path: str, mmap: bool = False) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=mmap)


def _extra_of(payload: dict) -> dict:
    return json.loads(payload.get("extra") or "{}")


def _tensors_of(tree) -> list:
    """The tensors of a payload (nested dicts and lists), in a fixed order."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors_of(v)]
    return []


def _replace_tensors(tree, tensors):
    """`tree` with its tensors replaced, in `_tensors_of`'s order, by the
    next items of the iterator `tensors`."""
    if torch.is_tensor(tree):
        return next(tensors)
    if isinstance(tree, dict):
        return {k: _replace_tensors(v, tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace_tensors(v, tensors) for v in tree)
    return tree


class CheckpointManager:
    """Checkpoints of one run, keyed by global step."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.async_save = async_save
        os.makedirs(self.directory, exist_ok=True)
        self._host: list = []  # async: host buffers, reused while the payload's layout holds
        # the async writer and its error, handed between the saving thread,
        # the writer thread and any waiter (the stall watchdog's emergency
        # save waits from a sidecar thread) under one lock
        self._lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{int(step):08d}.pth.tar")

    def save(self, step: int, payload: dict, extra: Optional[dict] = None,
             force: bool = False) -> str:
        """Write `payload` with `step` and the JSON `extra` at `step`, then
        drop the oldest files past `keep`; returns the file's path. Blocking
        unless `async_save`, then it returns once the payload is copied to
        host memory. `force` is the JAX signature's: the port has no save
        interval to bypass, so every save is written."""
        del force
        payload = {**payload, "step": int(step), "extra": json.dumps(extra or {})}
        path = self.path(step)
        with obs_span("checkpoint_save", step=int(step), asynchronous=self.async_save):
            if self.async_save:
                self.wait()  # the previous write still reads the host buffers
                payload = self._snapshot(payload)
                writer = threading.Thread(target=self._write_in_background,
                                          args=(path, payload), name="moco-ckpt-writer",
                                          daemon=True)
                with self._lock:
                    self._writer = writer
                writer.start()
            else:
                self._write(path, payload)
        faults.on_checkpoint_saved(path, int(step), wait=self.wait)
        return path

    @torch.no_grad()
    def _snapshot(self, payload: dict) -> dict:
        """`payload` with every tensor copied into this manager's host
        buffers, the copies finished: later in-place steps cannot reach it."""
        live = _tensors_of(payload)
        layout = [(t.shape, t.stride(), t.dtype) for t in live]
        if layout != [(h.shape, h.stride(), h.dtype) for h in self._host]:
            self._host = [torch.empty_like(t, device="cpu", pin_memory=t.is_cuda) for t in live]
        for h, t in zip(self._host, live):
            h.copy_(t, non_blocking=t.is_cuda)
        for dev in {t.device for t in live if t.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        return _replace_tensors(payload, iter(self._host))

    def _write(self, path: str, payload: dict) -> None:
        retry.retry_call(_write_atomic, path, payload, site="ckpt.save")
        if self.keep > 0:
            for old in self._steps_on_disk()[:-self.keep]:
                os.remove(self.path(old))

    def _write_in_background(self, path: str, payload: dict) -> None:
        try:
            self._write(path, payload)
        except BaseException as e:  # handed to the caller by wait()
            with self._lock:
                self._error = e

    def wait(self) -> None:
        """Block until the in-flight async write is durable; raise its error
        (once, to one waiter). Safe from several threads: each joins the
        writer it saw, and only that writer is cleared, never one a save
        started meanwhile."""
        with self._lock:
            writer = self._writer
        if writer is not None:
            writer.join()
        with self._lock:
            if self._writer is writer:
                self._writer = None
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(f"async checkpoint write under {self.directory} failed") from err

    def close(self) -> None:
        self.wait()

    def _steps_on_disk(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def all_steps(self) -> list[int]:
        """Step ids of the files in place, unvalidated, ascending."""
        self.wait()
        return self._steps_on_disk()

    def _read_extra_step(self, step: int) -> dict:
        # mmap: the tensors stay on disk, only the zip directory and the
        # pickled structure are read
        return _extra_of(retry.retry_call(_load, self.path(step), mmap=True, site="ckpt.restore"))

    def _structural_defect(self, step: int) -> Optional[str]:
        path = self.path(step)
        try:
            if os.path.getsize(path) == 0:
                return "zero-length file (torn write)"
        except OSError as e:
            return f"unreadable file: {e!r}"
        try:
            self._read_extra_step(step)
        except Exception as e:  # any failure to parse is a defect of the file
            return f"extras unreadable: {e!r}"
        return None

    def _quarantine(self, step: int, reason) -> None:
        """Move a bad file to `<dir>/quarantine/`, kept for post-mortem."""
        qdir = os.path.join(self.directory, "quarantine")
        os.makedirs(qdir, exist_ok=True)
        src = self.path(step)
        dst = os.path.join(qdir, os.path.basename(src))
        suffix = 0
        while os.path.exists(dst):
            suffix += 1
            dst = os.path.join(qdir, f"{os.path.basename(src)}.{suffix}")
        os.replace(src, dst)
        print(f"WARNING: checkpoint step {step} quarantined to {dst}: {reason}", flush=True)

    def latest_step(self) -> Optional[int]:
        """Newest step whose file passes the structural check; defective
        newer files are quarantined on the way."""
        self.wait()
        for step in reversed(self.all_steps()):
            reason = self._structural_defect(step)
            if reason is None:
                return step
            self._quarantine(step, reason)
        return None

    def read_extra(self, step: Optional[int] = None) -> dict:
        """The JSON extras alone (no state read): lets a tool find the
        training config before it builds anything."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return self._read_extra_step(step)

    def restore(self, step: Optional[int] = None,
                validate_extra: Optional[Callable[[dict], None]] = None) -> tuple[dict, dict]:
        """(payload, extra) of `step`, or of the newest good step, its
        tensors on the CPU: a file that fails to read is quarantined and
        the next older one tried, down to the oldest;
        `CheckpointCorruptionError` when every one fails. An explicit
        `step` reads that step or raises."""
        self.wait()
        explicit = step is not None
        candidates = [step] if explicit else list(reversed(self.all_steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        failures: list[tuple[int, str]] = []
        for s in candidates:
            try:
                extra = self._read_extra_step(s)
            except Exception as e:  # a defect of this file: quarantine it
                if explicit:
                    raise
                failures.append((s, repr(e)))
                self._quarantine(s, e)
                continue
            if validate_extra is not None:
                validate_extra(extra)  # incompatibility propagates, no quarantine
            try:
                with obs_span("checkpoint_restore", step=s):
                    payload = retry.retry_call(_load, self.path(s), site="ckpt.restore")
            except Exception as e:  # a defect of this file: quarantine it
                if explicit:
                    raise
                failures.append((s, repr(e)))
                self._quarantine(s, e)
                continue
            if failures:
                print(f"WARNING: restored fallback step {s} after quarantining "
                      f"{[f[0] for f in failures]}", flush=True)
            return payload, extra
        raise CheckpointCorruptionError(
            f"all {len(failures)} checkpoint(s) under {self.directory} failed to restore "
            f"and were quarantined: {failures}; inspect "
            f"{os.path.join(self.directory, 'quarantine')}")


def best_exists(directory: str) -> bool:
    return os.path.isfile(os.path.join(os.path.abspath(directory), BEST_NAME))


def save_best(directory: str, payload: dict, metric: float) -> None:
    """`model_best` (`main_lincls.py:~L250-260`): overwrite the single
    best-by-metric snapshot, atomically."""
    os.makedirs(directory, exist_ok=True)
    _write_atomic(os.path.join(os.path.abspath(directory), BEST_NAME),
                  {**payload, "metric": float(metric)})


def restore_best(directory: str) -> tuple[dict, float]:
    payload = _load(os.path.join(os.path.abspath(directory), BEST_NAME))
    return payload, float(payload["metric"])


# ------------------------------------------------- the pretraining payload


def _head_prefix(encoder) -> str:
    """Where the head's keys go in the reference layout: a ProjectionHead's
    own names are already `fc` / `fc.0` / `fc.2`; a v3 head's (`fc{i}`,
    `bn{i}`) go under `fc.`, clear of the backbone's `bn1`."""
    return "" if isinstance(encoder.head, ProjectionHead) else "fc."


def encoder_to_reference(encoder, sd: Optional[dict] = None) -> dict:
    """An encoder's state_dict (or `sd`, tensors under its names) under the
    reference's names: `backbone.X` -> `X`, `head.X` -> `fc...`."""
    head = _head_prefix(encoder)
    out = {}
    for k, v in (encoder.state_dict() if sd is None else sd).items():
        part, _, rest = k.partition(".")
        out[rest if part == "backbone" else head + rest] = v
    return out


def load_encoder_reference(encoder, sd: dict) -> None:
    """Load reference-named tensors into `encoder`, every key accounted
    for; a BN's `num_batches_tracked` may be absent (it stays as it is)."""
    head = _head_prefix(encoder)
    names = {}
    for k in encoder.state_dict():
        part, _, rest = k.partition(".")
        names[rest if part == "backbone" else head + rest] = k
    unexpected = sorted(set(sd) - set(names))
    missing = sorted(k for k in set(names) - set(sd) if not k.endswith("num_batches_tracked"))
    if unexpected or missing:
        raise KeyError(f"encoder keys differ: missing {missing[:5]}, unexpected {unexpected[:5]}")
    encoder.load_state_dict({names[k]: v for k, v in sd.items()}, strict=False)


def _split(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def state_payload(state: TrainState, arch: str, epoch: int,
                  tensors: Optional[dict] = None) -> dict:
    """The reference's payload of a train state; `epoch` is the number of
    finished epochs. `tensors` stands in for the live values (a
    StateSnapshot's copies): {"q", "k", "predictor": state dicts or None,
    "queue": (K, dim) rows or None, "queue_ptr": int, "optimizer": an
    optimizer state dict}.

    Under ZeRO (`state.zero`, parallel/zero.py) the payload is the same,
    whole tensors: the shards and the optimizer's rows are gathered, a
    collective that every rank must join; rank 0 then writes it. So is a
    queue sharded over the model ranks (`state.queue_world`): every model
    rank joins the gather of the whole (K, dim) queue."""
    if tensors is None and state.zero is not None:
        tensors = {**state.zero.full_state_dicts(), "queue": state.full_queue(),
                   "queue_ptr": state.queue_ptr,
                   "optimizer": state.zero.full_optimizer_state(state.optimizer)}
    if tensors is None:
        tensors = {"q": None, "k": None, "queue": state.full_queue(),
                   "queue_ptr": state.queue_ptr,
                   "optimizer": state.optimizer.state_dict(),
                   "predictor": None if state.predictor is None else state.predictor.state_dict()}
    sd = {}
    for side, enc in (("q", state.encoder_q), ("k", state.encoder_k)):
        sd.update({f"module.encoder_{side}.{k}": v
                   for k, v in encoder_to_reference(enc, tensors[side]).items()})
    if tensors["queue"] is not None:
        sd["module.queue"] = tensors["queue"].t().contiguous()  # (K, dim) rows -> (dim, K)
        sd["module.queue_ptr"] = torch.tensor([tensors["queue_ptr"]], dtype=torch.long)
    payload = {"epoch": int(epoch), "arch": arch, "state_dict": sd,
               "optimizer": tensors["optimizer"]}
    if tensors["predictor"] is not None:
        payload["predictor"] = tensors["predictor"]
    return payload


def load_state_payload(state: TrainState, payload: dict) -> None:
    """Load a `state_payload` into `state` in place, bit for bit: both
    encoders, the queue and its pointer, the predictor, the optimizer's
    state and the step. `state` must have been built by `create_state`
    from the same config, so its optimizer lists the parameters in the
    saved order. A ZeRO state takes any payload (whole tensors, whatever
    the layout and world it was saved under): its rank's rows of them; a
    sharded queue its model rank's rows of the whole queue."""
    sd = payload["state_dict"]
    z = state.zero
    if z is not None and z.stage23:
        z.materialize("q")
        z.materialize("k")
    for side, enc in (("q", state.encoder_q), ("k", state.encoder_k)):
        load_encoder_reference(enc, _split(sd, f"module.encoder_{side}."))
    if state.queue is not None:
        start, stop = state.queue_rows()
        state.queue.copy_(sd["module.queue"].t()[start:stop])
        state.queue_ptr = int(sd["module.queue_ptr"].reshape(-1)[0])
    if state.predictor is not None:
        state.predictor.load_state_dict(payload["predictor"])
    if z is None:
        state.optimizer.load_state_dict(payload["optimizer"])
    else:
        z.load_optimizer_state(state.optimizer, payload["optimizer"])
        z.shard_from_modules()
        if z.stage23:
            z.release("q")
            z.release("k")
    state.step = int(payload["step"])
