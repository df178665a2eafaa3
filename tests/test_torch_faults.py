"""The port's stall watchdog and its `stall` / `preempt` faults
(moco_tpu_torch/utils/watchdog.py, utils/faults.py) against the JAX
package's: moco_tpu's four watchdog tests (tests/test_faults.py) run on the
port's class, every one with an injected `exit_fn` so no thread can end
the process; the fault grammar parses and describes as JAX's; each rule
fires once. No test sends a real signal: `os.kill` is replaced by a
recorder."""

import os
import signal
import time

import pytest

from moco_tpu.utils import faults as jax_faults
from moco_tpu.utils.contracts import EXIT_CODES as JAX_EXIT_CODES
from moco_tpu_torch.utils import contracts, faults
from moco_tpu_torch.utils.watchdog import STALL_EXIT_CODE, StepWatchdog


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.clear()
    jax_faults.clear()
    yield
    faults.clear()
    jax_faults.clear()


def test_exit_codes_are_jax_codes():
    assert STALL_EXIT_CODE == contracts.STALL_EXIT_CODE == JAX_EXIT_CODES["stall"] == 42
    assert all(JAX_EXIT_CODES[k] == v for k, v in contracts.EXIT_CODES.items())


# -- watchdog: moco_tpu's tests/test_faults.py cases on the port's class ----
def test_watchdog_fires_dumps_and_exits(tmp_path):
    events = {}
    dump = tmp_path / "stacks.txt"
    wd = StepWatchdog(timeout=0.2, on_stall=lambda: events.setdefault("stall", True),
                      dump_path=str(dump), startup_grace=0.2, poll=0.05,
                      exit_fn=lambda code: events.setdefault("exit", code))
    wd.start()
    wd.beat()
    time.sleep(0.6)  # no beats: must fire
    wd.stop()
    assert events.get("stall") is True
    assert events.get("exit") == STALL_EXIT_CODE
    assert "Thread" in dump.read_text()  # the all-thread stack dump landed


def test_watchdog_beats_prevent_firing():
    fired = []
    wd = StepWatchdog(timeout=0.3, startup_grace=0.3, poll=0.05, exit_fn=fired.append)
    wd.start()
    for _ in range(10):
        time.sleep(0.05)
        wd.beat()
    wd.stop()
    assert fired == []


def test_watchdog_startup_grace_covers_the_first_step():
    """Before the first beat the effective timeout is the startup grace
    (the kernels' build and cuDNN's autotuning); after a beat, `timeout`."""
    fired = []
    wd = StepWatchdog(timeout=0.1, startup_grace=10.0, poll=0.02, exit_fn=fired.append)
    wd.start()
    time.sleep(0.4)  # past timeout, inside grace, zero beats
    assert fired == []
    wd.beat()
    time.sleep(0.4)  # past timeout with beats seen: fires
    wd.stop()
    assert fired == [STALL_EXIT_CODE]


def test_watchdog_on_stall_exception_does_not_block_exit():
    events = []

    def bad_stall():
        events.append("stall")
        raise RuntimeError("emergency save failed")

    wd = StepWatchdog(timeout=0.1, startup_grace=0.1, poll=0.02, on_stall=bad_stall,
                      exit_fn=lambda c: events.append(c))
    wd.start()
    time.sleep(0.4)
    wd.stop()
    assert events == ["stall", STALL_EXIT_CODE]


def test_watchdog_defaults_match_jax():
    from moco_tpu.utils.watchdog import StepWatchdog as JaxWatchdog

    ours, theirs = StepWatchdog(15.0), JaxWatchdog(15.0)
    assert (ours.poll, ours.startup_grace, ours.exit_code) == (
        theirs.poll, theirs.startup_grace, theirs.exit_code) == (3.75, 900.0, 42)
    with pytest.raises(ValueError):
        StepWatchdog(0)


# -- stall and preempt faults ---------------------------------------------
@pytest.mark.parametrize("spec", [
    "stall@step=4:seconds=120", "preempt@step=3",
    "preempt@step=3,stall@step=5:seconds=0.5,nan@step=2",
    "ckpt_truncate@step=9,io@site=data.read:at=3,delay@site=input.h2d:seconds=0.01",
    "kill@host=1:at=3,preempt@step=5",
    "kill@replica=1", "kill@replica=0:at=5,slow@site=serve.ingress:ms=5",
])
def test_grammar_parses_and_describes_as_jax(spec):
    assert faults.install(spec).describe() == jax_faults.install(spec).describe()
    assert faults.describe() == jax_faults.describe()


def test_unknown_kinds_and_params_are_refused():
    for spec in ("diverge@step=1", "stall@step=4:minutes=2", "preempt@at=3", "kill@at=2",
                 "kill@host=2:replica=1"):
        with pytest.raises(ValueError):
            faults.install(spec)


def test_stall_fires_once_like_jax():
    for mod in (faults, jax_faults):
        mod.install("stall@step=2:seconds=0.3")
        t0 = time.monotonic()
        mod.maybe_stall(1)
        assert time.monotonic() - t0 < 0.1
        mod.maybe_stall(2)
        assert time.monotonic() - t0 >= 0.3
        t1 = time.monotonic()
        mod.maybe_stall(2)  # once only
        assert time.monotonic() - t1 < 0.1


def test_preempt_signals_self_once_like_jax(monkeypatch):
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    for mod in (faults, jax_faults):
        mod.install("preempt@step=3")
        for step in (1, 2, 3, 3, 4):
            mod.maybe_preempt(step)
    assert sent == [(os.getpid(), signal.SIGTERM)] * 2


def test_hooks_are_noops_when_disabled():
    faults.maybe_stall(1)
    faults.maybe_preempt(1)
    assert faults.describe() == [] and not faults.enabled()
