"""The port's checkpoint promotion (moco_tpu_torch/serve/promote.py,
serve/serve_promote.py) against moco_tpu's, and the router's version-skew
and promotion surface.

The gate battery runs on the engine fakes of tests/test_promote.py
(imported, not copied) with the same probes and index rows in both
packages: accept, a rotated candidate rejected by `compat_cosine`, a
collapsed one by `feature_std`, the EMA-drift ceiling and the opt-in
live-recall floor give JAX's gate values within 1e-6. Ledger lines are
JAX's, and both schemas take them. `StagedRollout` on the same fake fleet
and clock gives JAX's result, swaps and rollbacks. The router's
`/admin/promote` and `model_skew` face a fake supervisor and the stdlib
fake replicas. `serve_promote` gates a tiny port checkpoint on the CPU.
"""

import json
import os
import shutil
import time
import urllib.error
import urllib.request
from urllib.parse import quote

import numpy as np
import pytest

from moco_tpu.obs import quality as jax_quality
from moco_tpu.obs import schema as jax_schema
from moco_tpu.serve import promote as jax_promote
from moco_tpu.serve import router as jax_router
from moco_tpu_torch.obs import quality, schema
from moco_tpu_torch.serve import promote, router
from moco_tpu_torch.serve.index import EmbeddingIndex
from tests.test_promote import _engines, _Fleet, _live_index
from tests.test_router import FakeReplica

MODULES = {"port": promote, "jax": jax_promote}


def _port_index(dim=8, rows=64, seed=1):
    """tests/test_promote.py's `_live_index` rows in the port's index."""
    rng = np.random.RandomState(seed)
    emb = rng.randn(rows, dim).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    idx = EmbeddingIndex(rows, dim, device="cpu")
    idx.snapshot(emb, now=0.0)
    return idx


class _Collapsed:
    def embed(self, images):
        e = np.tile(np.eye(1, 8, dtype=np.float32), (images.shape[0], 1))
        return e, [(images.shape[0], images.shape[0])]


PQ = {"backbone": {"w": np.ones((3, 3), np.float32), "b": np.arange(3, dtype=np.float32)},
      "head": {"w": np.full((2, 3), 0.5, np.float32)}}
PK_CLOSE = {"backbone": {"w": np.ones((3, 3), np.float32) * 1.001,
                         "b": np.arange(3, dtype=np.float32)},
            "head": {"w": np.full((2, 3), 0.5, np.float32)}}
PK_TORN = {"backbone": {"w": -np.ones((3, 3), np.float32), "b": np.zeros(3, np.float32)},
           "head": {"w": np.full((2, 3), 0.5, np.float32)}}

# name -> (live, candidate, probe count, with the index, keyword arguments)
BATTERIES = {
    "accept": (lambda: _engines(), 16, True, {}),
    "rotated": (lambda: _engines(rotate=True), 16, True, {}),
    "collapsed": (lambda: (_engines()[0], _Collapsed()), 16, False,
                  {"floors": {"compat_cosine": -1.0}}),
    "drift_close": (lambda: _engines(), 8, False,
                    {"cand_params_q": PQ, "cand_params_k": PK_CLOSE}),
    "drift_torn": (lambda: _engines(), 8, False,
                   {"cand_params_q": PQ, "cand_params_k": PK_TORN}),
    "recall_undeclared": (lambda: _engines(), 8, False, {"live_recall": 0.2}),
    "recall_floor": (lambda: _engines(), 8, False,
                     {"floors": {"live_recall": 0.5}, "live_recall": 0.2}),
}


@pytest.mark.parametrize("name", sorted(BATTERIES))
def test_gate_battery_matches_jax(name):
    make, n, with_index, kw = BATTERIES[name]
    live, cand = make()
    probes = jax_quality.synthetic_probes(n, 4)
    np.testing.assert_array_equal(probes, quality.synthetic_probes(n, 4))
    want = jax_promote.run_gate_battery(
        live, cand, probes, index=_live_index() if with_index else None, k=5, **kw)
    got = promote.run_gate_battery(
        live, cand, probes, index=_port_index() if with_index else None, k=5, **kw)
    assert (got["ok"], got["failed_gate"]) == (want["ok"], want["failed_gate"])
    assert list(got["gates"]) == list(want["gates"])
    for gate, g in want["gates"].items():
        assert got["gates"][gate]["ok"] == g["ok"] and got["gates"][gate]["floor"] == g["floor"]
        assert got["gates"][gate]["value"] == pytest.approx(g["value"], abs=1e-6), gate
    assert got["compat"].keys() == want["compat"].keys()
    for k, v in want["compat"].items():
        assert got["compat"][k] == (None if v is None else pytest.approx(v, abs=1e-6))
    expected = {"accept": None, "rotated": "compat_cosine", "collapsed": "feature_std",
                "drift_close": None, "drift_torn": "ema_drift_max",
                "recall_undeclared": None, "recall_floor": "live_recall"}[name]
    assert got["failed_gate"] == expected


def test_drift_gate_takes_module_groups():
    """The port's CLI hands the battery `health.module_groups` of two
    encoders: the same drift as the Flax-layout trees of their weights."""
    import torch

    from moco_tpu_torch.obs import health

    q, k = torch.nn.Sequential(torch.nn.Linear(3, 3)), torch.nn.Sequential(torch.nn.Linear(3, 3))
    live, cand = _engines()
    probes = quality.synthetic_probes(8, 4)
    by_module = promote.run_gate_battery(live, cand, probes, cand_params_q=health.module_groups(q),
                                         cand_params_k=health.module_groups(k))
    tree = lambda m: {"0": {"bias": m[0].bias.detach().numpy(),
                            "kernel": m[0].weight.detach().numpy()}}
    want = jax_promote.run_gate_battery(live, cand, probes, cand_params_q=tree(q),
                                        cand_params_k=tree(k))
    assert by_module["gates"]["ema_drift_max"]["value"] == pytest.approx(
        want["gates"]["ema_drift_max"]["value"], abs=1e-6)


# -- the ledger ----------------------------------------------------------------

LEDGER_RECORDS = [
    dict(step=3, verdict="rejected", stage="gates", digest="d3", failed_gate="compat_cosine",
         gates={"compat_cosine": {"value": 0.2, "floor": 0.9, "ok": False},
                "feature_std": {"value": None, "floor": 0.25, "ok": False}},
         compat={"serve/compat_cosine": 0.2, "serve/recall_overlap": None}),
    dict(step=4, verdict="accepted", stage="gates", digest="d4"),
    dict(step=4, verdict="promoted", stage="rollout", digest="d4"),
    dict(step=5, verdict="rolled_back", stage="rollout", digest="d5", failed_gate="burn_breach",
         replica=1, gates={"burn": {"value": 99.0, "floor": 14.4, "ok": False}}),
]


def test_ledger_lines_match_jax(tmp_path):
    ledgers = {name: mod.PromotionLedger(os.path.join(tmp_path, f"{name}.jsonl"))
               for name, mod in MODULES.items()}
    for rec in LEDGER_RECORDS:
        lines = {name: mod.ledger_record(**rec, now=1234.5) for name, mod in MODULES.items()}
        assert lines["port"] == lines["jax"]
        for name, led in ledgers.items():
            led.append(lines[name])
    assert ledgers["port"].read() == ledgers["jax"].read()
    with open(ledgers["port"].path) as f:
        body = f.read()
    with open(ledgers["jax"].path) as f:
        assert body == f.read()
    assert schema.validate_lines(body.splitlines()) == []
    assert jax_schema.validate_lines(body.splitlines()) == []
    # a changed line is a different line
    assert promote.ledger_record(**LEDGER_RECORDS[1]) != promote.ledger_record(
        **LEDGER_RECORDS[2])


def test_ledger_refusals_match_jax(tmp_path):
    for name, mod in MODULES.items():
        with pytest.raises(ValueError, match="verdict must be one of"):
            mod.ledger_record(1, "shipped", "gates")
        led = mod.PromotionLedger(os.path.join(tmp_path, f"{name}.jsonl"))
        rec = mod.ledger_record(1, "accepted", "gates")
        del rec["time"]
        with pytest.raises(ValueError, match="fails schema"):
            led.append(rec)
        rec = mod.ledger_record(1, "accepted", "gates")
        rec["promotion/gate/compat_cosine"] = float("nan")
        with pytest.raises(ValueError):
            led.append(rec)  # allow_nan=False: a NaN never lands on disk
        assert led.read() == []


# -- the staged rollout ------------------------------------------------------


def _rollout(mod, case):
    f = _Fleet(n=3 if case != "timeout" else 2)
    kw = dict(swap_back=f.swap_back, target_digest="new", soak_s=0.5, poll_s=0.1,
              sleep=f.sleep, clock=f.clock)
    swap, burn = f.swap, f.burn
    if case == "breach":
        burn = lambda: 99.0 if f.digest[1] == "new" else 0.2  # noqa: E731
    elif case == "timeout":
        swap = f.swaps.append  # the swap starts, the digest never flips
        kw.update(soak_s=0.1, swap_timeout_s=1.0, poll_s=0.2)
    elif case == "none_burn":
        burn = lambda: None  # noqa: E731
    out = mod.StagedRollout(f.n, swap, f.status, burn=burn, **kw).run()
    return out, f.swaps, f.backs, dict(f.digest), round(f.t, 6)


@pytest.mark.parametrize("case", ["promote", "breach", "timeout", "none_burn"])
def test_staged_rollout_matches_jax(case):
    got = _rollout(promote, case)
    assert got == _rollout(jax_promote, case)
    verdict = {"promote": "promoted", "breach": "rolled_back", "timeout": "rolled_back",
               "none_burn": "promoted"}[case]
    assert got[0]["verdict"] == verdict


def test_staged_rollout_refuses_an_empty_fleet_as_jax():
    for mod in MODULES.values():
        with pytest.raises(ValueError, match="num_replicas must be >= 1"):
            mod.StagedRollout(0, print, dict)


# -- the router: version skew and /admin/promote ----------------------------------


class _FakeSupervisor:
    def __init__(self):
        self.ckpt_dirs, self.restarts = [], []

    def set_ckpt_dir(self, path):
        self.ckpt_dirs.append(path)

    def restart_replica(self, index):
        self.restarts.append(index)


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _promote_surface(mod):
    fakes = [FakeReplica(0), FakeReplica(1)]
    fakes[0].set(stats_extra={"serve/model_step": 5, "serve/model_digest": "aaa",
                              "serve/fresh_burn_rate_60s": 0.5, "serve/recall_estimate": 0.8})
    fakes[1].set(stats_extra={"serve/model_step": 7, "serve/model_digest": "bbb",
                              "serve/fresh_burn_rate_60s": 1.5})
    sup = _FakeSupervisor()
    r = mod.FleetRouter(replica_urls=[f.url for f in fakes], slo_ms=1000.0,
                        health_interval_s=0.05, supervisor=sup)
    base = f"http://127.0.0.1:{r.port}"

    def post(q):
        req = urllib.request.Request(base + "/admin/promote?" + q, data=b"")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status, sorted(json.loads(resp.read()))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        skewed = _wait(lambda: r.stats()["fleet_serve/model_skew"] == 1)
        st = r.stats()
        agg = {k: st[k] for k in st if "fresh_burn" in k or "recall_estimate" in k}
        with urllib.request.urlopen(base + "/admin/replicas", timeout=5) as resp:
            snaps = json.loads(resp.read())["replicas"]
        ident = [(s["model_step"], s["model_digest"]) for s in snaps]
        answers = [post(f"replica=1&ckpt_dir={quote('/run/candidate dir', safe='')}")]
        restarted = _wait(lambda: sup.restarts == [1])
        answers += [post(q) for q in ("replica=1", "ckpt_dir=/x", "replica=9&ckpt_dir=/x")]
        fakes[1].set(stats_extra={"serve/model_step": 5, "serve/model_digest": "aaa"})
        healed = _wait(lambda: r.stats()["fleet_serve/model_skew"] == 0)
        promotions = r.stats()["fleet_serve/promotions"]
    finally:
        r.close()
        for f in fakes:
            f.close()
    return {"skewed": skewed, "agg": agg, "ident": ident, "answers": answers,
            "restarted": restarted, "ckpt_dirs": sup.ckpt_dirs, "healed": healed,
            "promotions": promotions}


def test_router_promote_surface_matches_jax():
    got = _promote_surface(router)
    assert got == _promote_surface(jax_router)
    assert got["skewed"] and got["healed"] and got["restarted"]
    assert got["ckpt_dirs"] == ["/run/candidate dir"] and got["promotions"] == 1
    assert got["agg"]["fleet_serve/fresh_burn_rate_60s_mean"] == pytest.approx(1.0)
    assert got["agg"]["fleet_serve/recall_estimate_max"] == 0.8
    assert [code for code, _ in got["answers"]] == [202, 400, 400, 400]


# -- serve_promote on a tiny port checkpoint -----------------------------------------


def _reinit_copy(src: str, dst: str, seed: int) -> None:
    """`src`'s checkpoint with both encoders re-initialised from `seed`."""
    import torch

    from moco_tpu_torch.lincls import restore_pretrain_state
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, encoder_to_reference

    payload, extra = CheckpointManager(src).restore()
    restored = restore_pretrain_state(src, sides=("q", "k"), device="cpu")
    for side, enc in restored.encoders.items():
        torch.manual_seed(seed)
        for m in enc.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
        for k, v in encoder_to_reference(enc).items():
            payload["state_dict"][f"module.encoder_{side}.{k}"] = v.detach().clone()
    CheckpointManager(dst).save(CheckpointManager(src).latest_step(), payload, extra=extra)


def test_serve_promote_gates_write_the_ledger(tmp_path):
    """Gates only (no router): a candidate equal to the live checkpoint
    passes the compatibility gates, one re-initialised from another seed
    fails them; each verdict is one ledger line that both schemas take,
    named by its gate, and the exit code follows the verdict."""
    from moco_tpu_torch.serve import serve_promote
    from tests.test_torch_fleet import tiny_checkpoint

    live, same, other = (str(tmp_path / d) for d in ("live", "same", "other"))
    tiny_checkpoint(live)
    shutil.copytree(live, same)
    _reinit_copy(live, other, seed=7)
    ledger = str(tmp_path / "promotions.jsonl")
    args = ["--live-dir", live, "--ledger", ledger, "--device", "cpu", "--probes", "8",
            "--floor-feature-std", "0", "--max-ema-drift", "10"]
    assert serve_promote.main(["--candidate-dir", same, *args]) == 0
    assert serve_promote.main(["--candidate-dir", other, *args]) == 1
    with open(ledger) as f:
        body = f.read().splitlines()
    assert schema.validate_lines(body) == [] == jax_schema.validate_lines(body)
    recs = [json.loads(line) for line in body]
    assert [r["promotion/verdict"] for r in recs] == ["accepted", "rejected"]
    assert recs[0]["promotion/gate/compat_cosine"] == pytest.approx(1.0, abs=1e-5)
    assert recs[0]["promotion/gate/recall_overlap"] == 1.0
    assert recs[1]["promotion/failed_gate"] == "compat_cosine"
    assert recs[1]["promotion/gate_ok/compat_cosine"] == 0
    assert all(r["promotion/step"] == 2 and r["promotion/stage"] == "gates" for r in recs)
    assert recs[0]["promotion/digest"] != recs[1]["promotion/digest"]
