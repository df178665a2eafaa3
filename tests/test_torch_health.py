"""The port's health gauges (moco_tpu_torch/obs/health.py) against
moco_tpu/obs/health.py on the CPU: every function on the same seeded numpy
inputs, and the gauges of the 3-step v2 and v3 parity trajectories
(tests/test_torch_train.py, tests/test_torch_train_v3.py), where both
packages run with `health_metrics=True`. Each test states its tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.obs import health as jh
from moco_tpu_torch.obs import health as ph
from test_torch_train import _trajectories as v2_trajectories
from test_torch_train_v3 import _trajectories as v3_trajectories

# float32 reductions in another order, on inputs of unit scale: rtol 1e-6
# and atol 1e-6 (a mean near 0, as of standard normal negatives, has no
# relative precision to hold)
TOL = 1e-6


def _close(got: dict, want: dict, rtol=TOL, atol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


def _params(rng):
    """A params tree of two groups, as Flax nests it, and its tensors."""
    tree = {"backbone": {"conv": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
                         "bn": rng.standard_normal(8).astype(np.float32)},
            "head": {"fc": rng.standard_normal((8, 16)).astype(np.float32)}}
    return tree


@pytest.mark.parametrize("seed", [0, 1])
def test_ema_drift_matches_jax(seed):
    """rtol and atol 1e-6; `ema_drift/<group>` per group and the global one."""
    rng = np.random.default_rng(seed)
    q = _params(rng)
    k = {g: {n: v + 0.05 * rng.standard_normal(v.shape).astype(np.float32) for n, v in grp.items()}
         for g, grp in q.items()}
    want = jh.ema_drift(q, k)
    got = ph.ema_drift({g: [torch.from_numpy(v) for v in grp.values()] for g, grp in q.items()},
                       {g: [torch.from_numpy(v) for v in grp.values()] for g, grp in k.items()})
    _close(got, want)
    same = ph.ema_drift({"backbone": [torch.ones(3)]}, {"backbone": [torch.ones(3)]})
    assert float(same["ema_drift"]) == 0.0


@pytest.mark.parametrize("shape", [(8, 64), (256, 1024)])
def test_logit_stats_match_jax(shape):
    """Population stds (`correction=0`, as jnp.std); rtol and atol 1e-6."""
    rng = np.random.default_rng(shape[0])
    pos = rng.standard_normal(shape[0]).astype(np.float32) * 3 + 2
    neg = rng.standard_normal(shape).astype(np.float32)
    _close(ph.logit_stats(torch.from_numpy(pos), torch.from_numpy(neg)),
           jh.logit_stats(jnp.asarray(pos), jnp.asarray(neg)))


@pytest.mark.parametrize("b,n", [(8, 8), (16, 40)])
def test_logit_stats_from_dense_match_jax(b, n):
    """Positives at permuted columns; rtol and atol 1e-6."""
    rng = np.random.default_rng(b + n)
    logits = (rng.standard_normal((b, n)) * 4).astype(np.float32)
    labels = rng.permutation(n)[:b].astype(np.int32)
    _close(ph.logit_stats_from_dense(torch.from_numpy(logits), torch.from_numpy(labels)),
           jh.logit_stats_from_dense(jnp.asarray(logits), jnp.asarray(labels)))


@pytest.mark.parametrize("d", [16, 128])
def test_feature_stats_match_jax(d):
    """Unit rows with three dimensions collapsed to a constant: rtol and
    atol 1e-6 on feature_std, feature_dim_active equal (no std lies within 1e-6 of the
    0.1/sqrt(d) threshold on these inputs, checked)."""
    rng = np.random.default_rng(d)
    f = rng.standard_normal((32, d)).astype(np.float32)
    f[:, :3] = 0.5
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    std = f.astype(np.float64).std(axis=0)
    assert np.abs(std - 0.1 / np.sqrt(d)).min() > 1e-6
    got = ph.feature_stats(torch.from_numpy(f))
    want = jh.feature_stats(jnp.asarray(f))
    _close(got, want)
    assert float(got["feature_dim_active"]) == float(want["feature_dim_active"]) < d


@pytest.mark.parametrize("step,k,b", [(0, 64, 8), (3, 64, 8), (100, 64, 8), (5, 100, 8),
                                      (40, 65536, 256), (1000, 65536, 256)])
def test_queue_age_matches_jax(step, k, b):
    """Mean, max and the 8-bucket histogram within 1e-6 (float32 means of
    integers, summed in another order)."""
    got = ph.queue_age(step, k, b)
    want = jh.queue_age(jnp.asarray(step), k, b)
    assert got["queue_age_hist"].shape == (8,)
    _close(got, want)


@pytest.mark.parametrize("queue", [True, False])
def test_health_summary_matches_jax(queue):
    """The bundle (the queue's ages only with a queue); rtol and atol 1e-6."""
    rng = np.random.default_rng(7)
    q = _params(rng)
    k = {g: {n: v * 0.9 for n, v in grp.items()} for g, grp in q.items()}
    feats = rng.standard_normal((16, 32)).astype(np.float32)
    pos = rng.standard_normal(16).astype(np.float32)
    neg = rng.standard_normal((16, 64)).astype(np.float32)
    kk, bb = (64, 16) if queue else (0, 0)
    want = jh.health_summary(q, k, jnp.asarray(feats), jnp.asarray(pos), jnp.asarray(neg),
                             jnp.asarray(3), kk, bb)
    got = ph.health_summary({g: [torch.from_numpy(v) for v in grp.values()] for g, grp in q.items()},
                            {g: [torch.from_numpy(v) for v in grp.values()] for g, grp in k.items()},
                            torch.from_numpy(feats), torch.from_numpy(pos), torch.from_numpy(neg),
                            3, kk, bb)
    _close(got, want)
    assert ph.BATCH_LOCAL_KEYS == jh.BATCH_LOCAL_KEYS


def _gauge_parity(hist, logit_atol):
    """Per step: every gauge key on both sides; the logit statistics within
    `logit_atol` (logits lie in [-1/T, 1/T]); the drift and feature
    statistics rtol 1e-5 and atol 1e-7; the queue's ages within 1e-6;
    feature_dim_active equal."""
    for step, (jm, pm) in enumerate(hist):
        got, want = pm["gauges"], jm["gauges"]
        assert set(got) == set(want), (step, sorted(set(got) ^ set(want)))
        for k in want:
            if k == "feature_dim_active":
                assert got[k] == want[k], (step, k)
                continue
            if k.startswith("logit_"):
                rtol, atol = 0.0, logit_atol
            elif k.startswith("queue_age"):
                rtol, atol = TOL, TOL
            else:
                rtol, atol = 1e-5, 1e-7
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                       err_msg=f"step {step} {k}")


@pytest.mark.parametrize("fused", [True, False])
def test_three_train_steps_gauges_match_jax(fused):
    """The v2 parity's 3 steps (tests/test_torch_train.py), health on in both
    packages. The logit statistics within 1e-5 (T = 0.2; measured at most
    3.7e-6: q and k carry the steps' float32 drift), the drift and feature
    statistics rtol 1e-5 (measured at most 2.5e-6), the queue's ages within
    1e-6."""
    _, _, hist = v2_trajectories(fused)
    assert {"ema_drift/backbone", "ema_drift/head", "queue_age_hist"} <= set(hist[0][1]["gauges"])
    _gauge_parity(hist, logit_atol=1e-5)


def test_three_v3_steps_gauges_match_jax():
    """The v3 parity's 3 steps (tests/test_torch_train_v3.py): the dense
    logit statistics of the first term, q1's feature statistics and the
    drift of the encoder (not the predictor), no queue gauges. The logit
    statistics within 2.5e-4, 5e-5 of the logits' scale 1/T (measured at
    most 9.1e-5 at step 2, where the loss itself drifts by 7e-6 relative:
    float32 reassociation through 4 ViT blocks, carried by the updates),
    the drift and feature statistics rtol 1e-5 (measured at most 3.4e-6)."""
    hist = v3_trajectories()[3]
    assert "queue_age_mean" not in hist[0][1]["gauges"]
    _gauge_parity(hist, logit_atol=2.5e-4)
