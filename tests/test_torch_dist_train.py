"""The port's data-parallel v1/v2 step (moco_tpu_torch/core/moco.py with a
world of ranks) against JAX's step at `num_data = n` on the CPU: 3 steps
in each shuffle mode at worlds of 2 and 4 (SyncBN with subgroups
included), the health gauges, and the comms ledger site by site
(test_torch_dist_v3.py: v3 and the virtual-groups oracle).

The port's ranks are spawned processes in a gloo world
(tests/_torch_dist_worker.py), one world per size for the whole file;
JAX runs here on the conftest's virtual devices (`create_mesh(num_data=n)`).
Both start from the same JAX-initialised state (through
`convert.state_from_flax`) and take the same global views, each rank its
rows, and JAX's own permutations. Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_worker as dw
from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.core.moco import create_state as jax_create_state
from moco_tpu.core.moco import make_train_step as jax_make_train_step
from moco_tpu.core.moco import place_state
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.obs import comms as jax_comms
from moco_tpu.parallel import create_mesh, shard_batch
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.utils import config as pc

SPE = 2  # steps per epoch: the 3 steps cross an epoch boundary of the cosine lr
# Width and batch. A ReLU has a kink at 0 (test_torch_train.py's NF note):
# a unit whose input lies within float32 noise of zero is active under one
# order of the same sums and dead under another, and the small per-rank BN
# batches spread its gradient over the whole encoder. JAX is not immune: at
# width 16 and batch 8 its own step at num_data = 2 under gather_perm and
# its one-device step with 2 virtual BN groups, the same function, part in
# the third loss by far more than this file's tolerance. At width 8, batch
# 16 and 16 px no case here meets such a unit; at widths 16 and 24 (batch
# 16) one case each (a2a; SyncBN) does.
NF = 8
B, IMG = 16, 16
ROOT_KEY = 3

# (case, shuffle, world, syncbn_group_size)
CASES = [
    ("gather_perm", "gather_perm", 2, 0),
    ("a2a", "a2a", 2, 0),
    ("syncbn", "syncbn", 2, 0),
    ("syncbn_groups", "syncbn", 4, 2),
    ("none", "none", 2, 0),
]


def _configs(shuffle, group_size=0, **moco_x):
    moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", fused_infonce=True, shuffle=shuffle,
                syncbn_group_size=group_size, **moco_x)
    optim = dict(lr=0.05, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=IMG, global_batch=B)
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco, fused_block_k=32),
                           optim=jc.OptimConfig(**optim), data=jc.DataConfig(**data)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                           data=pc.DataConfig(**data)))


def _views(i, b=None, img=None):
    shape = (2, b or B, img or IMG, img or IMG, 3)
    return np.random.default_rng(10 + i).standard_normal(shape).astype(np.float32)


def _permutations(shuffle, step, n):
    """JAX's draws at `step` (the step's fold of the root key): gather_perm's
    global permutation, or each rank's a2a (pre, post)."""
    step_rng = jax.random.fold_in(jax.random.PRNGKey(ROOT_KEY), step)
    if shuffle == "gather_perm":
        return {"perm": np.asarray(jax.random.permutation(step_rng, B), np.int64)}
    local = lambda salt, r: np.asarray(jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(step_rng, salt), r), B // n), np.int64)
    return {"pre": [local(17, r) for r in range(n)], "post": [local(29, r) for r in range(n)]}


def _ledger(snapshot) -> dict:
    return {k: (v.collective, v.operand_bytes, v.bytes_per_step) for k, v in snapshot.items()}


def _jax_v2(shuffle, n, group_size, nf=None):
    """JAX's state and step at num_data = n: (the initial state as numpy
    trees, run) where run() takes the 3 steps and returns (the final
    state, each step's metrics, the ledger after the first step's trace)."""
    jcfg, _ = _configs(shuffle, group_size)
    syncbn = shuffle == "syncbn"
    groups = ([list(range(i, i + group_size)) for i in range(0, n, group_size)]
              if syncbn and group_size else None)
    encoder = FlaxEncoder(
        backbone=jax_resnet.create_resnet(
            "resnet18", num_filters=nf or NF, cifar_stem=True, dtype=jnp.float32,
            bn_cross_replica_axis="data" if syncbn else None, bn_axis_index_groups=groups),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32))
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate = jax_create_state(jax.random.PRNGKey(0), jcfg, encoder, tx, jnp.zeros((1, IMG, IMG, 3)))
    tree = {f: jax.tree.map(np.asarray, getattr(jstate, f)) for f in (
        "step", "params_q", "batch_stats_q", "params_k", "batch_stats_k", "queue", "queue_ptr")}
    tree["trace"] = jax.tree.map(np.asarray, jstate.opt_state[1][0].trace["enc"])

    def run():
        mesh = create_mesh(num_data=n, num_model=1, devices=jax.devices()[:n])
        jax_comms.reset()
        step = jax_make_train_step(jcfg, encoder, tx, mesh)
        return _jax_steps(step, place_state(jstate, mesh), mesh, [_views(i) for i in range(3)])

    return tree, run


def _jax_steps(step, state, mesh, views):
    rng = jax.device_put(jax.random.PRNGKey(ROOT_KEY),
                         jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    hist, ledger = [], None
    for v in views:
        state, m = step(state, shard_batch(mesh, {"im_q": v[0], "im_k": v[1]}), rng)
        hist.append({k: np.asarray(x, np.float64) for k, x in m.items()})
        if ledger is None:
            ledger = _ledger(jax_comms.snapshot())
    return state, hist, ledger


@functools.lru_cache(maxsize=None)
def _runs(root):
    """{case: (the initial numpy tree, JAX's (state, metrics, ledger), the
    port's per-rank results)}: the port's worlds (one of 2 ranks for the
    2-rank cases, one of 4 for SyncBN with subgroups) run while JAX takes
    its steps here."""
    inits = {name: _jax_v2(shuffle, n, g) for name, shuffle, n, g in CASES}
    by_world: dict = {}
    for name, shuffle, n, g in CASES:
        _, pcfg = _configs(shuffle, g)
        perms = ([_permutations(shuffle, i, n) for i in range(3)]
                 if shuffle in ("gather_perm", "a2a") else None)
        by_world.setdefault(n, []).append((name, {
            "config": pcfg, "tree": inits[name][0], "num_filters": NF,
            "steps_per_epoch": SPE, "views": [_views(i) for i in range(3)], "perms": perms}))
    procs = {n: dw.start_world(dw.train_steps_job, n, f"{root}/world{n}",
                               {"cases": [c for _, c in cases]})
             for n, cases in by_world.items()}
    jax_out = {name: run() for name, (_, run) in inits.items()}
    out = {name: (inits[name][0], jax_out[name], []) for name in inits}
    for n, cases in by_world.items():
        results = dw.collect_world(procs[n], f"{root}/world{n}")
        for i, (name, _) in enumerate(cases):
            out[name][2].extend(res[i] for res in results)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("dist_train")))


def _assert_state(state: dict, params, stats, side: str, rtol, atol):
    want = convert.encoder_from_flax(jax.tree.map(np.asarray, params),
                                     jax.tree.map(np.asarray, stats))
    for name, arr in want.items():
        np.testing.assert_allclose(state[f"{side}.{name}"], arr.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{side}.{name}")


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_three_dp_steps_match_jax(runs, case):
    """Every rank against JAX's step at num_data = n (gather_perm, a2a with
    JAX's per-rank permutations, SyncBN over 2 ranks and over subgroups of 2
    of 4, none): per step the loss within rtol 1e-5 and acc1/acc5 equal;
    after 3 steps params_q, params_k and both encoders' BN statistics
    within rtol 1e-3 / atol 5e-4, the queue within 5e-4, queue_ptr 48 (the
    tolerances of test_three_train_steps_match_jax: float32 reassociation
    carried by momentum SGD). The ranks hold bit-identical states after
    every step."""
    _, (jstate, jhist, _), ranks = runs[case]
    for r in ranks[1:]:
        assert r["digests"] == ranks[0]["digests"], "ranks out of lockstep"
    res = ranks[0]
    for step, (jm, pm) in enumerate(zip(jhist, res["hist"])):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    _assert_state(res["state"], jstate.params_q, jstate.batch_stats_q, "q", 1e-3, 5e-4)
    _assert_state(res["state"], jstate.params_k, jstate.batch_stats_k, "k", 1e-3, 5e-4)
    np.testing.assert_allclose(res["state"]["queue"], np.asarray(jstate.queue), atol=5e-4, rtol=0)
    assert res["queue_ptr"] == int(jstate.queue_ptr) == 3 * B % 64 and res["step"] == 3


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_dp_health_gauges_are_jax_pmean(runs, case):
    """The health gauges of the last step: the batch-local ones are JAX's
    mean over the ranks (logit statistics within 1e-4 of their 1/T unit,
    feature_std within 1e-5), the drift and the queue's ages JAX's within
    rtol 1e-4 / 1e-6."""
    _, (_, jhist, _), ranks = runs[case]
    jm, pm = jhist[-1], ranks[0]["hist"][-1]
    gauges = {k for k in jm if k not in ("loss", "acc1", "acc5")}
    assert gauges <= set(pm), sorted(gauges - set(pm))
    for k in gauges:
        if k == "feature_dim_active":
            assert abs(pm[k] - jm[k]) <= 1, k
        elif k.startswith("logit_"):
            np.testing.assert_allclose(pm[k], jm[k], atol=1e-4 / 0.2, rtol=0, err_msg=k)
        elif k.startswith("queue_age"):
            np.testing.assert_allclose(pm[k], jm[k], atol=1e-6, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_comms_ledger_equals_jax_site_by_site(runs, case):
    """Every rank's ledger after the steps against JAX's after its trace, at
    the same n: the same sites, each the same collective, operand bytes and
    bytes per step (queue.enqueue_gather absent under gather_perm, whose
    key gather feeds the queue)."""
    _, (_, _, want), ranks = runs[case]
    for res in ranks:
        assert res["ledger"] == want
