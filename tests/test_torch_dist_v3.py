"""The port's data-parallel v3 step against JAX's at `num_data = 2` on the
CPU (2 steps, ViT-tiny through the flash kernels' plain versions, the
heads' SyncBN, the gathered keys of both views), its comms ledger, and the
oracle inside the port: gather_perm over 2 ranks equals one process with
2 virtual BN groups.

One world of 2 gloo ranks (tests/_torch_dist_worker.py) runs both jobs
while JAX takes its steps here; the helpers are test_torch_dist_train.py's.
Each test states its tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as dw
from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.core.moco import create_state as jax_create_state
from moco_tpu.core.moco import make_train_step as jax_make_train_step
from moco_tpu.core.moco import place_state
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.obs import comms as jax_comms
from moco_tpu.parallel import create_mesh
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import make_train_step
from moco_tpu_torch.utils import config as pc
from test_torch_dist_train import (
    SPE,
    _assert_state,
    _configs,
    _jax_steps,
    _jax_v2,
    _permutations,
    _views,
)

V3_B, V3_IMG, V3_HIDDEN = 8, 48, 32  # test_torch_train_v3's shapes
# The oracle's width. A ReLU input within float32 noise of zero flips under
# another order of the same sums (test_torch_dist_train.py's NF note): at
# width 8 the two runs meet such a unit in the first step's backward and
# part beyond the tolerance below; at width 16 they do not.
ORACLE_NF = 16


def _v3_configs():
    moco = dict(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, momentum_cos=True,
                temperature=0.2, v3=True, shuffle="none", compute_dtype="float32",
                vit_flash_attention=True, vit_patch_size=4)
    optim = dict(optimizer="sgd", lr=0.05, momentum=0.9, weight_decay=0.0, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=V3_IMG, global_batch=V3_B)
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                           data=jc.DataConfig(**data)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                           data=pc.DataConfig(**data)))


def _v3_views():
    return [_views(20 + i, V3_B, V3_IMG) for i in range(2)]


def _jax_v3(n):
    """JAX's v3 state (SyncBN heads when n > 1) and run() of its 2 steps,
    as test_torch_dist_train.py's `_jax_v2` pairs them."""
    jcfg, _ = _v3_configs()
    axis = "data" if n > 1 else None
    encoder = FlaxEncoder(
        backbone=jax_vit.create_vit("vit_tiny", patch_size=4, use_flash_attention=True),
        head=FlaxV3Head(num_layers=3, hidden_dim=V3_HIDDEN, dim=16, cross_replica_axis=axis))
    predictor = FlaxV3Head(num_layers=2, hidden_dim=V3_HIDDEN, dim=16, cross_replica_axis=axis)
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate = jax_create_state(jax.random.PRNGKey(1), jcfg, encoder, tx,
                              jnp.zeros((1, V3_IMG, V3_IMG, 3)), predictor=predictor)
    tree = {f: jax.tree.map(np.asarray, getattr(jstate, f)) for f in (
        "step", "params_q", "batch_stats_q", "params_k", "batch_stats_k", "params_pred",
        "batch_stats_pred")}

    def run():
        mesh = create_mesh(num_data=n, num_model=1, devices=jax.devices()[:n])
        jax_comms.reset()
        step = jax_make_train_step(jcfg, encoder, tx, mesh, predictor=predictor,
                                   total_steps=jcfg.optim.epochs * SPE)
        return _jax_steps(step, place_state(jstate, mesh), mesh, _v3_views())

    return tree, run


@functools.lru_cache(maxsize=None)
def _runs(root):
    """(v3: (tree, JAX's (state, metrics, ledger), the port's ranks),
    oracle: (tree, the port's ranks))."""
    v3_tree, v3_run = _jax_v3(2)
    oracle_tree = _jax_v2("gather_perm", 2, 0, ORACLE_NF)[0]
    _, v3cfg = _v3_configs()
    _, gp_cfg = _configs("gather_perm")
    procs = dw.start_world(dw.train_steps_job, 2, f"{root}/world2", {"cases": [
        {"config": v3cfg, "tree": v3_tree, "steps_per_epoch": SPE, "views": _v3_views()},
        {"config": gp_cfg, "tree": oracle_tree, "num_filters": ORACLE_NF, "steps_per_epoch": SPE,
         "views": [_views(i) for i in range(3)],
         "perms": [_permutations("gather_perm", i, 2) for i in range(3)]}]})
    jax_out = v3_run()
    ranks = dw.collect_world(procs, f"{root}/world2")
    return ((v3_tree, jax_out, [r[0] for r in ranks]),
            (oracle_tree, [r[1] for r in ranks]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("dist_v3")))


def test_two_dp_v3_steps_match_jax(runs):
    """v3 (ViT-tiny, flash attention, SyncBN heads) over 2 ranks against
    JAX's at num_data = 2: the keys of both views gathered, the labels
    offset by rank * 4. Per step the loss within rtol 2e-5 and acc1/acc5
    equal; after 2 steps the encoders, the predictor and every BN
    statistic within rtol 1e-5 / atol 5e-5 (test_three_v3_steps_match_jax's
    tolerance); the ranks in lockstep."""
    _, (jstate, jhist, _), ranks = runs[0]
    assert ranks[1]["digests"] == ranks[0]["digests"]
    res = ranks[0]
    for step, (jm, pm) in enumerate(zip(jhist, res["hist"])):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    _assert_state(res["state"], jstate.params_q, jstate.batch_stats_q, "q", 1e-5, 5e-5)
    _assert_state(res["state"], jstate.params_k, jstate.batch_stats_k, "k", 1e-5, 5e-5)
    want = convert.predictor_from_flax(jax.tree.map(np.asarray, jstate.params_pred),
                                       jax.tree.map(np.asarray, jstate.batch_stats_pred))
    for name, arr in want.items():
        np.testing.assert_allclose(res["state"][f"pred.{name}"], arr.numpy(), rtol=1e-5,
                                   atol=5e-5, err_msg=name)
    assert res["step"] == 2 and "queue" not in res["state"]


def test_v3_comms_ledger_equals_jax_but_the_frozen_patch_embedding(runs):
    """The ranks' v3 ledger against JAX's: `v3.key_gather` equal, and
    `grad.psum` smaller by exactly the frozen patch embedding's bytes: JAX
    reduces its zero gradient, the port does not reduce a parameter that
    has no gradient."""
    tree, (_, _, want), ranks = runs[0]
    pe = sum(np.asarray(v).nbytes
             for v in jax.tree.leaves(tree["params_q"]["backbone"]["patch_embed"]))
    coll, nbytes, per_step = want["grad.psum"]
    assert pe > 0 and per_step == nbytes  # a 2-rank ring all-reduce: 2b(n-1)/n = b
    want = {**want, "grad.psum": (coll, nbytes - pe, nbytes - pe)}
    for res in ranks:
        assert res["ledger"] == want


def test_two_ranks_equal_one_process_with_two_virtual_groups(runs):
    """The oracle inside the port: gather_perm over 2 ranks of 8 rows equals
    one process with bn_virtual_groups=2 on the 16 rows and the same global
    permutation (each rank's BN statistics are one virtual group's): losses
    within rtol 1e-5 and acc1/acc5 equal, then every parameter, BN
    statistic and queue row within atol 2e-5 / rtol 1e-4 (the two reduce
    the same sums in other orders)."""
    tree, ranks = runs[1]
    _, pcfg = _configs("gather_perm", bn_virtual_groups=2)
    state = convert.state_from_flax(pcfg, tree, device="cpu", num_filters=ORACLE_NF)
    step = make_train_step(pcfg, SPE, device="cpu")
    hist = []
    for i in range(3):
        views = _views(i)
        m = step(state, {"im_q": torch.from_numpy(views[0]), "im_k": torch.from_numpy(views[1]),
                         "perm": torch.from_numpy(_permutations("gather_perm", i, 2)["perm"])})
        hist.append({k: float(m[k]) for k in ("loss", "acc1", "acc5")})
    res = ranks[0]
    assert ranks[1]["digests"] == res["digests"]
    for a, b in zip(hist, res["hist"]):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        assert a["acc1"] == b["acc1"] and a["acc5"] == b["acc5"]
    one = dw.state_arrays(state)
    assert set(one) == set(res["state"])
    for k, v in one.items():
        np.testing.assert_allclose(res["state"][k], v, atol=2e-5, rtol=1e-4, err_msg=k)
