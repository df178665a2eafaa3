"""The port's model axis in worlds of 1 x 2 and 2 x 2 gloo ranks on the
CPU (tests/_torch_dist_worker.py `model_axis_job`), against JAX: ring
attention against JAX's ring under shard_map, the sequence-parallel ViT
against JAX's dense ViT, the sharded queue's v2 step against JAX's on the
(1, 2) and (2, 2) meshes, replicated and under ZeRO stages 1 and 3 (the
state sharded over the data axis), the sequence-parallel v3 step's
gradients against JAX's dense step and its update (replicated and at ZeRO
stage 3) against the port's own dense step, a checkpoint of a sharded
queue through `train()`, and a ZeRO 2 x 2 checkpoint resumed as a
replicated 1 x 2 run and the reverse.

Both worlds run all their cases (module-scoped) while JAX takes its
references here, each compiled once; the states both packages start from
are the port's fresh modules in Flax layout (`convert.encoder_to_flax`),
so JAX compiles no init. Each test states its tolerance.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_dist_worker as dw
from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.core.moco import MocoState
from moco_tpu.core.moco import make_train_step as jax_make_train_step
from moco_tpu.core.moco import place_state
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.obs import comms as jax_comms
from moco_tpu.parallel import create_mesh
from moco_tpu.parallel.compat import shard_map
from moco_tpu.parallel.zero import shard_template, shard_tree
from moco_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import make_train_step
from moco_tpu_torch.models import resnet
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils.checkpoint import CheckpointManager
from moco_tpu_torch.utils.config import ResumeCompatError
from test_torch_dist_train import _jax_steps, _ledger, _permutations, _views
from test_train_step import BATCH, DIM, IMG, K, tiny_config, tiny_encoder

RING = {"m2": (2, 32), "w4": (4, 32)}  # name: (ring size, whole sequence)
RB, RH, RD = 1, 2, 32
SP_IMG, SP_B, SP_HIDDEN = 32, 8, 32  # vit_tiny at 32 px, patch 4: 64 tokens
SPE = 10  # test_train_step's steps_per_epoch
V3_LR = 0.05
RECOVER_LR = 100.0  # JAX's dense step at this SGD lr: its update is -lr * gradient
# ZeRO layouts on the model axis: the state sharded over the data ranks
ZERO = {"z1": dict(shard_weight_update=True), "z3": dict(shard_weight_update=True, zero_stage=3)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_trees(cfg, num_filters=64, mlp_hidden=SP_HIDDEN, seed=0):
    """Flax-layout (params, batch_stats) of the port's freshly built encoder
    (and v3 predictor) for `cfg`, through `convert.encoder_to_flax`: a start
    for both packages that needs no JAX init."""
    from moco_tpu_torch.core.moco import build_encoder, build_predictor

    torch.manual_seed(seed)
    enc = build_encoder(cfg.moco, num_filters=num_filters, mlp_hidden=mlp_hidden)
    heads = next((m.num_heads for m in enc.modules() if hasattr(m, "num_heads")), None)
    trees = {"enc": convert.encoder_to_flax(enc.state_dict(), heads)}
    if cfg.moco.v3:
        trees["pred"] = convert.head_to_flax(build_predictor(cfg.moco, mlp_hidden).state_dict())
    return trees


def jax_state(trees, tx, queue=None, dim=16, zero=None):
    """JAX's `MocoState` holding the numpy `trees`, as moco_tpu/core/moco.py's
    `create_state` lays it out (`zero` = (num_data, stage): the optimizer
    state over the (n, m) template, at stage 2/3 the parameters in that
    layout too), and the state's numpy tree for `convert.state_from_flax`
    (which unshards a ZeRO tree's (n, m) leaves)."""
    params, stats = (jax.tree.map(jnp.asarray, t) for t in trees["enc"])
    pred, pred_stats = (jax.tree.map(jnp.asarray, t) for t in trees.get("pred", ({}, {})))
    trainable = {"enc": params, "pred": pred}
    opt_state = tx.init(trainable if zero is None else shard_template(trainable, zero[0]))
    params_k = jax.tree.map(jnp.copy, params)
    if zero is not None and zero[1] >= 2:
        params, params_k, pred = (shard_tree(t, zero[0]) for t in (params, params_k, pred))
    state = MocoState(step=jnp.zeros((), jnp.int32), params_q=params,
                      params_k=params_k, batch_stats_q=stats,
                      batch_stats_k=jax.tree.map(jnp.copy, stats),
                      queue=jnp.asarray(queue) if queue is not None
                      else jnp.zeros((1, dim), jnp.float32),
                      queue_ptr=jnp.zeros((), jnp.int32),
                      opt_state=opt_state,
                      params_pred=pred, batch_stats_pred=pred_stats)
    fields = ["step", "params_q", "batch_stats_q", "params_k", "batch_stats_k"]
    fields += ["queue", "queue_ptr"] if queue is not None else ["params_pred", "batch_stats_pred"]
    return state, {f: jax.tree.map(np.asarray, getattr(state, f)) for f in fields}


def _qkv(name):
    n, s = RING[name]
    rng = np.random.default_rng(n)
    return [rng.standard_normal((RB, RH, s, RD)).astype(np.float32) for _ in range(3)]


def _jax_ring(name):
    """JAX's ring attention over n virtual devices (interpret mode), out and
    the gradients of sum(out ** 2), as tests/test_ring_attention.py."""
    n, _ = RING[name]
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
    spec = P(None, None, "seq")
    ring = shard_map(lambda q, k, v: ring_attention_jax(q, k, v), mesh=mesh,
                     in_specs=(spec,) * 3, out_specs=spec, check_vma=False)
    q, k, v = (jnp.asarray(x) for x in _qkv(name))

    def loss(q, k, v):
        out = ring(q, k, v)
        return jnp.sum(out ** 2), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def ring_attention_jax(q, k, v):
    return jax_ring_attention(q, k, v, "seq", interpret=True)


def _v2_configs(dense=False, zero=None):
    """(JAX's, the port's) sharded-queue v2 config; `zero` a ZERO layout."""
    par = ZERO[zero] if zero else {}
    jcfg = dataclasses.replace(tiny_config(), optim=jc.OptimConfig(lr=0.1, epochs=4, cos=True),
                               parallel=jc.ParallelConfig(**par))
    moco = dict(arch="tiny", dim=DIM, num_negatives=K, temperature=0.1, compute_dtype="float32",
                cifar_stem=True, fused_infonce=False if dense else None)
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(lr=0.1, epochs=4,
                                                                           cos=True),
                          data=pc.DataConfig(dataset="synthetic", image_size=IMG,
                                             global_batch=BATCH),
                          parallel=pc.ParallelConfig(num_model=2, **par))
    return jcfg, pcfg


def _v2_views():
    return [_views(30 + i, BATCH, IMG) for i in range(3)]


@functools.lru_cache(maxsize=None)
def _jax_v2_trees():
    """The port's fresh tiny encoder in Flax layout, and the unit queue."""
    _, pcfg = _v2_configs()
    resnet._CONFIGS["tiny"] = dict(stage_sizes=[1, 1], block=resnet.BasicBlock)
    try:
        trees = _port_trees(pcfg, num_filters=8)
    finally:
        del resnet._CONFIGS["tiny"]
    queue = np.random.default_rng(7).standard_normal((K, DIM)).astype(np.float32)
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    return trees, queue


@functools.lru_cache(maxsize=None)
def _jax_v2_init():
    jcfg, pcfg = _v2_configs()
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate, tree = jax_state(*_jax_v2_trees()[:1], tx, _jax_v2_trees()[1])
    return jstate, tx, tree


@functools.lru_cache(maxsize=None)
def _jax_zero_state(num_data, zero):
    """JAX's ZeRO state of the v2 case at num_data under layout `zero`, and
    its numpy tree (stage 3: the parameters in the (n, m) layout)."""
    jcfg, _ = _v2_configs(zero=zero)
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    return jax_state(*_jax_v2_trees()[:1], tx, _jax_v2_trees()[1],
                     zero=(num_data, jcfg.parallel.zero_stage))


def _jax_v2(num_data, zero=None):
    """JAX's sharded-queue step on the (num_data, 2) mesh, replicated or
    under a ZERO layout (the state sharded over `data`): (the final state,
    each of 3 steps' metrics, the ledger of the first step's trace)."""
    jcfg, _ = _v2_configs(zero=zero)
    jstate, tx, _ = _jax_v2_init()
    if zero is not None:
        jstate, _ = _jax_zero_state(num_data, zero)
    mesh = create_mesh(num_data=num_data, num_model=2, devices=jax.devices()[:2 * num_data])
    jax_comms.reset()
    step = jax_make_train_step(jcfg, tiny_encoder(), tx, mesh,
                               state_template=jstate if zero is not None else None)
    placed = place_state(jstate, mesh, shard_queue_over_model=True, zero=zero is not None,
                         zero_params=zero is not None and jcfg.parallel.zero_stage >= 2)
    return _jax_steps(step, placed, mesh, _v2_views())


def _v3_configs(lr=V3_LR, sp=True, num_model=2, zero=None):
    moco = dict(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, temperature=0.2,
                v3=True, shuffle="none", compute_dtype="float32", vit_patch_size=4,
                vit_pool="gap")
    optim = dict(optimizer="sgd", lr=lr, momentum=0.9, weight_decay=0.0, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=SP_IMG, global_batch=SP_B)
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                           data=jc.DataConfig(**data)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco, vit_sequence_parallel=sp,
                                              vit_flash_attention=True),
                           optim=pc.OptimConfig(**optim), data=pc.DataConfig(**data),
                           parallel=pc.ParallelConfig(num_model=num_model,
                                                      **(ZERO[zero] if zero else {}))))


def _v3_views():
    return [_views(40 + i, SP_B, SP_IMG) for i in range(2)]


@functools.lru_cache(maxsize=None)
def _jax_v3_init():
    """JAX's dense v3 model (dense attention, gap pooling) at SGD lr
    RECOVER_LR: (state, encoder, predictor, tx, the state as numpy trees)."""
    jcfg, pcfg = _v3_configs(lr=RECOVER_LR)
    encoder = FlaxEncoder(backbone=jax_vit.create_vit("vit_tiny", patch_size=4, pool="gap"),
                          head=FlaxV3Head(num_layers=3, hidden_dim=SP_HIDDEN, dim=16))
    predictor = FlaxV3Head(num_layers=2, hidden_dim=SP_HIDDEN, dim=16)
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate, tree = jax_state(_port_trees(pcfg, seed=1), tx)
    return jstate, encoder, predictor, tx, tree


def _jax_v3_dense():
    """From one step of JAX's dense v3 step on one device at SGD lr
    RECOVER_LR (momentum's trace starts at zero, so the update is -lr times
    the gradient): every trained parameter's gradient, (p0 - p1) / lr, under
    the port's names, and the step's loss."""
    jcfg, _ = _v3_configs(lr=RECOVER_LR)
    jstate, encoder, predictor, tx, tree = _jax_v3_init()
    mesh = create_mesh(num_data=1, num_model=1, devices=jax.devices()[:1])
    step = jax_make_train_step(jcfg, encoder, tx, mesh, predictor=predictor,
                               total_steps=jcfg.optim.epochs * SPE)
    after, hist, _ = _jax_steps(step, place_state(jstate, mesh), mesh, _v3_views()[:1])
    grad = lambda a, b: jax.tree.map(lambda x, y: (np.asarray(x, np.float64)
                                                   - np.asarray(y, np.float64)) / RECOVER_LR,
                                     a, b)
    enc = convert.encoder_from_flax(grad(tree["params_q"], after.params_q), tree["batch_stats_q"])
    pred = convert.predictor_from_flax(grad(tree["params_pred"], after.params_pred),
                                       tree["batch_stats_pred"])
    grads = {**{f"q.{k}": v.numpy() for k, v in enc.items()},
             **{f"pred.{k}": v.numpy() for k, v in pred.items()}}
    return grads, float(hist[0]["loss"])


@functools.lru_cache(maxsize=None)
def _vit_params():
    cfg = pc.MocoConfig(arch="vit_tiny", vit_patch_size=4, vit_pool="gap", v3=True,
                        num_negatives=0, dim=16)
    images = np.random.default_rng(6).standard_normal((3, SP_IMG, SP_IMG, 3)).astype(np.float32)
    return convert.random_flax_encoder(cfg, seed=5)[0]["backbone"], images


def _jax_vit():
    params, images = _vit_params()
    vit = jax_vit.create_vit("vit_tiny", patch_size=4, pool="gap")
    apply = jax.jit(lambda p, x: vit.apply({"params": p}, x, train=False))
    return np.asarray(apply(params, jnp.asarray(images)))


def _cross_spec(root, cfg, mine, theirs, tree, perms=None):
    """A world's part of the cross-layout resume: one step of `cfg` from
    `tree` saved under root/mine (every rank gathers, rank 0 writes), then
    the other world's root/theirs checkpoint loaded into a fresh state of
    `cfg` and one step from it."""
    return {"config": cfg, "tree": tree, "num_filters": 8, "steps_per_epoch": SPE,
            "views": _v2_views()[:2], "perms": perms, "save": os.path.join(root, mine),
            "load": os.path.join(root, theirs)}


def _ckpt_runs(root):
    base = pc.TrainConfig(moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64,
                                             cifar_stem=True, shuffle="none", mlp=True,
                                             temperature=0.2, compute_dtype="float32"),
                          optim=pc.OptimConfig(lr=0.05, epochs=2, cos=True),
                          data=pc.DataConfig(dataset="synthetic", image_size=16, global_batch=8),
                          parallel=pc.ParallelConfig(num_model=2), steps_per_epoch=2,
                          log_every=1, device_prefetch=False)
    a = dataclasses.replace(base, workdir=os.path.join(root, "a"))
    b = dataclasses.replace(base, workdir=os.path.join(root, "b"))
    return {"a": (a, None), "b": (b, 2), "c": (b, None)}


@functools.lru_cache(maxsize=None)
def _runs(root):
    """({world: the ranks' results}, the JAX references, v3's initial tree,
    the checkpoint runs' root): the worlds of 1 x 2 and 2 x 2 run while JAX
    computes here."""
    _, _, v2_tree = _jax_v2_init()
    v3_tree = _jax_v3_init()[-1]
    vit_params, vit_images = _vit_params()
    vit_case = {"weights": convert.vit_from_flax(vit_params), "images": vit_images}
    _, p2 = _v2_configs()
    _, p2_dense = _v2_configs(dense=True)
    _, p3 = _v3_configs()
    _, p3_z3 = _v3_configs(zero="z3")
    ring = lambda name, over: {name: {"over": over, **dict(zip("qkv", _qkv(name)))}}
    v2 = lambda cfg, perms: {"config": cfg, "tree": v2_tree, "num_filters": 8,
                             "steps_per_epoch": SPE, "views": _v2_views(), "perms": perms}
    v3 = lambda cfg: {"config": cfg, "tree": v3_tree, "steps_per_epoch": SPE,
                      "views": _v3_views()}
    perms = [_permutations("gather_perm", i, 2) for i in range(3)]
    # the ZeRO cases start from JAX's ZeRO state of their mesh (stage 3's
    # parameters in the (n, m) layout), through convert.state_from_flax
    zero_case = lambda z, nd, perms: {**v2(_v2_configs(zero=z)[1], perms),  # noqa: E731
                                      "tree": _jax_zero_state(nd, z)[1]}
    cross = os.path.join(root, "cross")
    specs = {
        "1x2": (2, {"archs": {"tiny": [1, 1]}, "ring": ring("m2", "model"), "vit": vit_case,
                    "steps": {"v2": v2(p2, None), "v2_dense": v2(p2_dense, None), "v3": v3(p3),
                              **{z: zero_case(z, 1, None) for z in ZERO}},
                    "ckpt": {"runs": _ckpt_runs(os.path.join(root, "ckpt")), "examples": 32,
                             "num_filters": 4},
                    "cross": _cross_spec(cross, p2, "rep12", "zero22", v2_tree)}),
        "2x2": (4, {"archs": {"tiny": [1, 1]}, "ring": ring("w4", "world"),
                    "steps": {"v2": v2(p2, perms), "v3": v3(p3),
                              **{z: zero_case(z, 2, perms) for z in ZERO}, "v3_z3": v3(p3_z3)},
                    "cross": _cross_spec(cross, _v2_configs(zero="z3")[1], "zero22", "rep12",
                                         v2_tree, perms)}),
    }
    procs = {w: dw.start_world(dw.model_axis_job, n, os.path.join(root, w), spec, num_model=2)
             for w, (n, spec) in specs.items()}
    jax_out = {"v3": _jax_v3_dense(), "vit": _jax_vit(),
               "ring": {name: _jax_ring(name) for name in RING},
               "v2": {w: _jax_v2(nd) for w, nd in (("1x2", 1), ("2x2", 2))},
               "zero": {(w, z): _jax_v2(nd, z) for w, nd in (("1x2", 1), ("2x2", 2))
                        for z in ZERO}}
    ranks = {w: dw.collect_world(p, os.path.join(root, w)) for w, p in procs.items()}
    return ranks, jax_out, v3_tree, os.path.join(root, "ckpt")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _runs(str(tmp_path_factory.mktemp("model_axis")))


@pytest.mark.parametrize("world,name", [("1x2", "m2"), ("2x2", "w4")])
def test_ring_attention_matches_jax_ring(runs, world, name):
    """Ring attention at n = 2 (the model group) and n = 4 (every rank):
    each rank's out and dq, dk, dv (of sum(out ** 2)) against its shard of
    JAX's ring under shard_map within 2e-5 / rtol 1e-4; its merged lse
    against a float64 logsumexp over the whole sequence within 1e-5. The
    ledger's `ring_attention.kv_ppermute`: (k, v) bytes, n calls a step."""
    ranks, jax_out, _, _ = runs
    want_out, want_grads = jax_out["ring"][name]
    n, s = RING[name]
    q, k, _ = (x.astype(np.float64) for x in _qkv(name))
    lse = np.log(np.exp(np.einsum("bhqd,bhkd->bhqk", q, k) * RD ** -0.5).sum(-1))
    local = s // n
    for r, res in enumerate(ranks[world]):
        got = res[f"ring_{name}"]
        sl = slice(r * local, (r + 1) * local)
        np.testing.assert_allclose(got["out"], want_out[:, :, sl], atol=2e-5, rtol=1e-4)
        for key, g in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[key], g[:, :, sl], atol=2e-5, rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(got["lse"], lse[:, :, sl], atol=1e-5)
        nbytes = 2 * RB * RH * local * RD * 4
        assert got["ledger"] == {"ring_attention.kv_ppermute": ("ppermute", nbytes * n, n)}


def test_sequence_parallel_vit_matches_jax_dense_vit(runs):
    """vit_tiny (32 px, patch 4, gap) with its 64 tokens over 2 ranks against
    JAX's dense ViT on the same weights: every rank's features within
    2e-5 / rtol 1e-4."""
    ranks, jax_out, _, _ = runs
    for res in ranks["1x2"]:
        np.testing.assert_allclose(res["vit"], jax_out["vit"], atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("world,case", [("1x2", "v2"), ("1x2", "v2_dense"), ("2x2", "v2")])
def test_sharded_queue_steps_match_jax(runs, world, case):
    """The v2 step with its queue sharded over 2 model ranks (the fused loss
    on each shard, or the dense logits' gather) against JAX's on the (1, 2)
    and (2, 2) meshes (test_train_step.py's tiny config): the loss of each
    of 3 steps within rtol 2e-4, the whole queue (the ranks' shards in
    model order) within rtol 1e-3 / atol 1e-5, queue_ptr 3 x 16, as
    tests/test_train_step.py holds the sharded queue; every rank's state
    but the queue bit-equal; the gradients' ledger site over data x model
    as JAX's."""
    ranks, jax_out, _, _ = runs
    jstate, jhist, jledger = jax_out["v2"][world]
    res = ranks[world]
    for r in res:
        assert r[case]["digests"] == res[0][case]["digests"]
        for jm, pm in zip(jhist, r[case]["hist"]):
            np.testing.assert_allclose(pm["loss"], float(jm["loss"]), rtol=2e-4)
        assert r[case]["queue_ptr"] == 3 * BATCH
    queue = np.concatenate([res[m][case]["state"]["queue"] for m in range(2)])
    np.testing.assert_allclose(queue, np.asarray(jstate.queue), rtol=1e-3, atol=1e-5)
    assert res[0][case]["ledger"]["grad.psum"] == jledger["grad.psum"]
    site = "queue.logits_gather" if case == "v2_dense" else "queue.stats_gather"
    assert site in res[0][case]["ledger"]
    if case == "v2_dense":
        assert res[0][case]["ledger"][site] == jledger[site]


@pytest.mark.parametrize("world,zero", [(w, z) for w in ("1x2", "2x2") for z in ZERO])
def test_zero_on_the_model_axis_matches_jax(runs, world, zero):
    """ZeRO stages 1 and 3 with the queue sharded over 2 model ranks, the
    state over the data ranks, against JAX's ZeRO step on the same (1, 2)
    and (2, 2) mesh (the gradients' model mean, then the data-group update):
    the loss of each of 3 steps within rtol 2e-4, the whole queue within
    rtol 1e-3 / atol 1e-5 and queue_ptr 3 x 16, as the replicated case; the
    whole parameters and BN statistics within rtol 1e-4 / atol 1e-5 of the
    port's replicated step on the same world; every rank's state (whole
    tensors) bit-equal; JAX's `zero.*` ledger sites, site by site."""
    ranks, jax_out, _, _ = runs
    jstate, jhist, jledger = jax_out["zero"][world, zero]
    res = ranks[world]
    for r in res:
        assert r[zero]["digests"] == res[0][zero]["digests"]
        for jm, pm in zip(jhist, r[zero]["hist"]):
            np.testing.assert_allclose(pm["loss"], float(jm["loss"]), rtol=2e-4)
        assert r[zero]["queue_ptr"] == 3 * BATCH
    queue = np.concatenate([res[m][zero]["state"]["queue"] for m in range(2)])
    np.testing.assert_allclose(queue, np.asarray(jstate.queue), rtol=1e-3, atol=1e-5)
    rep = res[0]["v2"]["state"]
    assert set(res[0][zero]["state"]) == set(rep)
    for k, v in rep.items():
        np.testing.assert_allclose(res[0][zero]["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    want = {k: v for k, v in jledger.items() if k.startswith("zero.")}
    assert want and {k: v for k, v in res[0][zero]["ledger"].items()
                     if k.startswith("zero.")} == want


def test_zero_checkpoint_resumes_across_layouts(runs):
    """A ZeRO stage-3 checkpoint of the 2 x 2 world (whole tensors: the shards
    gathered over the data group, the queue over the model group) loads into
    the replicated 1 x 2 world bit for bit, and the replicated 1 x 2
    checkpoint into the 2 x 2 ZeRO world; each then takes a finite step."""
    ranks, _, _, _ = runs
    saved = {w: [r["cross"]["saved"] for r in ranks[w]] for w in ("1x2", "2x2")}
    for w, other in (("1x2", "2x2"), ("2x2", "1x2")):
        for m, r in enumerate(ranks[w]):
            loaded = r["cross"]["loaded"]
            src = saved[other][m % 2]  # the same model rank's queue rows
            assert set(loaded) == set(src)
            for k, v in src.items():
                np.testing.assert_array_equal(loaded[k], v, err_msg=f"{w} {k}")
            assert r["cross"]["loaded_step"] == 1 and np.isfinite(r["cross"]["next_loss"])


@pytest.mark.parametrize("world", ["1x2", "2x2"])
def test_sequence_parallel_v3_gradient_is_the_dense_one(runs, world):
    """The sequence-parallel v3 step (64 tokens over 2 model ranks) against
    JAX's dense v3 step on the same state and batch: the loss within rtol
    1e-5, and the first step's gradients of every trained parameter, all
    together, within 1e-4 in L2 relative, each element within 1e-4 of the
    largest. JAX's own sequence-parallel step would give the backbone twice
    that gradient (ROADMAP.md, queue 3): that gradient is 0.3 or more off
    in L2 here. Every rank holds the same gradients and state."""
    ranks, jax_out, _, _ = runs
    want, loss = jax_out["v3"]
    res = ranks[world]
    for r in res:
        assert r["v3"]["digests"] == res[0]["v3"]["digests"]
    got = res[0]["v3"]["grads"][0]
    names = sorted(got)
    assert set(names) <= set(want) and len(names) > 40
    np.testing.assert_allclose(res[0]["v3"]["hist"][0]["loss"], loss, rtol=1e-5)
    flat = lambda g, scale=1.0: np.concatenate([
        g[k].ravel() * (scale if k.startswith("q.backbone") else 1.0) for k in names])
    w = flat(want)
    assert np.linalg.norm(flat(got) - w) / np.linalg.norm(w) < 1e-4
    for k in names:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert np.linalg.norm(flat(got, 2.0) - w) / np.linalg.norm(w) > 0.3
    for r in res[1:]:
        for k in names:
            np.testing.assert_array_equal(r["v3"]["grads"][0][k], got[k])


@pytest.mark.parametrize("world,case", [("1x2", "v3"), ("2x2", "v3"), ("2x2", "v3_z3")])
def test_sequence_parallel_v3_update_matches_the_port_dense_step(runs, world, case):
    """Two sequence-parallel v3 steps, replicated and (2 x 2) at ZeRO stage 3
    (the backbone's `grad.seq_psum`, then the update over the 2 data ranks),
    against the port's dense step (flash attention, one process, the whole
    batch) from the same state: the losses within rtol 1e-5, every
    parameter and BN statistic within rtol 1e-4 / atol 1e-5."""
    ranks, _, tree, _ = runs
    _, dense_cfg = _v3_configs(sp=False, num_model=1)
    state = convert.state_from_flax(dense_cfg, tree, device="cpu")
    step = make_train_step(dense_cfg, SPE, device="cpu")
    losses = []
    for v in _v3_views():
        losses.append(float(step(state, {"im_q": torch.from_numpy(v[0]),
                                         "im_k": torch.from_numpy(v[1])})["loss"]))
    res = ranks[world][0][case]
    np.testing.assert_allclose([h["loss"] for h in res["hist"]], losses, rtol=1e-5)
    one = dw.state_arrays(state)
    assert set(one) == set(res["state"])
    for k, v in one.items():
        np.testing.assert_allclose(res["state"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_sharded_queue_checkpoint_resumes_and_is_refused_at_one_model_rank(runs):
    """`train()` at num_model = 2: the checkpoint holds the whole (K, dim)
    queue (the ranks' shards in model order) and `num_model` in its extras;
    a run resumed from it ends bit for bit where the uninterrupted run
    does, on every rank; the same workdir at num_model = 1 is refused with
    JAX's resume line."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train

    ranks, _, _, ckpt_root = runs
    res = ranks["1x2"]
    for r in res:
        a, c = r["ckpt"]["a"], r["ckpt"]["c"]
        assert a["step"] == c["step"] == 4 and a["queue_ptr"] == c["queue_ptr"]
        assert c["losses"] == a["losses"][2:]
        for k in a["state"]:
            np.testing.assert_array_equal(c["state"][k], a["state"][k], err_msg=k)
    cfg_b = _ckpt_runs(ckpt_root)["b"][0]
    mgr = CheckpointManager(cfg_b.workdir)
    payload, extra = mgr.restore(step=2)
    mgr.close()
    want = np.concatenate([r["ckpt"]["b"]["state"]["queue"] for r in res])
    assert tuple(payload["state_dict"]["module.queue"].shape) == (16, 64)
    np.testing.assert_array_equal(payload["state_dict"]["module.queue"].t().numpy(), want)
    assert extra["num_model"] == 2
    one = dataclasses.replace(cfg_b, parallel=pc.ParallelConfig(num_model=1))
    with pytest.raises(ResumeCompatError, match="parallel.num_model: checkpoint=2 != config=1"):
        train(one, dataset=SyntheticDataset(32, 16), device="cpu", num_filters=4)
