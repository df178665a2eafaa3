"""The port's ZeRO steps in a world of two ranks against JAX's ZeRO steps at
`num_data = 2` and against the port's own replicated data-parallel step
(tests/test_torch_dist_train.py's), on the CPU: 3 v2 SGD steps at stage
1, stage 3 and layer-granular, 2 v3 AdamW steps layer-granular with the frozen patch
embedding, the `comms/zero.*` ledger, the drift gauges and the analytic
peak; a stage-3 checkpoint resumed under every other layout and in one
process; the linear probe on the world against the one-process probe.

ONE spawned gloo world of 2 (tests/_torch_dist_worker.py `zero_job`) runs
every case while JAX takes its steps here; the tests read its results.
The tolerances are test_torch_dist_train.py's, at its width 8, batch 16
and 16 px (its ReLU-kink note) on a ResNet of one block per stage (ARCH).
Each test states its tolerance.
"""

import dataclasses
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
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models import vit as jax_vit
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.models.heads import V3MLPHead as FlaxV3Head
from moco_tpu.obs import comms as jax_comms
from moco_tpu.parallel import create_mesh, shard_batch
from moco_tpu.parallel.zero import shard_tree, unshard_tree_host
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core.moco import build_encoder, create_state
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils.checkpoint import CheckpointManager, load_state_payload
from test_torch_dist_train import IMG, NF, ROOT_KEY, SPE, B, _ledger, _permutations, _views

N = 2
BUCKET_MB = 0.01  # 10 kB fusion buckets: several per tree, a ragged tail
# A ResNet of one BasicBlock per stage (the stem, 4 blocks, two of them
# with a downsample branch): every ZeRO path, at half resnet18's JAX
# compile time. Registered in the port's arch table for this module's
# processes only (the ranks' `zero_job` and the `runs` fixture).
ARCH, STAGES = "resnet_tiny", (1, 1, 1, 1)
V3_B, V3_HIDDEN = 8, 32
ZERO = {
    "base": {},
    "stage1": dict(shard_weight_update=True, zero_bucket_mb=BUCKET_MB),
    "stage3": dict(shard_weight_update=True, zero_stage=3, zero_bucket_mb=BUCKET_MB),
    "layer": dict(shard_weight_update=True, zero_stage=3, zero_layer_granular=True,
                  zero_bucket_mb=BUCKET_MB),
}
V2_CASES = ("base", "stage1", "stage3", "layer")
V3_CASES = ("v3_base", "v3_layer")


def _configs(layout):
    """(JAX's, the port's) v2 config under a ZeRO layout of ZERO."""
    moco = dict(arch=ARCH, dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", fused_infonce=True,
                shuffle="gather_perm")
    optim = dict(lr=0.05, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=IMG, global_batch=B)
    par = ZERO[layout]
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco, fused_block_k=32),
                           optim=jc.OptimConfig(**optim), data=jc.DataConfig(**data),
                           parallel=jc.ParallelConfig(**par)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                           data=pc.DataConfig(**data), parallel=pc.ParallelConfig(**par)))


def _v3_configs(layout):
    moco = dict(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, momentum_cos=True,
                temperature=0.2, v3=True, shuffle="none", compute_dtype="float32",
                vit_patch_size=4, freeze_patch_embed=True)
    optim = dict(optimizer="adamw", lr=1e-3, weight_decay=0.1, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=IMG, global_batch=V3_B)
    par = ZERO[layout]
    return (jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                           data=jc.DataConfig(**data), parallel=jc.ParallelConfig(**par)),
            pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                           data=pc.DataConfig(**data), parallel=pc.ParallelConfig(**par)))


def _v3_views():
    return [_views(20 + i, V3_B, IMG) for i in range(2)]


def _tree(jstate, fields):
    return {f: jax.tree.map(np.asarray, getattr(jstate, f)) for f in fields}


def _jax_state(jcfg, encoder, predictor):
    """JAX's stage-1 ZeRO state at num_data = 2 (jitted init: the same draws
    as eager, in a fraction of the time)."""
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    init = jax.jit(lambda rng: jax_create_state(rng, jcfg, encoder, tx,
                                                jnp.zeros((1, IMG, IMG, 3)), predictor=predictor,
                                                zero_num_data=N))
    return init(jax.random.PRNGKey(0))


def _jax_run(jcfg, encoder, predictor, views, stage1_state):
    """JAX's state in the layout of `jcfg` (stage 2/3: `stage1_state`'s
    parameters in the (n, m) layout, as create_state lays them) as numpy
    trees, and run() of its steps: (final state, each step's metrics, the
    ledger after the first step, the step object)."""
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    jstate = stage1_state
    if jcfg.parallel.zero_stage >= 2:
        jstate = jstate.replace(**{f: shard_tree(getattr(jstate, f), N)
                                   for f in ("params_q", "params_k", "params_pred")})
    fields = ["step", "params_q", "batch_stats_q", "params_k", "batch_stats_k"]
    fields += (["params_pred", "batch_stats_pred"] if jcfg.moco.v3 else ["queue", "queue_ptr"])
    tree = _tree(jstate, fields)
    if jcfg.moco.v3:
        adam = jstate.opt_state[0]
        tree["adam"] = {"mu": jax.tree.map(np.asarray, adam.mu),
                        "nu": jax.tree.map(np.asarray, adam.nu), "count": np.asarray(adam.count)}
    else:
        tree["trace"] = jax.tree.map(np.asarray, jstate.opt_state[1][0].trace["enc"])

    def run():
        mesh = create_mesh(num_data=N, num_model=1, devices=jax.devices()[:N])
        jax_comms.reset()
        step = jax_make_train_step(jcfg, encoder, tx, mesh, predictor=predictor,
                                   total_steps=jcfg.optim.epochs * SPE, state_template=jstate)
        state = place_state(jstate, mesh, zero=True, zero_params=jcfg.parallel.zero_stage >= 2)
        rng = jax.device_put(jax.random.PRNGKey(ROOT_KEY),
                             jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
        hist, ledger = [], None
        for v in views:
            state, m = step(state, shard_batch(mesh, {"im_q": v[0], "im_k": v[1]}), rng)
            hist.append({k: np.asarray(x, np.float64) for k, x in m.items()})
            if ledger is None:
                ledger = _ledger(jax_comms.snapshot())
        return state, hist, ledger, step

    return tree, run


def _jax_v2(layouts):
    """{layout: _jax_run's pair} for the v2 ZeRO layouts, one initial state."""
    encoder = FlaxEncoder(
        backbone=jax_resnet.ResNet(stage_sizes=list(STAGES), block=jax_resnet.BasicBlock,
                                   num_filters=NF, cifar_stem=True, dtype=jnp.float32),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32))
    stage1 = _jax_state(_configs("stage1")[0], encoder, None)
    return {c: _jax_run(_configs(c)[0], encoder, None, [_views(i) for i in range(3)], stage1)
            for c in layouts}


def _jax_v3(layout):
    jcfg, _ = _v3_configs(layout)
    encoder = FlaxEncoder(
        backbone=jax_vit.create_vit("vit_tiny", patch_size=4),
        head=FlaxV3Head(num_layers=3, hidden_dim=V3_HIDDEN, dim=16, cross_replica_axis="data"))
    predictor = FlaxV3Head(num_layers=2, hidden_dim=V3_HIDDEN, dim=16, cross_replica_axis="data")
    return _jax_run(jcfg, encoder, predictor, _v3_views(),
                    _jax_state(_v3_configs("stage1")[0], encoder, predictor))


def _trio_inputs():
    """Each rank's (3, 5) leaf for the World's per-leaf trio."""
    return np.random.default_rng(7).standard_normal((N, 3, 5)).astype(np.float32)


def _probe_spec(root, pretrain_config):
    data = dataclasses.replace(pretrain_config.data, global_batch=8, num_workers=1)
    return {"pretrain": f"{root}/resume", "workdir": f"{root}/probe_world",
            "probe": pc.ProbeConfig(lr=1.0, epochs=2, schedule=(1,), num_classes=10),
            "data": data, "n_train": 24, "n_val": 12}


@functools.lru_cache(maxsize=None)
def _runs(root):
    """{"jax": {case: (tree, (state, metrics, ledger, step))}, "ranks": the
    world's per-rank results, "root": root}. The world starts first and
    runs while JAX takes its steps; its port cases start from JAX's
    initial state of the same layout (the base case from stage 3's, in
    ZeRO's layout, through state_from_flax)."""
    inits = _jax_v2(("stage1", "stage3", "layer"))
    inits.update({"v3_layer": _jax_v3("layer")})
    cases = []
    for c in V2_CASES:
        tree = inits["stage3" if c == "base" else c][0]
        cases.append((c, {"config": _configs(c)[1], "tree": tree, "num_filters": NF,
                          "steps_per_epoch": SPE, "views": [_views(i) for i in range(3)],
                          "perms": [_permutations("gather_perm", i, N) for i in range(3)]}))
    for c in V3_CASES:
        cases.append((c, {"config": _v3_configs(c[3:])[1], "tree": inits["v3_layer"][0],
                          "mlp_hidden": V3_HIDDEN, "steps_per_epoch": SPE,
                          "views": _v3_views()}))
    layouts = [(c, _configs(c)[1]) for c in ("stage3", "stage1", "base", "layer")]
    resume = {"layouts": layouts, "tree": inits["stage3"][0], "num_filters": NF,
              "steps_per_epoch": SPE, "views": [_views(i) for i in range(3)],
              "workdir": f"{root}/resume"}
    procs = dw.start_world(dw.zero_job, N, f"{root}/world", {
        "archs": {ARCH: STAGES}, "cases": cases, "resume": resume, "probe": _probe_spec(root, layouts[0][1]),
        "trio": _trio_inputs()})
    jax_out = {c: (tree, run()) for c, (tree, run) in inits.items()}
    ranks = dw.collect_world(procs, f"{root}/world")
    return {"jax": jax_out, "ranks": ranks, "root": root}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The module's one world and JAX's runs, with ARCH in the port's arch
    table and the parent's torch work on one thread, as the ranks have
    them; both are put back afterwards."""
    from moco_tpu_torch.models import resnet as port_resnet

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(port_resnet._CONFIGS, ARCH,
                       dict(stage_sizes=STAGES, block=port_resnet.BasicBlock))
            yield _runs(str(tmp_path_factory.mktemp("zero_dist")))
    finally:
        torch.set_num_threads(threads)


def _full(tree_leaves, template_tree):
    return unshard_tree_host(jax.tree.map(np.asarray, tree_leaves), template_tree)


def _assert_encoder(state, params, stats, side, template, rtol, atol):
    want = convert.encoder_from_flax(_full(params, template), jax.tree.map(np.asarray, stats))
    for name, arr in want.items():
        np.testing.assert_allclose(state[f"{side}.{name}"], arr.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{side}.{name}")


@pytest.mark.parametrize("case", ["stage1", "stage3", "layer"])
def test_zero_v2_steps_match_jax(runs, case):
    """Every rank against JAX's ZeRO step of the same layout at num_data = 2
    (gather_perm with JAX's permutations): per step the loss within rtol
    1e-5 and acc1/acc5 equal; after 3 steps params_q, params_k (JAX's
    (n, m) rows unsharded) and both encoders' BN statistics within rtol
    1e-3 / atol 5e-4, the queue within 5e-4 (test_torch_dist_train.py's
    tolerances); the ranks hold the same whole tensors after every step."""
    tree, (jstate, jhist, _, _) = runs["jax"][case]
    ranks = [r["cases"][case] for r in runs["ranks"]]
    assert ranks[1]["digests"] == ranks[0]["digests"], "ranks out of lockstep"
    res = ranks[0]
    for step, (jm, pm) in enumerate(zip(jhist, res["hist"])):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    template = jax.tree.map(np.asarray, runs["jax"]["stage1"][0]["params_q"])
    _assert_encoder(res["state"], jstate.params_q, jstate.batch_stats_q, "q", template,
                    1e-3, 5e-4)
    _assert_encoder(res["state"], jstate.params_k, jstate.batch_stats_k, "k", template,
                    1e-3, 5e-4)
    np.testing.assert_allclose(res["state"]["queue"], np.asarray(jstate.queue), atol=5e-4, rtol=0)
    assert res["step"] == 3


@pytest.mark.parametrize("case", ["stage1", "stage3", "layer", "v3_layer"])
def test_zero_steps_match_the_replicated_data_parallel_step(runs, case):
    """Against the port's replicated data-parallel step
    (test_torch_dist_train.py's; the same world, initial state and
    batches): each step's metrics and every whole
    tensor after the steps within 1e-6 relative (atol 1e-7 for zeros). At
    n = 2 they are bitwise: a sum of two is the same in any order, and the
    optimizers are elementwise."""
    base = "v3_base" if case.startswith("v3") else "base"
    for r in runs["ranks"]:
        got, want = r["cases"][case], r["cases"][base]
        for gm, wm in zip(got["hist"], want["hist"]):
            assert set(gm) == set(wm)
            for k in wm:
                np.testing.assert_allclose(gm[k], wm[k], rtol=1e-6, atol=1e-7, err_msg=k)
        assert set(got["state"]) == set(want["state"])
        for k, v in want["state"].items():
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-6, atol=1e-7, err_msg=k)
        assert got["digests"] == want["digests"], "not bitwise at n = 2"


def test_zero_v3_layer_steps_match_jax(runs):
    """2 v3 AdamW steps, layer-granular, freeze_patch_embed, SyncBN heads,
    against JAX's at num_data = 2: losses within rtol 2e-5, acc1/acc5
    equal; the predictor within rtol 1e-5 / atol 5e-5 (test_torch_dist_v3.py's).
    The encoders: every parameter element within what two AdamW runs can
    part by in 2 steps (4 lr (1 + wd)), since AdamW's normalized step turns
    a gradient of float32 noise into a move of up to lr; the 2-step update
    of the parameters (the key biases and the final norm's bias aside:
    their gradient is zero in exact arithmetic, a softmax and a BN being
    blind to a constant shift) and of the BN statistics each within 1e-3 of
    JAX's, relative in L2 (||port - jax|| / ||jax - init||; measured
    1.6e-4 and 3.5e-4, the latter the first head BN's mean taking up the
    final norm bias's noise). The patch embedding is its initial value bit
    for bit."""
    tree, (jstate, jhist, _, _) = runs["jax"]["v3_layer"]
    ranks = [r["cases"]["v3_layer"] for r in runs["ranks"]]
    assert ranks[1]["digests"] == ranks[0]["digests"]
    res = ranks[0]
    for step, (jm, pm) in enumerate(zip(jhist, res["hist"])):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=2e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    cfg = _v3_configs("base")[1]
    template_enc = convert.encoder_to_flax(
        build_encoder(cfg.moco, mlp_hidden=V3_HIDDEN).state_dict(), 3)[0]
    init = convert.encoder_from_flax(_full(tree["params_q"], template_enc),
                                     jax.tree.map(np.asarray, tree["batch_stats_q"]))
    # AdamW moves an element at most about lr (1 + wd) a step; where the
    # gradient is float32 noise it may move that far either way in each
    # package. The key biases and the final norm's bias have no gradient
    # at all in exact arithmetic (a softmax and a BN blind to a constant
    # shift), so their moves are noise alone and stay out of the L2 check.
    bound = 2 * 2 * cfg.optim.lr * (1 + cfg.optim.weight_decay)
    err = {"params": 0.0, "stats": 0.0}
    moved = {"params": 0.0, "stats": 0.0}
    for side, params, stats in (("q", jstate.params_q, jstate.batch_stats_q),
                                ("k", jstate.params_k, jstate.batch_stats_k)):
        want = convert.encoder_from_flax(_full(params, template_enc),
                                         jax.tree.map(np.asarray, stats))
        for name, arr in want.items():
            got, ref = res["state"][f"{side}.{name}"].astype(np.float64), arr.numpy()
            kind = "stats" if "running" in name else "params"
            if kind == "params":
                np.testing.assert_array_less(np.abs(got - ref), bound, err_msg=f"{side}.{name}")
                if name.endswith(("attn.key.bias", "final_norm.bias")):
                    continue
            err[kind] += float(((got - ref) ** 2).sum())
            moved[kind] += float(((ref - init[name].numpy()) ** 2).sum())
    rel = {k: (err[k] / moved[k]) ** 0.5 for k in err}
    assert rel["params"] <= 1e-3 and rel["stats"] <= 1e-3, rel
    from moco_tpu_torch.core.moco import build_predictor

    template_pred = convert.head_to_flax(
        build_predictor(cfg.moco, mlp_hidden=V3_HIDDEN).state_dict())[0]
    want = convert.predictor_from_flax(_full(jstate.params_pred, template_pred),
                                       jax.tree.map(np.asarray, jstate.batch_stats_pred))
    for name, arr in want.items():
        np.testing.assert_allclose(res["state"][f"pred.{name}"], arr.numpy(), rtol=1e-5,
                                   atol=5e-5, err_msg=name)
    for k in ("backbone.patch_embed.weight", "backbone.patch_embed.bias"):
        np.testing.assert_array_equal(res["state"][f"q.{k}"], init[k].numpy())


@pytest.mark.parametrize("case", ["stage1", "stage3", "layer", "v3_layer"])
def test_zero_comms_ledger_equals_jax_site_by_site(runs, case):
    """Every rank's ledger after the steps against JAX's after its trace:
    the same sites (`zero.grad_reduce_scatter` and
    `zero.params_all_gather` at stage 1; `zero.gather_q.b<i>`,
    `zero.gather_k.b<i>`, `zero.scatter.b<i>` at stage 3;
    `zero.gather.<q|k>.<group>.b<i>` and `zero.gather.q.pred.b<i>` under
    the layer schedule; the shuffle's and the queue's), each the same
    collective, operand bytes and bytes per step."""
    want = runs["jax"][case][1][2]
    assert any(k.startswith("zero.") for k in want)
    for r in runs["ranks"]:
        assert r["cases"][case]["ledger"] == want


@pytest.mark.parametrize("case", ["stage1", "stage3", "layer", "v3_layer"])
def test_zero_drift_gauges_and_peak_equal_jax(runs, case):
    """The EMA drift gauges of each step (sharded at stage 2/3: the ranks'
    squared norms summed before the sqrt) within rtol 1e-4 / atol 1e-6 of
    JAX's; `hbm_model_peak_bytes` JAX's exactly (None at stage 1); the
    modules hold no whole parameter at rest at stage 2/3, and each rank's
    shards are 1/n of the tree plus padding."""
    _, (_, jhist, _, jstep) = runs["jax"][case]
    res = runs["ranks"][0]["cases"][case]
    for jm, pm in zip(jhist, res["hist"]):
        keys = [k for k in jm if k.startswith("ema_drift")]
        assert keys
        for k in keys:
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert res["hbm_model_peak_bytes"] == getattr(jstep, "hbm_model_peak_bytes", None)
    if case != "stage1":
        assert res["released"] == [True, True]
        base = runs["ranks"][0]["cases"]["v3_base" if case.startswith("v3") else "base"]
        whole = sum(v.nbytes for k, v in base["state"].items()
                    if k.startswith(("q.", "k.", "pred.")) and "running" not in k
                    and "num_batches" not in k)
        assert whole / 2 <= res["shard_bytes"] <= whole / 2 + 4096


def test_zero3_checkpoint_resumes_under_every_layout(runs):
    """A stage-3 checkpoint written at a world of 2 (whole tensors, gathered
    onto rank 0) loads into stage 1, the replicated state and the
    layer-granular one in the same world, and into one process (the
    replicated state, and ZeRO at a world of one), each to the same whole
    tensors bit for bit; the next step from each world layout gives the
    same loss and tensors as the stage-3 run's own next step."""
    out = [r["resume"] for r in runs["ranks"]]
    ref = out[0]["stage3"]
    for r in out:
        for name, res in r.items():
            assert res["step"] == ref["step"] == 3, name
            assert set(res["state"]) == set(ref["state"]), name
            for k, v in ref["state"].items():
                np.testing.assert_array_equal(res["state"][k], v, err_msg=f"{name} {k}")
            assert res["next_loss"] == ref["next_loss"], name
            for k, v in ref["next_state"].items():
                np.testing.assert_array_equal(res["next_state"][k], v, err_msg=f"{name} {k}")
    payload, extra = CheckpointManager(f"{runs['root']}/resume").restore()
    for layout in ("base", "stage3"):
        cfg = _configs(layout)[1]
        state = create_state(cfg, build_encoder(cfg.moco, num_filters=NF), device="cpu",
                             zero_num_data=1 if layout != "base" else None)
        load_state_payload(state, payload)
        got = dw.full_state_arrays(state)
        assert set(got) == set(ref["state"])
        for k, v in ref["state"].items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"one process {layout} {k}")


def test_probe_on_a_world_matches_one_process(runs):
    """The linear probe at a world of 2 (each rank its rows of each batch,
    the classifier's gradients and the metrics averaged, the evaluation's
    sums summed, rank 0 writing) on the stage-3 checkpoint, against the
    one-process probe on the same data: the last validation's loss within
    rtol 1e-5 and the same top-1 / top-5, the classifier within rtol 1e-4
    / atol 1e-6 (the ranks' mean of two half-batch means reassociates the
    one batch's mean)."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.lincls import train_lincls

    root = runs["root"]
    spec = _probe_spec(root, _configs("stage3")[1])
    one = train_lincls(spec["pretrain"], spec["probe"], data=spec["data"],
                       workdir=f"{root}/probe_one",
                       train_dataset=SyntheticDataset(spec["n_train"], spec["data"].image_size),
                       val_dataset=SyntheticDataset(spec["n_val"], spec["data"].image_size),
                       device="cpu")
    world = runs["ranks"][0]["probe"]
    assert runs["ranks"][1]["probe"] == world
    np.testing.assert_allclose(world["loss"], one["loss"], rtol=1e-5)
    assert world["acc1"] == one["acc1"] and world["acc5"] == one["acc5"]
    assert world["count"] == one["count"] == spec["n_val"]
    got = CheckpointManager(spec["workdir"]).restore()[0]["state_dict"]
    want = CheckpointManager(f"{root}/probe_one").restore()[0]["state_dict"]
    for k in ("fc.weight", "fc.bias"):
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert torch.equal(got["conv1.weight"], want["conv1.weight"])


def test_world_per_leaf_trio_equals_jax_semantics(runs):
    """JAX's `scatter_mean`, `local_shard` and `unshard` as World methods, on
    each rank's (3, 5) leaf (15 elements: m = 8, one padding column): the
    ranks' mean on this rank's rows of the zero-padded flat leaf, this
    rank's rows of its own leaf, and every rank's rows gathered back into
    the leaf (rank r's rows from rank r), exactly; the sites in the ledger
    as JAX's cost model prices a psum_scatter of the padded leaf and an
    all_gather of the shard."""
    x = _trio_inputs()
    pad = lambda a: np.pad(a.reshape(-1), (0, N * 8 - a.size)).reshape(N, 8)  # noqa: E731
    for r, res in enumerate(runs["ranks"]):
        got = res["trio"]
        np.testing.assert_array_equal(got["scatter_mean"], pad(x.sum(0))[r] / N)
        np.testing.assert_array_equal(got["local_shard"], pad(x[r])[r])
        want = np.concatenate([pad(x[i])[i] for i in range(N)])[:15].reshape(3, 5)
        np.testing.assert_array_equal(got["unshard"], want)
        assert got["ledger"] == {"trio.scatter": ("psum_scatter", 64, 32),
                                 "trio.gather": ("all_gather", 32, 32)}
