"""The port's ZeRO layer (moco_tpu_torch/parallel/zero.py) against JAX's
(moco_tpu/parallel/zero.py) in one process: the host layout helpers, the
fusion buckets and layer groups built over each package's own encoder, the
analytic peak, the layout conversions against `reshard_state`, the config's
refusals with JAX's messages, the hoisted gather's overlap, and ZeRO at a
world of one (the step, its released modules, `train()` with a workdir).
tests/test_torch_zero_dist.py runs a world of two. Each test states its
tolerance.
"""

import dataclasses
import functools
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core import moco as jax_moco
from moco_tpu.parallel import create_mesh
from moco_tpu.parallel import zero as jz
from moco_tpu.utils import config as jc
from moco_tpu.utils import faults as jax_faults
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch.core.moco import build_encoder, build_predictor, create_state, make_train_step
from moco_tpu_torch.obs.schema import validate_line
from moco_tpu_torch.parallel import zero as pz
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import faults

IMG, B = 16, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's CPU work here is tiny: one intra-op thread keeps it from
    contending with the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("numel,n", [(1, 2), (7, 2), (8, 4), (10, 3), (4096, 8)])
def test_host_layout_helpers_equal_jax(numel, n):
    """padded_cols, shard_leaf_host and unshard_leaf_host give JAX's arrays
    bit for bit (zero padding, row r of rank r), and unshard inverts
    shard."""
    x = np.random.default_rng(numel).standard_normal((numel,)).astype(np.float32)
    x = x.reshape((numel // 2, 2) if numel % 2 == 0 else (numel,))
    assert pz.padded_cols(numel, n) == jz.padded_cols(numel, n)
    sh = pz.shard_leaf_host(x, n)
    np.testing.assert_array_equal(sh, jz.shard_leaf_host(x, n))
    np.testing.assert_array_equal(pz.unshard_leaf_host(sh, x.shape), x)
    np.testing.assert_array_equal(pz.unshard_leaf_host(sh, x.shape, np.float64),
                                  jz.unshard_leaf_host(sh, x.shape, np.float64))
    tree = {"a": {"w": x}, "b": x[:1]}
    got = pz.unshard_tree_host(jax.tree.map(lambda v: pz.shard_leaf_host(v, n), tree), tree)
    want = jz.unshard_tree_host(jax.tree.map(lambda v: jz.shard_leaf_host(v, n), tree), tree)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


def _leaves(specs):
    return [jax.ShapeDtypeStruct(shape, jnp.dtype(dt)) for shape, dt in specs]


@pytest.mark.parametrize("bucket_bytes", [64, 100, 1 << 20])
def test_bucket_plan_describe_equals_jax(bucket_bytes):
    """Greedy packing in leaf order, one open bucket per dtype, ragged
    tails, a leaf larger than a bucket alone: the port's table equals
    JAX's, f32 and bf16 leaves interleaved."""
    specs = [((3, 5), "float32"), ((7,), "bfloat16"), ((40,), "float32"), ((1,), "float32"),
             ((2, 2, 3), "bfloat16"), ((100,), "bfloat16"), ((9,), "float32"), ((), "float32")]
    for n in (2, 4):
        got = pz.BucketPlan(_leaves(specs), n, bucket_bytes)
        want = jz.BucketPlan(_leaves(specs), n, bucket_bytes)
        assert got.describe() == want.describe()
        assert len(got.describe()) > (1 if bucket_bytes < 1000 else 0)


def _encoders(v3: bool, nf: int = 8, hidden: int = 32):
    """(JAX encoder, JAX predictor, port config, JAX config) at small width."""
    if v3:
        moco = dict(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, v3=True,
                    shuffle="none", vit_patch_size=4, temperature=0.2)
    else:
        moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                    cifar_stem=True, shuffle="gather_perm")
    par = dict(shard_weight_update=True, zero_stage=3, zero_layer_granular=True,
               zero_bucket_mb=0.01)
    optim = dict(optimizer="adamw" if v3 else "sgd", lr=1e-3, epochs=2, cos=True)
    data = dict(dataset="synthetic", image_size=IMG, global_batch=B)
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                          data=jc.DataConfig(**data), parallel=jc.ParallelConfig(**par))
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                          data=pc.DataConfig(**data), parallel=pc.ParallelConfig(**par))
    from moco_tpu.models import resnet as jr
    from moco_tpu.models import vit as jv
    from moco_tpu.models.heads import ProjectionHead, V3MLPHead

    if v3:
        enc = jax_moco.MoCoEncoder(backbone=jv.create_vit("vit_tiny", patch_size=4),
                                   head=V3MLPHead(num_layers=3, hidden_dim=hidden, dim=16))
        pred = V3MLPHead(num_layers=2, hidden_dim=hidden, dim=16)
    else:
        enc = jax_moco.MoCoEncoder(
            backbone=jr.create_resnet("resnet18", num_filters=nf, cifar_stem=True),
            head=ProjectionHead(dim=16, mlp=True))
        pred = None
    return enc, pred, pcfg, jcfg


def _jax_zero_step(jcfg, enc, pred, n):
    """JAX's Zero23TrainStep at num_data = n (built, not compiled; its
    state template abstract)."""
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=2)
    state = jax.eval_shape(lambda: jax_moco.create_state(
        jax.random.PRNGKey(0), jcfg, enc, tx, jnp.zeros((1, IMG, IMG, 3)), predictor=pred,
        zero_num_data=n))
    mesh = create_mesh(num_data=n, num_model=1, devices=jax.devices()[:n])
    return jax_moco.make_train_step(jcfg, enc, tx, mesh, predictor=pred, total_steps=4,
                                    state_template=state)


@pytest.mark.parametrize("v3", [False, True], ids=["resnet", "vit"])
def test_plans_and_peak_equal_jax(v3):
    """Over each package's own encoder (and v3 predictor), at 2 ranks and
    10 kB buckets: the trainable and encoder bucket tables, the layer
    groups (names, leaves, buckets, full bytes; JAX's partition of the
    backbone's children, the head its own group) and `peak_full_bytes`
    equal JAX's, and so does `hbm_model_peak_bytes` under the layer
    schedule and the whole-tree one."""
    enc, pred, pcfg, jcfg = _encoders(v3)
    jstep = _jax_zero_step(jcfg, enc, pred, 2)
    state = create_state(pcfg, build_encoder(pcfg.moco, num_filters=8, mlp_hidden=32),
                         device="cpu", predictor=build_predictor(pcfg.moco, mlp_hidden=32),
                         zero_num_data=1)
    # the plans at n = 2, from the port's leaves
    zl = state.zero
    bb = int(pcfg.parallel.zero_bucket_mb * 1024 * 1024)
    assert pz.BucketPlan(zl.trainable, 2, bb).describe() == \
        jstep.bucket_plans["trainable"].describe()
    assert pz.BucketPlan(zl.enc, 2, bb).describe() == jstep.bucket_plans["enc"].describe()
    groups = [(g.name, g.indices) for g in zl.group_plan.groups]
    gp = pz.GroupPlan(zl.enc, groups, 2, bb)
    assert gp.describe() == jstep.group_plan.describe()
    assert gp.peak_full_bytes() == jstep.group_plan.peak_full_bytes()
    assert gp.total_full_bytes() == jstep.group_plan.total_full_bytes()
    for layer in (True, False):
        par = dict(zero_layer_granular=layer)
        j2 = _jax_zero_step(dataclasses.replace(
            jcfg, parallel=dataclasses.replace(jcfg.parallel, **par)), enc, pred, 2)
        cfg = dataclasses.replace(pcfg, parallel=dataclasses.replace(pcfg.parallel, **par))
        world = _FakeWorld(2)
        st = create_state(cfg, build_encoder(cfg.moco, num_filters=8, mlp_hidden=32),
                          device="cpu", predictor=build_predictor(cfg.moco, mlp_hidden=32),
                          zero_num_data=2, world=world)
        assert st.zero.hbm_model_peak_bytes == j2.hbm_model_peak_bytes, layer


class _FakeWorld:
    """Rank 0 of `n` data ranks with no process group: enough to build a
    layout (no collective is issued while building one)."""

    def __init__(self, n):
        from moco_tpu_torch.parallel.mesh import World

        self._w = World(device="cpu")
        self.world_size, self.rank, self.device = n, 0, torch.device("cpu")
        self.num_data, self.data_rank = n, 0  # the layout's axis
        self.ledger = self._w.ledger
        self.distributed = False


def test_layout_round_trips_equal_reshard_state():
    """Whole <-> (2, m) <-> (4, m) through the host helpers (unshard with
    the whole shape, shard at the target's n), each hop against JAX's
    `reshard_state` on the same trees (params and optimizer state), bit for
    bit; the port's in-memory layout (`BucketPlan.shard_leaves`) is the
    host one."""
    rng = np.random.default_rng(0)
    full = {"enc": {"a": rng.standard_normal((3, 5)).astype(np.float32),
                    "b": rng.standard_normal((7,)).astype(np.float32)}}

    def state(params):
        return jax_moco.MocoState(step=0, params_q=params, params_k=params, batch_stats_q={},
                                  batch_stats_k={}, queue=np.zeros((1, 1)), queue_ptr=0,
                                  opt_state=params)

    layouts = {1: full, **{n: jax.tree.map(lambda x, n=n: pz.shard_leaf_host(x, n), full)
                           for n in (2, 4)}}
    for src in layouts.values():
        whole = pz.unshard_tree_host(src, full)
        for n, dst in layouts.items():
            want = jax_moco.reshard_state(state(src), state(dst), state(full))
            got = whole if n == 1 else jax.tree.map(lambda x: pz.shard_leaf_host(x, n), whole)
            for a, b, c in zip(jax.tree.leaves(got), jax.tree.leaves(want.params_q),
                               jax.tree.leaves(want.opt_state)):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
    plan = pz.BucketPlan(_leaves([((3, 5), "float32"), ((7,), "float32")]), 4)
    for got, want in zip(plan.shard_leaves([torch.from_numpy(v) for v in full["enc"].values()]),
                         layouts[4]["enc"].values()):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["bad_stage", "lars", "layer_at_stage1", "no_num_data"])
def test_zero_refusals_carry_jax_messages(case):
    """A stage outside {1, 2, 3}, LARS, and the layer-granular schedule
    without stage >= 2 are refused by make_train_step with JAX's messages;
    create_state without zero_num_data too."""
    moco = dict(arch="resnet18", dim=16, num_negatives=64, cifar_stem=True, mlp=True)
    par = {"bad_stage": dict(shard_weight_update=True, zero_stage=4),
           "lars": dict(shard_weight_update=True, zero_stage=3),
           "layer_at_stage1": dict(zero_layer_granular=True),
           "no_num_data": dict(shard_weight_update=True)}[case]
    optim = dict(optimizer="lars" if case == "lars" else "sgd", epochs=2)
    data = dict(image_size=IMG, global_batch=B)
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**moco), optim=jc.OptimConfig(**optim),
                          data=jc.DataConfig(**data), parallel=jc.ParallelConfig(**par))
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                          data=pc.DataConfig(**data), parallel=pc.ParallelConfig(**par))
    if case == "no_num_data":
        tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=2)
        enc, _, _, _ = _encoders(False)
        with pytest.raises(ValueError) as want:
            jax_moco.create_state(jax.random.PRNGKey(0), jcfg, enc, tx,
                                  jnp.zeros((1, IMG, IMG, 3)))
        with pytest.raises(ValueError) as got:
            create_state(pcfg, build_encoder(pcfg.moco, num_filters=4), device="cpu")
    else:
        with pytest.raises(ValueError) as want:
            jax_moco.make_train_step(jcfg, None, None, create_mesh(num_data=1))
        with pytest.raises(ValueError) as got:
            make_train_step(pcfg, 2, device="cpu")
    assert str(got.value) == str(want.value)


def test_zero_fields_and_preset_equal_jax():
    """ParallelConfig's five ZeRO fields have JAX's defaults; the preset
    vit_b16_v3_huge_batch_zero3 is JAX's field for field (model, recipe,
    data, auto_scale and the ZeRO fields)."""
    for f in ("shard_weight_update", "zero_stage", "zero_bucket_mb", "zero_overlap_gather",
              "zero_layer_granular"):
        assert getattr(pc.ParallelConfig(), f) == getattr(jc.ParallelConfig(), f), f
    ours, theirs = pc.PRESETS["vit_b16_v3_huge_batch_zero3"], jc.PRESETS[
        "vit_b16_v3_huge_batch_zero3"]
    for section in ("moco", "optim", "data", "parallel"):
        for f in dataclasses.fields(getattr(ours, section)):
            if f.name == "timeout_s":  # the port's own
                continue
            assert getattr(getattr(ours, section), f.name) == getattr(
                getattr(theirs, section), f.name), (section, f.name)
    assert ours.auto_scale == theirs.auto_scale == "ref_batch=4096"
    pc.validate_zero(ours)


class _Out:
    def __init__(self):
        self.event = None


@pytest.mark.parametrize("hidden_s", [0.0, 0.3])
def test_async_gather_overlap_equals_jax(hidden_s):
    """`delay@site=zero.gather:seconds=0.2`: the worker absorbs the stall
    off the caller's thread; a caller that spends 0.3 s before `take()`
    hides it (overlap >= 0.95), one that takes at once hides almost none
    (overlap < 0.25) — the same reading as JAX's class on the same
    schedule (within 0.1). The gather runs on the caller's thread, and a
    closed gatherer refuses a submit."""
    results = {}
    for name, cls, fmod in (("port", pz.AsyncParamGather, faults),
                            ("jax", jz.AsyncParamGather, jax_faults)):
        threads = []
        g = cls(lambda s: (threads.append(threading.current_thread()), _Out())[1])
        fmod.install("delay@site=zero.gather:seconds=0.2")
        try:
            g.submit(None, 0)
            time.sleep(hidden_s)
            g.take()
        finally:
            fmod.install(None)
            g.close()
        assert threads == [threading.main_thread()]
        results[name] = g.last_overlap
        with pytest.raises(RuntimeError):
            g.submit(None, 1)
    assert abs(results["port"] - results["jax"]) <= 0.1, results
    if hidden_s:
        assert results["port"] >= 0.95
    else:
        assert results["port"] < 0.25


def _v2_config(**par):
    moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", shuffle="none")
    return pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(lr=0.05, epochs=2,
                                                                           cos=True),
                          data=pc.DataConfig(dataset="synthetic", image_size=IMG, global_batch=B,
                                             num_workers=1),
                          parallel=pc.ParallelConfig(**par))


LAYOUTS = {"stage1": dict(shard_weight_update=True),
           "stage3": dict(shard_weight_update=True, zero_stage=3, zero_bucket_mb=0.01),
           "layer": dict(shard_weight_update=True, zero_stage=3, zero_layer_granular=True,
                         zero_bucket_mb=0.01)}


@functools.lru_cache(maxsize=None)
def _replicated_run():
    return _run_one({})


def _run_one(par, steps=3):
    cfg = _v2_config(**par)
    torch.manual_seed(0)
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=8), device="cpu",
                         zero_num_data=1 if par else None)
    step = make_train_step(cfg, 2, device="cpu")
    losses = []
    for i in range(steps):
        v = np.random.default_rng(i).standard_normal((2, B, IMG, IMG, 3)).astype(np.float32)
        losses.append(float(step(state, {"im_q": torch.from_numpy(v[0]),
                                         "im_k": torch.from_numpy(v[1])})["loss"]))
    return state, losses


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_zero_at_one_rank_is_the_replicated_step_bit_for_bit(layout):
    """At a world of one every layout takes the replicated step's exact
    path (the same elementwise optimizer on the same values): 3 v2 steps
    give the same losses and the same whole tensors bit for bit, and at
    stage 2/3 the modules hold no parameters at rest — a forward on one
    fails instead of reading stale memory."""
    from moco_tpu_torch.utils.checkpoint import state_payload

    base, want = _replicated_run()
    state, got = _run_one(LAYOUTS[layout])
    assert got == want
    a = state_payload(base, "resnet18", 1)
    b = state_payload(state, "resnet18", 1)
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    if state.zero.stage23:
        assert state.zero.released("q") and state.zero.released("k")
        with pytest.raises(RuntimeError):
            state.encoder_q(torch.zeros(2, IMG, IMG, 3))


def test_train_under_zero3_with_the_hoisted_gather(tmp_path):
    """`train()` at stage 3 with the hoisted gather, a workdir and
    `delay@site=zero.gather:seconds=0.05`: the same losses as the
    replicated run; every training line passes the schema and carries
    `overlap/zero` (a number), `hbm_model_peak_bytes` and the shards'
    `hbm_state_bytes`; the checkpoint holds whole tensors and resumes
    into a stage-1 and a replicated state bit for bit."""
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.train import train
    from moco_tpu_torch.utils.checkpoint import CheckpointManager, load_state_payload

    common = dict(log_every=1, obs_probe_every=1, checkpoint_keep=0)
    data = SyntheticDataset(2 * B, IMG)
    base = train(dataclasses.replace(_v2_config(), **common), dataset=data, device="cpu",
                 num_filters=4)
    cfg = dataclasses.replace(_v2_config(**LAYOUTS["stage3"]), workdir=str(tmp_path), **common)
    faults.install("delay@site=zero.gather:seconds=0.05")
    try:
        out = train(cfg, dataset=data, device="cpu", num_filters=4)
    finally:
        faults.install(None)
    assert [r["loss"] for r in out["history"]] == [r["loss"] for r in base["history"]]
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    train_lines = [x for x in lines if "loss" in x]
    assert train_lines
    for line in train_lines:
        assert validate_line(line) == [], line
        assert isinstance(line["overlap/zero"], float)
        assert line["hbm_model_peak_bytes"] == out["state"].zero.hbm_model_peak_bytes
    payload, extra = CheckpointManager(str(tmp_path)).restore()
    assert extra["shard_weight_update"] and extra["zero_stage"] == 3 and extra["num_data"] == 1
    for par in (LAYOUTS["stage1"], {}):
        c = _v2_config(**par)
        st = create_state(c, build_encoder(c.moco, num_filters=4), device="cpu",
                          zero_num_data=1 if par else None)
        load_state_payload(st, payload)
        for k, v in base["state"].encoder_q.state_dict().items():
            assert torch.equal(st.encoder_q.state_dict()[k], v), k
