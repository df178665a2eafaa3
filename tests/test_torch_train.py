"""Parity of the port's training slice (moco_tpu_torch) with the JAX package
on the CPU: losses, the fused InfoNCE (JAX's Pallas kernel in interpret
mode against the port's plain version), EMA, queue, schedules, SGD,
training-mode BatchNorm, `state_from_flax`, three whole train steps fused
and dense, the driver and the device rule.

Inputs and weights are made with numpy (or Flax's seeded init, carried
over by `convert`) and handed to both packages; both run in float32.
Each test states its tolerance.
"""

import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from moco_tpu.core import ema as jax_ema
from moco_tpu.core import queue as jax_queue
from moco_tpu.core.moco import MoCoEncoder as FlaxEncoder
from moco_tpu.core.moco import create_state as jax_create_state
from moco_tpu.core.moco import make_train_step as jax_make_train_step
from moco_tpu.core.moco import place_state
from moco_tpu.models import resnet as jax_resnet
from moco_tpu.models.heads import ProjectionHead as FlaxHead
from moco_tpu.ops import fused_infonce as jax_fused
from moco_tpu.ops import losses as jax_losses
from moco_tpu.parallel import create_mesh, shard_batch
from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch import convert
from moco_tpu_torch.core import ema, queue
from moco_tpu_torch.core import moco as port_moco
from moco_tpu_torch.core.moco import build_encoder, create_state, make_train_step
from moco_tpu_torch.data.datasets import SyntheticDataset
from moco_tpu_torch.models import resnet as port_resnet
from moco_tpu_torch.ops import fused_infonce, losses
from moco_tpu_torch.train import main as train_main
from moco_tpu_torch.train import train
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import schedules


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ------------------------------------------------------------------ losses


def test_dense_losses_match_jax():
    """infonce_logits, cross_entropy and topk_accuracy within 1e-6, with a
    forced tie so the top-k tie rule (lower index first) is exercised."""
    rng = np.random.default_rng(0)
    q, k, qu = _unit(rng, (8, 16)), _unit(rng, (8, 16)), _unit(rng, (64, 16))
    qu[3] = k[0]  # row 0's positive ties a negative
    jl, jlab = jax_losses.infonce_logits(jnp.asarray(q), jnp.asarray(k), jnp.asarray(qu), 0.2)
    tl, tlab = losses.infonce_logits(_t(q), _t(k), _t(qu), 0.2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    assert (tlab.numpy() == np.asarray(jlab)).all()
    logits = np.asarray(jl)
    np.testing.assert_allclose(
        float(losses.cross_entropy(_t(logits), tlab)),
        float(jax_losses.cross_entropy(jl, jlab)), atol=1e-6, rtol=0)
    for labels in (np.zeros(8, np.int64), rng.integers(0, 65, 8)):
        want = jax_losses.topk_accuracy(jl, jnp.asarray(labels, jnp.int32))
        got = losses.topk_accuracy(_t(logits), torch.from_numpy(labels))
        for name in ("acc1", "acc5"):
            assert abs(float(got[name]) - float(want[name])) <= 1e-6


# ------------------------------------------------------------- fused InfoNCE


@pytest.mark.parametrize("b,kk,block", [(8, 64, 32), (16, 96, 32)])
def test_infonce_stats_matches_pallas_kernel(b, kk, block):
    """The plain version the port runs on CPU tensors against JAX's Pallas
    kernel in interpret mode (a multi-tile grid): pos, lse within 1e-5 and
    n_above equal on tie-free data; the q-gradient of fused_infonce_loss
    against jax.grad within 1e-5."""
    rng = np.random.default_rng(b + kk)
    q, k, qu = _unit(rng, (b, 16)), _unit(rng, (b, 16)), _unit(rng, (kk, 16))
    want = jax_fused.infonce_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(qu), 0.2,
                                   block, True)
    got = fused_infonce.infonce_stats(_t(q), _t(k), _t(qu), 0.2)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    assert (got[2].numpy() == np.asarray(want[2])).all()

    def jloss(q):
        return jax_fused.fused_infonce_loss(q, jnp.asarray(k), jnp.asarray(qu), 0.2, block, True)[0]

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(q)))
    tq = _t(q).requires_grad_(True)
    loss, acc = fused_infonce.fused_infonce_loss(tq, _t(k), _t(qu), 0.2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss(jnp.asarray(q))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tq.grad.numpy(), jgrad, atol=1e-5, rtol=0)
    _, jacc = jax_fused.fused_infonce_loss(jnp.asarray(q), jnp.asarray(k), jnp.asarray(qu), 0.2,
                                           block, True)
    assert float(acc["acc1"]) == float(jacc["acc1"]) and float(acc["acc5"]) == float(jacc["acc5"])


@pytest.mark.parametrize("b", [1, 7, 64, 65, 256, 1000])
@pytest.mark.parametrize("kk", [1, 63, 64, 1000, 4096, 65536, 65537])
def test_split_plan_covers_every_tile_once(b, kk):
    """The kernels' split of K, including K not a multiple of the 64-row
    tile or of the split: every tile in exactly one split, none empty, for
    query rows per CTA from one m16 tile to 16 (`query_rows` reads the
    kernels' own from their library, on the card)."""
    tiles = -(-kk // fused_infonce.TILE_ROWS)
    for rows in (16, 64, 128, 256):
        n_split, per = fused_infonce.split_plan(b, kk, rows)
        assert n_split >= 1 and per >= 1
        assert (n_split - 1) * per < tiles <= n_split * per


def _tf32(x):
    """x rounded to TF32 as csrc/tf32_mma.cuh rounds it: add half a TF32 ulp
    and clear the 13 low bits (cvt.rna.tf32.f32)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_product_keeps_counts_and_lse_at_f32_level(seed):
    """The precision argument of the InfoNCE kernels, emulated in numpy on
    unit rows at T = 0.2: scores from one TF32 product (hi.hi) put n_above
    outside its float64 window (negatives within 1e-5 of pos may go either
    way) on some rows and move lse by more than 1e-6; the kernels' three
    split products (lo.hi + hi.lo + hi.hi, hi = tf32(x), lo = tf32(x - hi))
    keep every row inside its window and lse within 1e-6. Products are
    summed in float64 and rounded to f32 as the tensor cores' f32
    accumulator leaves them; pos is the f32 dot."""
    rng = np.random.default_rng(seed)
    b, kk, t = 64, 4096, 0.2
    q, k, qu = _unit(rng, (b, 128)), _unit(rng, (b, 128)), _unit(rng, (kk, 128))
    neg64 = q.astype(np.float64) @ qu.astype(np.float64).T / t
    pos64 = (q.astype(np.float64) * k).sum(1) / t
    diff = neg64 - pos64[:, None]
    lo = (diff > 1e-5).sum(1)
    hi = lo + (np.abs(diff) <= 1e-5).sum(1)

    def lse(pos, neg):
        x = np.concatenate([pos[:, None], neg], 1).astype(np.float64)
        m = x.max(1, keepdims=True)
        return m[:, 0] + np.log(np.exp(x - m).sum(1))

    want = lse(pos64, neg64)
    pos = (q * k).sum(1, dtype=np.float32) * np.float32(1 / t)
    q_hi, qu_hi = _tf32(q), _tf32(qu)
    q_lo, qu_lo = _tf32(q - q_hi), _tf32(qu - qu_hi)

    def product(x, y):
        return x.astype(np.float64) @ y.astype(np.float64).T

    outside, lse_err = {}, {}
    for name, acc in (("one", product(q_hi, qu_hi)),
                      ("split", product(q_lo, qu_hi) + product(q_hi, qu_lo)
                       + product(q_hi, qu_hi))):
        s = acc.astype(np.float32) * np.float32(1 / t)
        count = (s > pos[:, None]).sum(1)
        outside[name] = int(((count < lo) | (count > hi)).sum())
        lse_err[name] = float(np.abs(lse(pos, s) - want).max())
    assert outside["split"] == 0 and lse_err["split"] <= 1e-6, (outside, lse_err)
    assert outside["one"] > 0 and lse_err["one"] > 1e-6, (outside, lse_err)


# ------------------------------------------------------- EMA, queue, schedules


def test_ema_update_matches_jax():
    """In place, parameters only (BN buffers untouched): within 1e-7."""
    cfg = pc.MocoConfig(arch="resnet18", dim=16, mlp=True, cifar_stem=True)
    enc_q, enc_k = build_encoder(cfg, num_filters=4), build_encoder(cfg, num_filters=4)
    buffers = {n: b.clone() for n, b in enc_k.named_buffers()}
    pq = {n: p.detach().numpy().copy() for n, p in enc_q.named_parameters()}
    pk = {n: p.detach().numpy().copy() for n, p in enc_k.named_parameters()}
    ema.ema_update(enc_k, enc_q, 0.999)
    want = jax_ema.ema_update(pk, pq, 0.999)
    for n, p in enc_k.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[n]), atol=1e-7, rtol=0)
    for n, b in enc_k.named_buffers():
        assert torch.equal(b, buffers[n])


def test_queue_init_enqueue_wraparound_matches_jax():
    rows = queue.init_queue(torch.Generator().manual_seed(0), 16, 8)
    assert rows.shape == (16, 8)
    np.testing.assert_allclose(rows.norm(dim=1).numpy(), 1.0, atol=1e-6)
    base = _unit(np.random.default_rng(1), (16, 8))
    tq, jq, tp, jp = _t(base), jnp.asarray(base), 0, jnp.zeros((), jnp.int32)
    for i in range(5):  # 5 blocks of 4 rows in a 16-row queue: wraps once
        keys = _unit(np.random.default_rng(10 + i), (4, 8))
        tq, tp = queue.enqueue(tq, tp, _t(keys))
        jq, jp = jax_queue.enqueue(jq, jp, jnp.asarray(keys))
        assert tp == int(jp)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tp == 4
    with pytest.raises(ValueError, match="divisible"):
        queue.check_queue_divisibility(100, 8)


@pytest.mark.parametrize("optim", [
    dict(cos=True, epochs=5),
    dict(cos=False, schedule=(2, 4), epochs=6),
    dict(cos=True, epochs=10, warmup_epochs=2),
    dict(cos=False, schedule=(1,), epochs=3, warmup_epochs=1, lr=0.3),
])
def test_lr_schedule_matches_jax(optim):
    """Per-epoch granular lr at every step across epoch boundaries: within
    1e-7 absolute (both in float32; the two libraries' float32 cos may
    differ in the last bit, which 0.5 * (1 + cos) near -1 magnifies)."""
    spe = 3
    want = jax_schedules.make_lr_schedule(jc.OptimConfig(**optim), spe)
    got = schedules.make_lr_schedule(pc.OptimConfig(**optim), spe)
    for step in range(0, spe * optim["epochs"] + 2):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-7, step


def test_sgd_matches_optax_chain():
    """torch SGD(momentum, weight_decay) against add_decayed_weights -> sgd
    on the same tree, three updates with a changing lr: within 1e-6."""
    cfg = dict(lr=0.1, momentum=0.9, weight_decay=1e-2, cos=True, epochs=2)
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    tx = jax_schedules.build_optimizer(jc.OptimConfig(**cfg), steps_per_epoch=1)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jparams)
    tparams = {n: _t(v).requires_grad_(True) for n, v in params.items()}
    opt = schedules.build_optimizer(pc.OptimConfig(**cfg), list(tparams.values()))
    sched = schedules.make_lr_schedule(pc.OptimConfig(**cfg), 1)
    for step in range(3):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32) for n, v in params.items()}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for g in opt.param_groups:
            g["lr"] = sched(step)
        for n, p in tparams.items():
            p.grad = _t(grads[n])
        opt.step()
        for n, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[n]), atol=1e-6)
    with pytest.raises(ValueError, match="unknown optimizer"):
        schedules.build_optimizer(pc.OptimConfig(optimizer="adam"), list(tparams.values()))


# --------------------------------------------------------- BatchNorm training


def _flax_norm(train):
    return functools.partial(fnn.BatchNorm, use_running_average=not train, momentum=0.9,
                             epsilon=1e-5, dtype=jnp.float32)


def _fill(shapes, seed):
    """Numpy values for a Flax variable tree: He-normal kernels, BN
    scale/bias and running statistics away from 1/0."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if "'mean'" in name or "'bias'" in name:
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if "'var'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _block_state_dict(params, stats, n_main):
    out = {}
    for c in range(n_main):
        convert._convbn(out, f"conv{c + 1}", f"bn{c + 1}", params[f"ConvBN_{c}"],
                        stats[f"ConvBN_{c}"])
    if f"ConvBN_{n_main}" in params:
        convert._convbn(out, "downsample.0", "downsample.1", params[f"ConvBN_{n_main}"],
                        stats[f"ConvBN_{n_main}"])
    return out


# (name, flax module factory(norm), port module, state-dict mapping, input shape)
BN_CASES = {
    "convbn": (lambda norm: jax_resnet.ConvBN(8, 3, 2, norm),
               lambda: port_resnet.ConvBN(4, 8, 3, 2),
               lambda p, s: (lambda o: (convert._convbn(o, "0", "1", p, s), o)[1])({}),
               (6, 9, 9, 4)),
    "basic": (lambda norm: jax_resnet.BasicBlock(8, 2, norm),
              lambda: port_resnet.BasicBlock(4, 8, 2),
              lambda p, s: _block_state_dict(p, s, 2), (6, 8, 8, 4)),
    "bottleneck": (lambda norm: jax_resnet.Bottleneck(4, 1, norm),
                   lambda: port_resnet.Bottleneck(8, 4, 1),
                   lambda p, s: _block_state_dict(p, s, 3), (4, 6, 6, 8)),
}


@pytest.mark.parametrize("case", sorted(BN_CASES))
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_blocks_match_flax(case, train):
    """Outputs and the mutated running statistics (momentum 0.9 on the old
    value, biased variance) within 1e-5, in train and eval mode."""
    make_flax, make_port, mapping, shape = BN_CASES[case]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    mod = make_flax(_flax_norm(train))
    v = _fill(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=2)
    out, mut = mod.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = make_port()
    port.load_state_dict(_tensors(mapping(v["params"], v["batch_stats"])), strict=False)
    port.train(train)
    got = port(_t(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(out),
                               atol=1e-5, rtol=0)
    want_stats = mapping(v["params"], mut["batch_stats"])
    sd = port.state_dict()
    for name, arr in want_stats.items():
        if "running" in name:
            np.testing.assert_allclose(sd[name].numpy(), arr, atol=1e-5, rtol=0, err_msg=name)


def test_cifar_stem_backbone_trains_like_flax():
    """A whole resnet18 with the CIFAR stem in train mode: pooled features
    and every running statistic within 1e-5."""
    x = np.random.default_rng(4).standard_normal((4, 16, 16, 3)).astype(np.float32)
    mod = jax_resnet.create_resnet("resnet18", num_filters=4, cifar_stem=True, dtype=jnp.float32)
    v = _fill(jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              train=False)), seed=5)
    out, mut = mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = port_resnet.create_resnet("resnet18", num_filters=4, cifar_stem=True)
    port.load_state_dict(_tensors(convert.backbone_from_flax(v["params"], v["batch_stats"])),
                         strict=False)
    got = port.train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5, rtol=0)
    sd = port.state_dict()
    for name, arr in convert.backbone_from_flax(v["params"], mut["batch_stats"]).items():
        np.testing.assert_allclose(sd[name].numpy(), arr, atol=1e-5, rtol=0, err_msg=name)


# -------------------------------------------------- the slice as a whole


SPE = 2  # steps per epoch: the 3 steps cross an epoch boundary of the cosine lr
# Backbone width of the 3-step test. A ReLU has a kink at 0: a unit whose
# input lies within the two packages' float32 forward difference (~1e-5)
# of zero can be active in one and dead in the other, and the gradient
# then differs by far more than rounding. At width 8 (16 px, batch 8, this
# seed) one unit of layer3.0's first ReLU sits at +3.1e-6 in the port and
# -2.5e-6 in JAX, and a conv weight's gradient differs by 19%; with
# softplus in place of ReLU the two agree within ~2e-5 at widths 8, 16
# and 64. Width 16 has no such unit: the gradients agree within ~1.5e-5.
NF = 16


# The options of the v1/v2 step, each a 3-step trajectory against JAX:
# (MocoConfig fields, OptimConfig fields, TrainConfig fields). Virtual
# groups of 2 rows under gather_perm and a2a take JAX's own permutations
# with the batch; the large-batch variant runs LARS and momentum-statistics
# BN with auto_scale at kappa = 8 / 16.
VARIANTS = {
    "": ({}, {}, {}),
    "virtual_groups_gather_perm": (dict(bn_virtual_groups=4, shuffle="gather_perm"), {}, {}),
    "virtual_groups_a2a": (dict(bn_virtual_groups=4, shuffle="a2a"), {}, {}),
    "stats_rows": (dict(bn_stats_rows=3), {}, {}),
    "momentum_stats_lars_auto_scale": (
        dict(bn_momentum_stats=True),
        dict(optimizer="lars", lr=4.8, weight_decay=1e-6, warmup_epochs=1),
        dict(auto_scale="ref_batch=16")),
    "eman": (dict(key_bn_running_stats=True, shuffle="none"), {}, {}),
    "eman_no_warmup": (dict(key_bn_running_stats=True, key_bn_stats_warmup=False,
                            shuffle="none"), {}, {}),
    "remat": (dict(remat=True), {}, {}),
}


def _configs(fused, variant=""):
    moco_x, optim_x, top_x = VARIANTS[variant]
    moco = dict(arch="resnet18", dim=16, num_negatives=64, temperature=0.2, mlp=True,
                cifar_stem=True, compute_dtype="float32", fused_infonce=fused, **moco_x)
    optim = dict(dict(lr=0.05, epochs=2, cos=True), **optim_x)
    data = dict(dataset="synthetic", image_size=16, global_batch=8)
    return (  # the Pallas tile is the JAX config's alone
        jc.TrainConfig(moco=jc.MocoConfig(**moco, fused_block_k=32), optim=jc.OptimConfig(**optim),
                       data=jc.DataConfig(**data), **top_x),
        pc.TrainConfig(moco=pc.MocoConfig(**moco), optim=pc.OptimConfig(**optim),
                       data=pc.DataConfig(**data), **top_x),
    )


def _numpy_state(state, optimizer="sgd"):
    """A JAX MocoState's contents as numpy trees, as state_from_flax takes
    them; `trace` is SGD's momentum trace, or LARS's (the chain's last)."""
    tree = {f: jax.tree.map(np.asarray, getattr(state, f)) for f in (
        "step", "params_q", "batch_stats_q", "params_k", "batch_stats_k", "queue", "queue_ptr")}
    trace = state.opt_state[-1] if optimizer == "lars" else state.opt_state[1][0]
    tree["trace"] = jax.tree.map(np.asarray, trace.trace["enc"])
    return tree


def _gauges(metrics) -> dict:
    """A step's health gauges (its metrics beside loss, accuracy and lr)
    as float64 numpy values."""
    return {k: np.asarray(v, np.float64) for k, v in metrics.items()
            if k not in ("loss", "acc1", "acc5", "lr")}


def _jax_permutations(shuffle, rng, step, batch):
    """The permutations JAX's step draws at `step` on one device, as the
    port's batch takes them: gather_perm's `perm`, a2a's `pre` and `post`."""
    step_rng = jax.random.fold_in(rng, step)
    if shuffle == "gather_perm":
        return {"perm": jax.random.permutation(step_rng, batch)}
    local = lambda salt: jax.random.permutation(
        jax.random.fold_in(jax.random.fold_in(step_rng, salt), 0), batch)
    return {"pre": local(17), "post": local(29)}


@functools.lru_cache(maxsize=None)
def _trajectories(fused, variant=""):
    """3 steps of JAX make_train_step on a one-device mesh and of the port's,
    the port starting from state_from_flax of the JAX create_state, both
    fed the same pre-augmented views (and, under Shuffle-BN, the same
    permutations), both configs through their package's apply_auto_scale."""
    jcfg, pcfg = _configs(fused, variant)
    jcfg, jinfo = jc.apply_auto_scale(jcfg)
    pcfg, pinfo = pc.apply_auto_scale(pcfg)
    assert jinfo == pinfo
    m = jcfg.moco
    encoder = FlaxEncoder(
        backbone=jax_resnet.create_resnet(
            "resnet18", num_filters=NF, cifar_stem=True, dtype=jnp.float32,
            bn_stats_rows=m.bn_stats_rows, bn_virtual_groups=m.bn_virtual_groups,
            bn_momentum_stats=m.bn_momentum_stats),
        head=FlaxHead(dim=16, mlp=True, dtype=jnp.float32),
    )
    tx = jax_schedules.build_optimizer(jcfg.optim, steps_per_epoch=SPE)
    mesh = create_mesh(num_data=1, num_model=1, devices=jax.devices()[:1])
    jstate = jax_create_state(jax.random.PRNGKey(0), jcfg, encoder, tx, jnp.zeros((1, 16, 16, 3)))
    pstate = convert.state_from_flax(pcfg, _numpy_state(jstate, jcfg.optim.optimizer),
                                     device="cpu", num_filters=NF)
    jstate = place_state(jstate, mesh)
    jstep = jax_make_train_step(jcfg, encoder, tx, mesh)
    pstep = make_train_step(pcfg, SPE, device="cpu")
    root = jax.random.PRNGKey(3)
    rng = jax.device_put(root, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec()))
    hist = []
    for i in range(3):
        views = np.random.default_rng(10 + i).standard_normal((2, 8, 16, 16, 3)).astype(np.float32)
        batch = {"im_q": _t(views[0]), "im_k": _t(views[1])}
        if m.bn_virtual_groups > 1 and m.shuffle in ("gather_perm", "a2a"):
            batch.update({k: torch.from_numpy(np.asarray(v, np.int64)) for k, v in
                          _jax_permutations(m.shuffle, root, i, 8).items()})
        jstate, jm = jstep(jstate, shard_batch(mesh, {"im_q": views[0], "im_k": views[1]}), rng)
        pm = pstep(pstate, batch)
        hist.append(({**{k: float(jm[k]) for k in ("loss", "acc1", "acc5")},
                      "gauges": _gauges(jm)},
                     {**{k: float(pm[k]) for k in ("loss", "acc1", "acc5", "lr")},
                      "gauges": _gauges(pm)}))
    return jstate, pstate, hist


def _assert_trajectories_match(jstate, pstate, hist):
    """Per step: loss rtol 1e-5, acc1/acc5 equal. After 3 steps: params_q,
    params_k and both encoders' BN statistics rtol 1e-3 / atol 5e-4 (the
    tolerance tests/test_fused_train_step.py calibrates for float32
    reassociation amplified by momentum SGD), the queue atol 5e-4, and
    queue_ptr exact."""
    for step, (jm, pm) in enumerate(hist):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5, err_msg=f"step {step}")
        assert pm["acc1"] == jm["acc1"] and pm["acc5"] == jm["acc5"], step
    for enc, params, stats in ((pstate.encoder_q, jstate.params_q, jstate.batch_stats_q),
                               (pstate.encoder_k, jstate.params_k, jstate.batch_stats_k)):
        sd = enc.state_dict()
        want = convert.encoder_from_flax(jax.tree.map(np.asarray, params),
                                         jax.tree.map(np.asarray, stats))
        for name, arr in want.items():
            np.testing.assert_allclose(sd[name].numpy(), arr.numpy(), rtol=1e-3, atol=5e-4,
                                       err_msg=name)
    np.testing.assert_allclose(pstate.queue.numpy(), np.asarray(jstate.queue), atol=5e-4, rtol=0)
    assert pstate.queue_ptr == int(jstate.queue_ptr) == 24 and pstate.step == int(jstate.step) == 3


@pytest.mark.parametrize("fused", [True, False])
def test_three_train_steps_match_jax(fused):
    """`_assert_trajectories_match` on the plain v2 step, fused and dense;
    fused, JAX runs its Pallas kernel in interpret mode on a 2-tile grid
    (K=64, block 32)."""
    jstate, pstate, hist = _trajectories(fused)
    _assert_trajectories_match(jstate, pstate, hist)
    lrs = [pm["lr"] for _, pm in hist]
    assert lrs[0] == lrs[1] > lrs[2]  # the epoch boundary of the cosine schedule


@pytest.mark.parametrize("variant", sorted(v for v in VARIANTS if v))
def test_three_train_steps_of_each_option_match_jax(variant):
    """`_assert_trajectories_match` for each option of the step (VARIANTS),
    through the fused loss."""
    _assert_trajectories_match(*_trajectories(True, variant))


def test_remat_leaves_the_step_unchanged():
    """Remat on and off in the port: the same losses and, after 3 steps,
    the same parameters, BN statistics, momentum buffers and queue within
    1e-6 (the recompute runs the same float32 forward)."""
    _, plain, hist_plain = _trajectories(True)
    _, remat, hist_remat = _trajectories(True, "remat")
    for (_, a), (_, b) in zip(hist_plain, hist_remat):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
    for enc_a, enc_b in ((plain.encoder_q, remat.encoder_q), (plain.encoder_k, remat.encoder_k)):
        sd_b = enc_b.state_dict()
        for name, t in enc_a.state_dict().items():
            np.testing.assert_allclose(sd_b[name].numpy(), t.numpy(), atol=1e-6, rtol=0,
                                       err_msg=name)
    bufs_b = [remat.optimizer.state[p]["momentum_buffer"] for p in remat.encoder_q.parameters()]
    for p, b in zip(plain.encoder_q.parameters(), bufs_b):
        np.testing.assert_allclose(b.numpy(), plain.optimizer.state[p]["momentum_buffer"].numpy(),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(remat.queue.numpy(), plain.queue.numpy(), atol=1e-6, rtol=0)


def test_state_from_flax_carries_the_momentum_trace():
    """Mid-trajectory: the JAX state after 3 steps converted by
    state_from_flax has the port's own momentum buffers after the same 3
    steps (rtol 1e-3 / atol 5e-4), and every parameter, statistic and the
    queue exactly as the JAX trees hold them."""
    jstate, pstate, _ = _trajectories(True)
    _, pcfg = _configs(True)
    tree = _numpy_state(jstate)
    conv = convert.state_from_flax(pcfg, tree, device="cpu", num_filters=NF)
    assert conv.step == 3 and conv.queue_ptr == 24
    np.testing.assert_array_equal(conv.queue.numpy(), tree["queue"])
    want = convert.encoder_from_flax(tree["params_q"], tree["batch_stats_q"])
    for name, t in conv.encoder_q.state_dict().items():
        if name in want:
            np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    mine = dict(pstate.encoder_q.named_parameters())
    for name, p in conv.encoder_q.named_parameters():
        buf = conv.optimizer.state[p]["momentum_buffer"]
        ref = pstate.optimizer.state[mine[name]]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), ref.numpy(), rtol=1e-3, atol=5e-4, err_msg=name)
    assert not any(p.requires_grad for p in conv.encoder_k.parameters())


# ------------------------------------------------------- config, driver, device


@pytest.mark.parametrize("preset", ["cifar_smoke", "imagenet100_v2", "imagenet_v2",
                                    "imagenet_v2_large_batch", "vit_b16_v3"])
def test_presets_match_the_jax_config_field_for_field(preset):
    ours, theirs = pc.PRESETS[preset], jc.PRESETS[preset]
    for section in ("moco", "optim", "data"):
        for f in dataclasses.fields(getattr(ours, section)):
            assert getattr(getattr(ours, section), f.name) == getattr(
                getattr(theirs, section), f.name), (section, f.name)
            assert getattr(type(getattr(ours, section))(), f.name) == getattr(
                type(getattr(theirs, section))(), f.name), (section, f.name)
    assert ours.seed == theirs.seed and ours.steps_per_epoch == theirs.steps_per_epoch
    assert ours.auto_scale == theirs.auto_scale
    assert pc.PRESETS["imagenet_v2"].moco.temperature == 0.2


@pytest.mark.parametrize("preset,batch", [("imagenet_v2_large_batch", None),
                                          ("imagenet_v2_large_batch", 1024),
                                          ("imagenet_v2_large_batch", 4096),
                                          ("imagenet_v2", None)])
def test_apply_auto_scale_matches_jax(preset, batch):
    """The live lr and momentum and the info dict equal JAX's exactly (the
    same float arithmetic), the BN momentum and every other field
    unscaled; with momentum_cos the ramp starts from m ** kappa."""
    ours, theirs = pc.PRESETS[preset], jc.PRESETS[preset]
    if batch is not None:
        ours = dataclasses.replace(ours, data=dataclasses.replace(ours.data, global_batch=batch))
        theirs = dataclasses.replace(theirs,
                                     data=dataclasses.replace(theirs.data, global_batch=batch))
    (got, got_info), (want, want_info) = pc.apply_auto_scale(ours), jc.apply_auto_scale(theirs)
    assert got_info == want_info
    assert (got.optim.lr, got.moco.momentum) == (want.optim.lr, want.moco.momentum)
    assert dataclasses.replace(got, optim=ours.optim, moco=ours.moco) == ours
    if got_info is None:
        assert got == ours
        return
    kappa = got.data.global_batch / 4096
    assert got_info["kappa"] == kappa and got.optim.lr == 4.8 * kappa
    cos = dataclasses.replace(got.moco, momentum_cos=True)
    ramp = port_moco.make_ema_momentum(cos, 100)
    np.testing.assert_allclose(ramp(0), 0.999 ** kappa, rtol=1e-6)
    assert ramp(100) == 1.0


@pytest.mark.parametrize("spec,message", [("ref_batch=0", "needs ref_batch"),
                                          ("batch=4", "unknown auto-scale param"),
                                          (":", "needs ref_batch")])
def test_parse_auto_scale_raises_as_jax(spec, message):
    for parse in (jc.parse_auto_scale, pc.parse_auto_scale):
        with pytest.raises(ValueError, match=message):
            parse(spec)
    assert pc.parse_auto_scale("ref_batch=256:") == jc.parse_auto_scale("ref_batch=256:") == 256


# MocoConfig fields of a gate case -> the message both packages raise, or
# None where both build. One device: JAX's build_encoder at num_data=None.
ENCODER_GATES = [
    (dict(arch="vit_tiny", bn_virtual_groups=2), "apply to ResNet BatchNorm"),
    (dict(arch="vit_tiny", bn_momentum_stats=True), "apply to ResNet BatchNorm"),
    (dict(bn_virtual_groups=2, shuffle="syncbn"), "does not compose with syncbn"),
    (dict(bn_stats_barrier=True), "bn_stats_barrier requires bn_stats_rows > 0"),
    (dict(bn_virtual_groups=2, shuffle="none"), "needs a key permutation"),
    (dict(bn_virtual_groups=2, v3=True, num_negatives=0), "needs a key permutation"),
    (dict(bn_virtual_groups=2, v3=True, num_negatives=0, key_bn_running_stats=True),
     "needs a key permutation"),
    (dict(bn_virtual_groups=2, shuffle="none", allow_leaky_bn=True), None),
    (dict(bn_virtual_groups=2, shuffle="none", key_bn_running_stats=True), None),
    (dict(bn_virtual_groups=2, shuffle="a2a"), None),
    (dict(bn_stats_rows=3, shuffle="none"), None),
    (dict(bn_stats_rows=3, bn_stats_barrier=True), None),
    (dict(bn_momentum_stats=True, shuffle="none"), None),
]


@pytest.mark.parametrize("fields,message", ENCODER_GATES)
def test_build_encoder_gates_match_jax(fields, message):
    """build_encoder refuses what JAX's refuses on one device, message for
    message, and builds what it builds."""
    from moco_tpu.core.moco import build_encoder as jax_build_encoder

    base = dict(arch="resnet18", dim=16, num_negatives=64, cifar_stem=True,
                vit_patch_size=8)
    jcfg, pcfg = jc.MocoConfig(**{**base, **fields}), pc.MocoConfig(**{**base, **fields})
    if message is None:
        jax_build_encoder(jcfg)
        build_encoder(pcfg, num_filters=4, mlp_hidden=8)
        return
    with pytest.raises(ValueError, match=message) as want:
        jax_build_encoder(jcfg)
    with pytest.raises(ValueError, match=message) as got:
        build_encoder(pcfg, num_filters=4, mlp_hidden=8)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [dict(v3=True, num_negatives=0, shuffle="none"),
                                    dict(shuffle="gather_perm"), dict(shuffle="a2a")])
def test_make_train_step_gates_the_eman_key_forward_as_jax(fields):
    """key_bn_running_stats with v3, gather_perm or a2a: make_train_step
    raises JAX's ValueError, message for message."""
    moco = {**dict(arch="resnet18", dim=16, num_negatives=64, cifar_stem=True,
                   key_bn_running_stats=True), **fields}
    data = dict(global_batch=8, image_size=16)
    jcfg = jc.TrainConfig(moco=jc.MocoConfig(**moco), data=jc.DataConfig(**data))
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(**moco), data=pc.DataConfig(**data))
    mesh = create_mesh(num_data=1, num_model=1, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as want:
        jax_make_train_step(jcfg, None, None, mesh)
    with pytest.raises(ValueError) as got:
        make_train_step(pcfg, 1, device="cpu")
    assert str(got.value) == str(want.value)


def test_config_rejects_what_the_slice_does_not_run():
    """The Pallas tile and `prefetch_donate` stay out of the port's config;
    the analysis's four runtime fields are in it with JAX's defaults;
    `syncbn_group_size`,
    `ParallelConfig(num_data, num_model)`, `vit_sequence_parallel`, the
    ZeRO fields and `TrainConfig.elastic` (a top-level field, as in JAX)
    are in it."""
    with pytest.raises(TypeError):
        pc.MocoConfig(fused_block_k=1)
    with pytest.raises(TypeError):
        pc.TrainConfig(prefetch_donate=True)
    for field in ("strict_tracing", "recompile_warmup_steps", "sanitize_collectives",
                  "sanitize_threads"):
        assert getattr(pc.TrainConfig(), field) == getattr(jc.TrainConfig(), field), field
    with pytest.raises(TypeError):
        pc.ParallelConfig(elastic=True)
    assert pc.TrainConfig(elastic=True).elastic and not pc.TrainConfig().elastic
    assert {f.name for f in dataclasses.fields(jc.TrainConfig)} >= {"elastic"}
    assert pc.MocoConfig(syncbn_group_size=2).syncbn_group_size == 2
    assert pc.MocoConfig(vit_sequence_parallel=True).vit_sequence_parallel
    assert pc.TrainConfig(parallel=pc.ParallelConfig(num_data=4)).parallel.num_data == 4
    assert pc.ParallelConfig(num_model=2).num_model == 2
    port_fields = {f.name for c in (pc.TrainConfig, pc.MocoConfig, pc.OptimConfig,
                                    pc.DataConfig, pc.ParallelConfig) for f in dataclasses.fields(c)}
    assert port_fields & {f.name for f in dataclasses.fields(jc.ParallelConfig)} == {
        "num_data", "num_model", "shard_weight_update", "zero_stage", "zero_bucket_mb",
        "zero_overlap_gather", "zero_layer_granular"}


@pytest.mark.parametrize("fused", [None, True, False])
def test_train_step_takes_the_fused_loss_for_any_k(monkeypatch, fused):
    """K = 2048 + 64 is no multiple of the JAX kernel's 2048-row tile: the
    step still takes the fused loss, by default (None) too, unless
    fused_infonce=False, and the dense chain only then."""
    from moco_tpu_torch.core import moco as port_moco

    calls = {"fused": 0, "dense": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(port_moco, "fused_infonce_loss",
                        count("fused", port_moco.fused_infonce_loss))
    monkeypatch.setattr(port_moco, "infonce_logits", count("dense", port_moco.infonce_logits))
    cfg = _configs(fused)[1]
    cfg = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, num_negatives=2112))
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=4), device="cpu")
    views = np.random.default_rng(0).standard_normal((2, 8, 16, 16, 3)).astype(np.float32)
    out = make_train_step(cfg, 1, device="cpu")(state, {"im_q": _t(views[0]), "im_k": _t(views[1])})
    assert calls == ({"fused": 0, "dense": 1} if fused is False else {"fused": 1, "dense": 0})
    assert np.isfinite(float(out["loss"])) and state.queue_ptr == 8


def test_train_driver_runs_on_cpu():
    """Two steps; the probe samples every step (`obs_probe_every=1`), so every
    record carries step_ms."""
    cfg = pc.PRESETS["cifar_smoke"]
    cfg = dataclasses.replace(
        cfg, moco=dataclasses.replace(cfg.moco, num_negatives=64, dim=16),
        data=dataclasses.replace(cfg.data, dataset="synthetic", global_batch=16),
        obs_probe_every=1)
    out = train(cfg, dataset=SyntheticDataset(64, 32), device="cpu", steps=2, num_filters=4)
    assert len(out["history"]) == 2 and out["state"].queue_ptr == 32
    for rec in out["history"]:
        assert all(np.isfinite(rec[k]) for k in ("loss", "acc1", "acc5", "lr", "step_ms"))


def test_train_cli_builds_a_preset(capsys, monkeypatch):
    """`python -m moco_tpu_torch.train` wiring: the preset, the dataset
    override and the device reach train(); zero steps print nothing. The
    BN, EMAN, remat, optimizer and auto-scale flags reach the config
    train() is given, on imagenet100_v2."""
    assert train_main(["--preset", "cifar_smoke", "--data", "synthetic", "--steps", "0",
                       "--device", "cpu"]) == 0
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="cifar10 needs data_dir"):
        train_main(["--preset", "cifar_smoke", "--steps", "0", "--device", "cpu"])
    from moco_tpu_torch import train as train_module

    seen = []
    monkeypatch.setattr(train_module, "train", lambda cfg, **kw: seen.append((cfg, kw)))
    common = ["--preset", "imagenet100_v2", "--data", "synthetic", "--steps", "0",
              "--device", "cpu"]
    assert train_main(common + ["--shuffle", "a2a", "--bn-virtual-groups", "8", "--remat",
                                "--optimizer", "lars", "--auto-scale", "ref_batch=512"]) == 0
    assert train_main(common + ["--shuffle", "none", "--key-bn-eval", "--no-key-bn-stats-warmup",
                                "--bn-stats-rows", "32", "--bn-stats-barrier",
                                "--bn-momentum-stats"]) == 0
    assert train_main(common) == 0
    (a, kw), (b, _), (plain, _) = seen
    assert kw == {"device": "cpu", "steps": 0, "log": kw["log"]}
    assert (a.moco.shuffle, a.moco.bn_virtual_groups, a.moco.remat, a.optim.optimizer,
            a.auto_scale) == ("a2a", 8, True, "lars", "ref_batch=512")
    assert (b.moco.shuffle, b.moco.key_bn_running_stats, b.moco.key_bn_stats_warmup,
            b.moco.bn_stats_rows, b.moco.bn_stats_barrier, b.moco.bn_momentum_stats) == (
        "none", True, False, 32, True, True)
    want = pc.PRESETS["imagenet100_v2"]
    assert plain == dataclasses.replace(want, data=dataclasses.replace(want.data,
                                                                       dataset="synthetic"))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot be shown here")
    cfg = _configs(False)[1]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(cfg, dataset=SyntheticDataset(8, 16), steps=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_state(cfg, build_encoder(cfg.moco, num_filters=4))
