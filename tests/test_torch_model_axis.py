"""The port's model axis in one process, against JAX: the world's layout
and groups against `create_mesh`, the merge of the queue shards' InfoNCE
statistics against a dense logsumexp and count, the model axis's config
(the fields, the preset, the refusals with JAX's messages, the resume
rule) and the ring's ledger site. tests/test_torch_model_axis_dist.py runs
worlds of 1 x 2 and 2 x 2 ranks. Each test states its tolerance.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.core import moco as jax_moco
from moco_tpu.models import vit as jax_vit
from moco_tpu.obs import comms as jax_comms
from moco_tpu.parallel import create_mesh
from moco_tpu.utils import config as jc
from moco_tpu_torch.core.moco import build_encoder, make_train_step
from moco_tpu_torch.models.vit import create_vit, sequence_parallel_ring
from moco_tpu_torch.obs.comms import CommsLedger
from moco_tpu_torch.ops.fused_infonce import infonce_stats_reference, merge_shard_stats
from moco_tpu_torch.parallel.mesh import World, mesh_layout, split_world
from moco_tpu_torch.parallel.ring_attention import SITE, Ring, ring_attention_with_lse
from moco_tpu_torch.utils import config as pc


def _message(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("num_data,num_model", [(1, 2), (2, 2), (4, 2)])
def test_world_layout_is_create_meshs_device_order(num_data, num_model):
    """Rank r sits where device r sits on JAX's (data, model) mesh: its data
    index is the mesh row, its model index the column; the data group of a
    model index is a mesh column and the model group of a data index a
    row. JAX's message when the devices do not divide by the model axis."""
    n = num_data * num_model
    mesh = create_mesh(num_data=None, num_model=num_model, devices=jax.devices()[:n])
    ids = np.vectorize(lambda d: d.id)(mesh.devices) - min(d.id for d in jax.devices()[:n])
    assert mesh.devices.shape == (num_data, num_model)
    np.testing.assert_array_equal(mesh_layout(num_data, num_model), ids)
    for r in range(n):
        w = World(rank=r, world_size=n, num_model=num_model, device="cpu")
        d, m = (int(x[0]) for x in np.nonzero(ids == r))
        assert (w.num_data, w.data_rank, w.model_rank) == (num_data, d, m)
        assert r in ids[:, m] and r in ids[d]
    with pytest.raises(ValueError) as want:
        create_mesh(num_data=None, num_model=3, devices=jax.devices()[:n])
    assert _message(lambda: split_world(n, 3)) == str(want.value)


def test_shard_stat_merge_equals_the_dense_row():
    """The lse and count over the whole queue from n = 1, 2 and 4 shards'
    (pos, lse_m, above_m) against logsumexp and the count over the whole
    row (the plain version on the whole queue), on rows where pos dominates
    the negatives by far, where the negatives dominate pos, and random
    rows: lse within 2e-6 relative, the counts equal; in float64 the merged
    lse's gradient in pos and q equals the dense one's within 1e-10."""
    rng = np.random.default_rng(0)
    b, kk, c, t = 12, 96, 16, 0.05
    q = rng.standard_normal((b, c))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    k = rng.standard_normal((b, c))
    queue = rng.standard_normal((kk, c))
    queue /= np.linalg.norm(queue, axis=1, keepdims=True)
    k[:4] = q[:4]  # pos dominates: every negative far below it
    k[4:8] = -q[4:8]  # the negatives dominate pos
    k /= np.linalg.norm(k, axis=1, keepdims=True)
    for dtype, tol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
        qt, kt, qu = (torch.tensor(x, dtype=dtype) for x in (q, k, queue))
        pos, lse, above = infonce_stats_reference(qt, kt, qu, t)
        assert (lse[:4] - pos[:4]).max() < 1e-2 and (lse[4:8] - pos[4:8]).min() > 5.0
        for n in (1, 2, 4):
            parts = [infonce_stats_reference(qt, kt, s, t) for s in qu.chunk(n)]
            got, got_above = merge_shard_stats(pos, torch.stack([p[1] for p in parts]),
                                               torch.stack([p[2] for p in parts]))
            np.testing.assert_allclose(got.numpy(), lse.numpy(), rtol=tol)
            assert torch.equal(got_above, above)
    # gradients, float64: the merge is differentiable in pos and every lse_m
    qt = torch.tensor(q, requires_grad=True)
    kt, qu = torch.tensor(k), torch.tensor(queue)

    def merged(x):
        parts = [infonce_stats_reference(x, kt, s, t) for s in qu.chunk(4)]
        pos = parts[0][0]
        return (merge_shard_stats(pos, torch.stack([p[1] for p in parts]),
                                  torch.stack([p[2] for p in parts]))[0] - pos).mean()

    def dense(x):
        pos, lse, _ = infonce_stats_reference(x, kt, qu, t)
        return (lse - pos).mean()

    g_merged, = torch.autograd.grad(merged(qt), qt)
    g_dense, = torch.autograd.grad(dense(qt), qt)
    np.testing.assert_allclose(g_merged.numpy(), g_dense.numpy(), atol=1e-10)


def test_model_axis_config_matches_jax():
    """`ParallelConfig.num_model`, `MocoConfig.vit_sequence_parallel` and the
    preset `vit_b16_v3_highres_sp` equal JAX's field for field, defaults
    included; `resume_compat_diff` gives JAX's lines for both fields."""
    assert pc.ParallelConfig().num_model == jc.ParallelConfig().num_model == 1
    assert pc.MocoConfig().vit_sequence_parallel is jc.MocoConfig().vit_sequence_parallel is False
    ours, theirs = pc.PRESETS["vit_b16_v3_highres_sp"], jc.PRESETS["vit_b16_v3_highres_sp"]
    for section in ("moco", "optim", "data"):
        for f in dataclasses.fields(getattr(ours, section)):
            assert getattr(getattr(ours, section), f.name) == getattr(
                getattr(theirs, section), f.name), (section, f.name)
    assert ours.parallel.num_model == theirs.parallel.num_model == 8
    assert ours.auto_scale == theirs.auto_scale
    saved = {"config": pc.config_to_dict(ours)}
    for live_p, live_j in (
            (dataclasses.replace(ours, parallel=pc.ParallelConfig(num_model=1)),
             dataclasses.replace(theirs, parallel=jc.ParallelConfig(num_model=1))),
            (dataclasses.replace(ours, moco=dataclasses.replace(ours.moco,
                                                                vit_sequence_parallel=False)),
             dataclasses.replace(theirs, moco=dataclasses.replace(theirs.moco,
                                                                  vit_sequence_parallel=False)))):
        got = pc.resume_compat_diff(saved, live_p)
        assert got == jc.resume_compat_diff(saved, live_j, 8) and len(got) == 1
    assert pc.resume_compat_diff(saved, ours) == []


def test_refusals_carry_jax_messages():
    """Sequence parallelism without a ViT arch, without v3, without gap
    pooling (`create_backbone`); a layer-group apply of a sequence-parallel
    ViT; a sharded queue whose K does not divide by num_model x batch
    (JAX's `make_train_step` on a (1, 2) mesh); the ZeRO refusals on the
    model axis, JAX's text, and stages 1-3 on it accepted, as JAX accepts
    them; the ViT's own (cls pooling, tokens not dividing the ring), JAX's
    text; and the port's: a step whose world has another model axis than
    the config."""
    for kw in (dict(arch="resnet18", vit_sequence_parallel=True),
               dict(arch="vit_tiny", vit_sequence_parallel=True, vit_pool="gap"),
               dict(arch="vit_tiny", vit_sequence_parallel=True, v3=True, num_negatives=0)):
        want = _message(lambda: jax_moco.create_backbone(jc.MocoConfig(**kw)))
        assert _message(lambda: build_encoder(pc.MocoConfig(**kw))) == want
    sp = create_vit("vit_tiny", image_size=16, patch_size=4, pool="gap", sequence_parallel=True)
    jsp = jax_vit.create_vit("vit_tiny", image_size=16, patch_size=4, pool="gap",
                             sequence_axis="model")
    want = _message(lambda: jsp.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                     group="embed"))
    assert _message(lambda: sp.forward_group("embed", torch.zeros(1, 16, 16, 3))) == want
    src = inspect.getsource(jax_vit)
    with sequence_parallel_ring(Ring(group=object(), size=3)):
        msg = _message(lambda: sp(torch.zeros(1, 16, 16, 3)))
    assert msg == "16 tokens not divisible by sequence axis size 3"
    assert "tokens not divisible by sequence axis size" in src
    cls = create_vit("vit_tiny", image_size=16, patch_size=4, pool="cls", sequence_parallel=True)
    with sequence_parallel_ring(Ring(group=object(), size=2)):
        msg = _message(lambda: cls(torch.zeros(1, 16, 16, 3)))
    assert f'"{msg}"' in src

    from test_train_step import K as TINY_K
    from test_train_step import tiny_config, tiny_encoder

    from moco_tpu.utils.schedules import build_optimizer as jax_build_optimizer

    def jax_step(cfg, n_model):
        mesh = create_mesh(num_data=1, num_model=n_model, devices=jax.devices()[:n_model])
        return jax_moco.make_train_step(cfg, tiny_encoder(), jax_build_optimizer(
            cfg.optim, steps_per_epoch=10), mesh, state_template=object())

    jcfg = dataclasses.replace(tiny_config(), data=dataclasses.replace(
        tiny_config().data, global_batch=TINY_K))
    want = _message(lambda: jax_step(jcfg, 2))
    pcfg = pc.TrainConfig(moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=TINY_K),
                          data=pc.DataConfig(global_batch=TINY_K),
                          parallel=pc.ParallelConfig(num_model=2))
    world = World(world_size=2, num_model=2, device="cpu")
    assert _message(lambda: make_train_step(pcfg, 2, device="cpu", world=world)) == want
    for par, moco in ((dict(num_model=2), {}), ({}, dict(vit_sequence_parallel=True))):
        zero = dict(shard_weight_update=True, zero_stage=3, zero_layer_granular=True, **par)
        jz = dataclasses.replace(tiny_config(), parallel=jc.ParallelConfig(**zero),
                                 moco=dataclasses.replace(tiny_config().moco, **moco))
        want = _message(lambda: jax_step(jz, par.get("num_model", 1)))
        cfg = pc.TrainConfig(moco=pc.MocoConfig(**moco), parallel=pc.ParallelConfig(**zero))
        assert _message(lambda: pc.validate_zero(cfg)) == want
    for stage in (1, 2, 3):  # JAX runs them: tests/test_torch_model_axis_dist.py
        zero = dict(shard_weight_update=True, zero_stage=stage, num_model=2)
        assert pc.validate_zero(pc.TrainConfig(parallel=pc.ParallelConfig(**zero))) is None
    other = pc.TrainConfig(moco=pc.MocoConfig(arch="resnet18", dim=16, num_negatives=64),
                           data=pc.DataConfig(global_batch=8))
    assert "the world's model axis has 2" in _message(
        lambda: make_train_step(other, 2, device="cpu", world=world))


def test_ring_of_one_is_the_flash_call_and_ledger_is_jaxs():
    """A ring of one rank (no group) is one flash call: out and lse equal
    `flash_attention_with_lse`'s bit for bit. The ring's ledger site has
    JAX's cost: a ppermute of (k, v) per ring step, n calls a step
    (moco_tpu/obs/comms.py's model at n = 4)."""
    from moco_tpu_torch.ops.flash_attention import flash_attention_with_lse

    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 10, 32, generator=gen) for _ in range(3))
    ledger = CommsLedger()
    out, lse = ring_attention_with_lse(q, k, v, Ring(ledger=ledger))
    want_out, want_lse = flash_attention_with_lse(q, k, v)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert ledger.snapshot()[SITE].bytes_per_step == 0
    ledger.record(SITE, "ppermute", 2 * q.numel() * 4, 4, calls_per_step=4)
    jax_comms.reset()
    with jax_comms.tag(SITE, "ppermute", (jnp.asarray(k.numpy()), jnp.asarray(v.numpy())), 4,
                       calls_per_step=4):
        pass
    want = jax_comms.snapshot()[SITE]
    got = ledger.snapshot()[SITE]
    assert (got.bytes_per_step, got.calls_per_step) == (want.bytes_per_step, want.calls_per_step)
    jax_comms.reset()
