"""Parity of the port's LARS (moco_tpu_torch/utils/schedules.py) with
`optax.lars` as moco_tpu/utils/schedules.py builds it, on the CPU: five
steps under a warmup-then-cosine lr, with leaves the `_bn_and_bias_mask`
excludes (biases, norm scales), a leaf whose norm is zero (a zero-init
token, as the ViT's `cls_token` at init) and a leaf whose gradient is zero.

Parameters and gradients are made with numpy and handed to both; both run
in float32. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from moco_tpu.utils import config as jc
from moco_tpu.utils import schedules as jax_schedules
from moco_tpu_torch.utils import config as pc
from moco_tpu_torch.utils import schedules

SPE = 2  # steps per epoch: 5 steps over 1 warmup epoch, then the cosine
OPTIM = dict(optimizer="lars", lr=4.8, weight_decay=1e-2, epochs=3, cos=True, warmup_epochs=1,
             trust_coefficient=0.001, momentum=0.9)


class Tiny(nn.Module):
    """A kernel and bias (Dense), a scale and bias (LayerNorm), a zero-init
    token and a kernel no loss reaches."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(4, 3)
        self.norm = nn.LayerNorm(3)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, 3))
        self.idle = nn.Linear(2, 2, bias=False)


def _flax_tree(m: Tiny) -> dict:
    a = lambda t: jnp.asarray(t.detach().numpy())
    return {"dense": {"kernel": a(m.dense.weight).T, "bias": a(m.dense.bias)},
            "norm": {"scale": a(m.norm.weight), "bias": a(m.norm.bias)},
            "cls_token": a(m.cls_token), "idle": {"kernel": a(m.idle.weight).T}}


def _grads(rng, m: Tiny, step: int) -> dict:
    """Per-parameter numpy gradients in the port's layout; the token's is
    zero on the first step (both norms zero), the idle kernel's always."""
    g = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in m.named_parameters()}
    if step == 0:
        g["cls_token"][:] = 0.0
    g["idle.weight"][:] = 0.0
    return g


def _flax_grads(g: dict) -> dict:
    return {"dense": {"kernel": jnp.asarray(g["dense.weight"].T), "bias": jnp.asarray(g["dense.bias"])},
            "norm": {"scale": jnp.asarray(g["norm.weight"]), "bias": jnp.asarray(g["norm.bias"])},
            "cls_token": jnp.asarray(g["cls_token"]),
            "idle": {"kernel": jnp.asarray(g["idle.weight"].T)}}


def test_lars_matches_optax_over_five_steps():
    """Every parameter after each of 5 steps, and the trace after the
    last, within 1e-6 relative to the leaf's largest value (+1e-7); the lr
    of each step is the schedule's, warmup then cosine, and the trace is
    never rescaled when it changes."""
    torch.manual_seed(0)
    m = Tiny()
    with torch.no_grad():
        m.norm.weight.uniform_(0.5, 1.5)
        m.norm.bias.normal_()
    tx = jax_schedules.build_optimizer(jc.OptimConfig(**OPTIM), steps_per_epoch=SPE)
    jparams = _flax_tree(m)
    jstate = tx.init(jparams)
    opt = schedules.build_optimizer(pc.OptimConfig(**OPTIM),
                                    schedules.decay_groups([m], OPTIM["weight_decay"]))
    assert isinstance(opt, schedules.LARS)
    sched = schedules.make_lr_schedule(pc.OptimConfig(**OPTIM), SPE)
    rng = np.random.default_rng(1)
    lrs = []
    for step in range(5):
        g = _grads(rng, m, step)
        updates, jstate = tx.update(_flax_grads(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        lrs.append(sched(step))
        for group in opt.param_groups:
            group["lr"] = lrs[-1]
        for n, p in m.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        want = _flax_tree_numpy(jparams)
        for n, p in m.named_parameters():
            ref = want[n]
            np.testing.assert_allclose(p.detach().numpy(), ref,
                                       atol=1e-6 * np.abs(ref).max() + 1e-7, rtol=0,
                                       err_msg=f"{n} after step {step}")
    assert lrs[0] < lrs[1] > lrs[2] == lrs[3] > lrs[4]  # warmup, then the per-epoch cosine
    trace = _flax_tree_numpy(jstate[-1].trace)
    for n, p in m.named_parameters():
        ref = trace[n]
        np.testing.assert_allclose(opt.state[p]["trace"].numpy(), ref,
                                   atol=1e-6 * np.abs(ref).max() + 1e-7, rtol=0, err_msg=n)


def _flax_tree_numpy(tree) -> dict:
    """A Flax-layout tree of the Tiny module back in the port's names and layout."""
    t = jax.tree.map(np.asarray, tree)
    return {"dense.weight": t["dense"]["kernel"].T, "dense.bias": t["dense"]["bias"],
            "norm.weight": t["norm"]["scale"], "norm.bias": t["norm"]["bias"],
            "cls_token": t["cls_token"], "idle.weight": t["idle"]["kernel"].T}


def test_lars_masks_by_flax_leaf_name():
    """The decay group holds the kernels and the token, the other the biases
    and the norm scale, as `_bn_and_bias_mask` decides on the Flax tree."""
    m = Tiny()
    decay, keep = schedules.decay_groups([m], 0.1)
    names = {id(p): n for n, p in m.named_parameters()}
    assert sorted(names[id(p)] for p in decay["params"]) == ["cls_token", "dense.weight",
                                                              "idle.weight"]
    assert sorted(names[id(p)] for p in keep["params"]) == ["dense.bias", "norm.bias",
                                                             "norm.weight"]
    mask = jax_schedules._bn_and_bias_mask(_flax_tree(m))
    flax_path = {"dense.weight": ("dense", "kernel"), "dense.bias": ("dense", "bias"),
                 "norm.weight": ("norm", "scale"), "norm.bias": ("norm", "bias"),
                 "cls_token": ("cls_token",), "idle.weight": ("idle", "kernel")}
    for n, p in m.named_parameters():
        leaf = mask
        for key in flax_path[n]:
            leaf = leaf[key]
        assert leaf == any(p is q for q in decay["params"]), n


@pytest.mark.parametrize("decay", [True, False])
def test_lars_trust_ratio_is_one_at_zero_norms(decay):
    """A zero parameter (and a zero gradient) take the update unscaled by
    the trust ratio: p = -lr * (g + wd * p), as optax's safe ratio gives."""
    p = nn.Parameter(torch.zeros(5))
    opt = schedules.LARS([{"params": [p], "weight_decay": 0.5, "decay": decay}], lr=0.1)
    p.grad = torch.arange(5.0)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), -0.1 * np.arange(5.0), atol=1e-7)
