"""Parity of the port's BatchNorm training modes (moco_tpu_torch/models/resnet.py)
with the JAX package's `BatchNorm` (moco_tpu/models/resnet.py) on the CPU:
`stats_rows`, `virtual_groups` and `momentum_stats`, beside the full-batch
mode; outputs, input and parameter gradients and running statistics, a
whole ResNet-18 in each mode, the validation errors, and the virtual-groups
oracle: G groups over a permuted batch are G devices' per-device BN.

Inputs and weights are made with numpy and handed to both packages, which
run in float32. Each test states its tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.models import resnet as jax_resnet
from moco_tpu_torch import convert
from moco_tpu_torch.core import ema
from moco_tpu_torch.models import resnet as port_resnet
from moco_tpu_torch.parallel import shuffle

# (JAX BatchNorm keywords = the port's, batch rows)
MODES = {
    "full": (dict(), 8),
    "stats_rows_3": (dict(stats_rows=3), 8),
    "stats_rows_all": (dict(stats_rows=8), 8),
    "stats_rows_past_batch": (dict(stats_rows=12), 8),
    "stats_rows_barrier": (dict(stats_rows=5, stats_barrier=True), 8),
    "virtual_groups_2": (dict(virtual_groups=2), 8),
    "virtual_groups_4": (dict(virtual_groups=4), 8),
    "virtual_groups_1": (dict(virtual_groups=1), 8),
    "momentum_stats": (dict(momentum_stats=True), 8),
}
C = 6


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _layer_inputs(rows, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 5, 5, C)) * 2 + 1).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)  # the output's cotangent
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                            "bias": (0.1 * rng.standard_normal(C)).astype(np.float32)},
                 "batch_stats": {"mean": (0.1 * rng.standard_normal(C)).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, C).astype(np.float32)}}
    return x, w, variables


def _jax_layer(kw, x, w, variables):
    """Output, gradients of sum(out * w) in x, scale and bias, and the
    mutated statistics of JAX's BatchNorm in training mode."""
    bn = jax_resnet.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, **kw)

    def f(x, params):
        out, mut = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (out, stats)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jax.tree.map(jnp.asarray, variables["params"]))
    return {"out": out, "gx": gx, "gscale": gp["scale"], "gbias": gp["bias"],
            "mean": stats["mean"], "var": stats["var"]}


def _port_layer(kw, x, w, variables):
    bn = port_resnet.BatchNorm(C, **kw)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    xt = _nchw(x).requires_grad_(True)
    out = bn.train()(xt)
    (out * _nchw(w)).sum().backward()
    nhwc = lambda t: t.detach().permute(0, 2, 3, 1).numpy()
    return {"out": nhwc(out), "gx": nhwc(xt.grad), "gscale": bn.weight.grad.numpy(),
            "gbias": bn.bias.grad.numpy(), "mean": bn.running_mean.numpy(),
            "var": bn.running_var.numpy()}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batchnorm_mode_matches_jax(mode):
    """Output, the input gradient, the scale and bias gradients and both
    running statistics within 1e-5 (absolute, on values of order one;
    the gradients relative to their largest value)."""
    kw, rows = MODES[mode]
    x, w, variables = _layer_inputs(rows)
    want, got = _jax_layer(kw, x, w, variables), _port_layer(kw, x, w, variables)
    for name in ("out", "mean", "var"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]), atol=1e-5, rtol=0,
                                   err_msg=name)
    for name in ("gx", "gscale", "gbias"):
        ref = np.asarray(want[name])
        np.testing.assert_allclose(got[name], ref, atol=1e-5 * np.abs(ref).max(), rtol=0,
                                   err_msg=name)


def test_batchnorm_modes_keep_dtype_and_layout():
    """A bf16 channels-last input comes out bf16 and channels-last in every
    mode, so the convolutions behind it stay in bf16 (the JAX layer
    normalizes in the input's dtype for the same reason); the running
    statistics stay float32."""
    x = _nchw(_layer_inputs(8)[0]).to(torch.bfloat16)
    for mode, (kw, _) in sorted(MODES.items()):
        bn = port_resnet.BatchNorm(C, **kw).train()
        out = bn(x)
        assert out.dtype == torch.bfloat16, mode
        assert out.is_contiguous(memory_format=torch.channels_last), mode
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32, mode


@pytest.mark.parametrize("kw,message", [
    (dict(stats_rows=-1), "stats_rows must be >= 0"),
    (dict(virtual_groups=-2), "virtual_groups must be >= 0"),
    (dict(stats_rows=4, virtual_groups=2), "stats_rows and virtual_groups are mutually exclusive"),
    (dict(stats_barrier=True), "stats_barrier requires stats_rows > 0"),
    (dict(momentum_stats=True, stats_rows=4), "momentum_stats is mutually exclusive"),
    (dict(momentum_stats=True, virtual_groups=2), "momentum_stats is mutually exclusive"),
    (dict(virtual_groups=3), "batch 8 not divisible by virtual_groups 3"),
])
def test_batchnorm_modes_raise_as_jax(kw, message):
    """The same ValueError in both packages: JAX's when the layer is
    applied, the port's when it is built, but for the batch's
    divisibility, which waits for a batch in both."""
    x, _, _ = _layer_inputs(8)
    bn = jax_resnet.BatchNorm(use_running_average=False, **kw)
    with pytest.raises(ValueError, match=message):
        bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match=message):
        port_resnet.BatchNorm(C, **kw).train()(_nchw(x))


def test_batchnorm_eval_ignores_the_training_modes():
    """Eval mode normalizes with the running statistics whatever the mode,
    bit for bit as nn.BatchNorm2d does."""
    x, _, variables = _layer_inputs(8)
    ref = torch.nn.BatchNorm2d(C).eval()
    for mode, (kw, _) in sorted(MODES.items()):
        bn = port_resnet.BatchNorm(C, **kw).eval()
        for m in (ref, bn):
            with torch.no_grad():
                m.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
                m.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
        assert torch.equal(bn(_nchw(x)), ref(_nchw(x))), mode


# ---------------------------------------------------------- whole backbone


NF = 16
BACKBONE_MODES = {
    "stats_rows": dict(bn_stats_rows=3),
    "virtual_groups": dict(bn_virtual_groups=4),
    "momentum_stats": dict(bn_momentum_stats=True),
}


@pytest.mark.parametrize("mode", sorted(BACKBONE_MODES))
def test_backbone_in_each_mode_trains_like_flax(mode):
    """ResNet-18 with the CIFAR stem at width 16, every BN in the mode, in
    training mode on 8 images: pooled features within 1e-4 and every
    running statistic within 1e-5 of JAX's create_resnet with the same
    keywords (a whole encoder sums its convolutions in another order than
    Flax's, convert.py)."""
    kw = BACKBONE_MODES[mode]
    x = np.random.default_rng(4).standard_normal((8, 16, 16, 3)).astype(np.float32)
    mod = jax_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True,
                                   dtype=jnp.float32, **kw)
    v = jax.jit(lambda x: mod.init(jax.random.PRNGKey(0), x, train=False))(jnp.asarray(x))
    v = jax.tree.map(np.asarray, v)
    out, mut = mod.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    port = port_resnet.create_resnet("resnet18", num_filters=NF, cifar_stem=True, **kw)
    port.load_state_dict({k: torch.from_numpy(np.array(a, np.float32)) for k, a in
                          convert.backbone_from_flax(v["params"], v["batch_stats"]).items()},
                         strict=False)
    got = port.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-4, rtol=0)
    want = convert.backbone_from_flax(v["params"], jax.tree.map(np.asarray, mut["batch_stats"]))
    sd = port.state_dict()
    for name, arr in want.items():
        if "running" in name:
            np.testing.assert_allclose(sd[name].numpy(), arr, atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("groups", [2, 4])
def test_virtual_groups_over_a_permuted_batch_are_per_device_bn(groups):
    """The oracle of tests/test_resnet.py's virtual-groups test in torch
    terms: a backbone with `bn_virtual_groups=G` on the permuted batch,
    its features unpermuted, equals G copies of the full-batch backbone
    (G devices with per-device BN), each on its own contiguous slice of the
    permuted batch, within 1e-5; its running statistics are the mean of the
    G copies' (the cross-device mean of the JAX step), within 1e-6."""
    torch.manual_seed(0)
    grouped = port_resnet.create_resnet("resnet18", num_filters=8, cifar_stem=True,
                                        bn_virtual_groups=groups).train()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 12, 12, 3))
                         .astype(np.float32))
    perm, inv_perm = shuffle.make_permutation(torch.Generator().manual_seed(1), 16)
    devices = []
    for _ in range(groups):
        dev = port_resnet.create_resnet("resnet18", num_filters=8, cifar_stem=True).train()
        dev.load_state_dict(grouped.state_dict())
        devices.append(dev)
    with torch.no_grad():
        got = shuffle.unshuffle_gather(grouped(shuffle.shuffle_gather(x, perm)), inv_perm)
        slices = shuffle.shuffle_gather(x, perm).chunk(groups)
        want = shuffle.unshuffle_gather(torch.cat([d(s) for d, s in zip(devices, slices)]),
                                        inv_perm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    per_device = [d.state_dict() for d in devices]
    for name, t in grouped.state_dict().items():
        if "running" in name:
            mean = torch.stack([sd[name] for sd in per_device]).mean(0)
            np.testing.assert_allclose(t.numpy(), mean.numpy(), atol=1e-6, rtol=0, err_msg=name)


def test_virtual_groups_differ_from_whole_batch_bn():
    """The control of the oracle: whole-batch BN over the same permuted
    batch gives other features, by far more than the oracle's 1e-5."""
    torch.manual_seed(0)
    grouped = port_resnet.create_resnet("resnet18", num_filters=8, cifar_stem=True,
                                        bn_virtual_groups=4).train()
    whole = port_resnet.create_resnet("resnet18", num_filters=8, cifar_stem=True).train()
    whole.load_state_dict(grouped.state_dict())
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 12, 12, 3))
                         .astype(np.float32))
    with torch.no_grad():
        assert (grouped(x) - whole(x)).abs().max().item() > 1e-2


def test_momentum_bn_stats_matches_jax():
    """core/ema.py's momentum_bn_stats per tensor and per tree, and the
    in-place EMAN form over two encoders' BN statistics, within 1e-7."""
    from moco_tpu.core import ema as jax_ema

    rng = np.random.default_rng(6)
    tree = {"a": rng.standard_normal(4).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32)]}
    batch = jax.tree.map(lambda a: a + 1.0, tree)
    want = jax_ema.momentum_bn_stats(tree, batch, 0.9)
    got = ema.momentum_bn_stats(jax.tree.map(torch.from_numpy, tree),
                                jax.tree.map(torch.from_numpy, batch), 0.9)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-7),
                 got, want)
    enc_q = port_resnet.create_resnet("resnet18", num_filters=4, cifar_stem=True)
    enc_k = port_resnet.create_resnet("resnet18", num_filters=4, cifar_stem=True)
    for m in enc_q.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_()
            m.running_var.uniform_(0.5, 1.5)
    before = {n: b.clone() for n, b in enc_k.named_buffers()}
    ema.ema_running_stats(enc_k, enc_q, 0.75)
    q = dict(enc_q.named_buffers())
    for n, b in enc_k.named_buffers():
        if "running" in n:
            want = jax_ema.momentum_bn_stats(before[n].numpy(), q[n].numpy(), 0.75)
            np.testing.assert_allclose(b.numpy(), np.asarray(want), atol=1e-7, err_msg=n)
        else:
            assert torch.equal(b, before[n]), n
