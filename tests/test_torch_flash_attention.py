"""Parity of the port's flash attention (moco_tpu_torch/ops/flash_attention.py)
with the JAX package's on the CPU.

On CPU tensors the port's wrappers take their plain versions; JAX runs
its Pallas kernels in interpret mode (S >= 128) or its dense branch
(S < 128). Both get the same numpy inputs; JAX runs in float32, the
port's plain versions in float64, rounded once to float32.
Tolerances: 1e-5 absolute on O(1) outputs, lse and gradients (float32
sums over at most 256 keys, taken in another order by the two packages).
"""

import importlib
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu_torch.ops import build
from moco_tpu_torch.ops import flash_attention as flash

# moco_tpu.ops re-exports a function under the module's name
jax_flash = importlib.import_module("moco_tpu.ops.flash_attention")

TOL = 1e-5


def _inputs(seed, b, h, s, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))


def _t(x, grad=False):
    return torch.from_numpy(np.array(x, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("s", [145, 256, 65])
def test_forward_matches_jax(s):
    """S = 145 pads to two 128-row Pallas tiles and masks the tail; 256
    fills them; 65 < block_k takes JAX's dense branch, and the port the
    same function for any S."""
    q, k, v = _inputs(s, 2, 3, s, 64)
    want_out, want_lse = jax_flash.flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    out, lse = flash.flash_attention_with_lse(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(want_lse), atol=TOL, rtol=0)


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_attention_reference_is_exact_whatever_the_f32_matmul_precision(precision):
    """The plain forward (the CPU path of flash_forward, and the kernels'
    yardstick on the card) against a float64 oracle at the shape of
    test_forward_matches_jax[145], with the host's f32 matrix products set
    to each precision torch offers ("medium" takes them as bf16 pieces).
    Exact to 1e-6 in every setting; an f32 plain version is 2e-3 off under
    "medium"."""
    q, k, v = _inputs(145, 2, 3, 145, 64)
    scale = 64 ** -0.5
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * scale
    top = logits.max(-1, keepdims=True)
    want_lse = top[..., 0] + np.log(np.exp(logits - top).sum(-1))
    want_out = np.einsum("bhqk,bhkd->bhqd", np.exp(logits - want_lse[..., None]), v)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        out, lse = flash.attention_reference(_t(q), _t(k), _t(v), scale)
    finally:
        torch.set_float32_matmul_precision(before)
    assert np.abs(lse.numpy() - want_lse).max() <= 1e-6
    assert np.abs(out.numpy() - want_out).max() <= 1e-6


_FIRST_CALL = """
import importlib, json
import jax.numpy as jnp, numpy as np, torch
from moco_tpu_torch.ops import flash_attention as flash
jax_flash = importlib.import_module("moco_tpu.ops.flash_attention")
rng = np.random.default_rng(145)
q, k, v = (rng.standard_normal((2, 3, 145, 64)).astype(np.float32) for _ in range(3))
want_out, want_lse = jax_flash.flash_attention_with_lse(
    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
out, lse = flash.flash_attention_with_lse(*(torch.from_numpy(x) for x in (q, k, v)))
print(json.dumps({"out": float(np.abs(out.numpy() - np.asarray(want_out)).max()),
                  "lse": float(np.abs(lse.numpy() - np.asarray(want_lse)).max())}))
"""


def test_forward_matches_jax_on_the_first_call_of_fresh_processes():
    """test_forward_matches_jax[145] as the first call of 4 fresh
    processes, each after JAX's interpret kernel has run: the setting in
    which an f32 plain forward was seen to drift by 3.7-4.3e-5 in about 4%
    of processes on one host (ROADMAP.md queue 3; the cause is not
    confirmed, and the drift is rare, so a pass here is no proof)."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(root), *filter(None, [os.environ.get("PYTHONPATH")])])}
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_CALL], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, stderr[-2000:]
        err = json.loads(stdout.strip().splitlines()[-1])
        assert err["out"] <= TOL and err["lse"] <= TOL, err


@pytest.mark.parametrize("s,d", [(145, 64), (256, 32), (65, 64)])
def test_gradients_match_jax_through_out_and_lse(s, d):
    """jax.grad through the Pallas backward (interpret mode; the dense
    branch at S = 65) against the port's autograd function, with a
    cotangent on lse as ring attention gives it (g_lse != 0)."""
    q, k, v = _inputs(10 + s, 2, 2, s, d)
    rng = np.random.default_rng(s)
    w = rng.standard_normal((2, 2, s, d)).astype(np.float32)
    u = rng.standard_normal((2, 2, s)).astype(np.float32)

    def jloss(q, k, v):
        out, lse = jax_flash.flash_attention_with_lse(q, k, v, interpret=True)
        return jnp.sum(out * w) + jnp.sum(lse * u)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out, lse = flash.flash_attention_with_lse(tq, tk, tv)
    ((out * _t(w)).sum() + (lse * _t(u)).sum()).backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL, rtol=0)


def test_zero_lse_cotangent_is_plain_attention_gradient():
    """flash_attention (out only) gives autograd's gradient of the plain
    attention: the zero g_lse autograd hands in drops the lse term."""
    q, k, v = _inputs(3, 1, 2, 70, 32)
    w = _t(np.random.default_rng(4).standard_normal((1, 2, 70, 32)))
    a = [_t(x, True) for x in (q, k, v)]
    (flash.flash_attention(*a) * w).sum().backward()
    b = [_t(x, True) for x in (q, k, v)]
    (flash.attention_reference(*b, 32 ** -0.5)[0] * w).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), atol=TOL, rtol=0)


def test_backward_reference_matches_jax_jnp_backward():
    """flash_backward_reference against `_flash_backward_jnp` on the same
    (out, lse, g, g_lse)."""
    q, k, v = _inputs(7, 2, 2, 97, 64)
    rng = np.random.default_rng(8)
    g = rng.standard_normal(q.shape).astype(np.float32)
    g_lse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    scale = 64 ** -0.5
    out, lse = jax_flash._attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale)
    want = jax_flash._flash_backward_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse,
                                         jnp.asarray(g), jnp.asarray(g_lse), scale, 128)
    got = flash.flash_backward_reference(_t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), _t(g_lse),
                                         scale)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=TOL, rtol=0)


def test_wrappers_refuse_a_device_mix():
    x = torch.zeros(1, 1, 4, 32)
    with pytest.raises(ValueError, match="several devices"):
        flash.flash_forward(x, x.to("meta"), x, 1.0)


def test_kernel_table_names_the_sources_kernels():
    """Each (entry point, dtype) of `KERNELS` names a `__global__` kernel of
    csrc/flash_attention.cu, bf16 takes the tensor-core forward, dq and
    dk/dv and f32 the CUDA-core ones; CPU calls count no launch."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    for (entry, _), kernel in flash.KERNELS.items():
        assert f"int {entry}(" in src and re.search(rf"\n{kernel}\(", src), (entry, kernel)
    entries = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    assert [flash.KERNELS[(e, torch.bfloat16)] for e in entries] \
        == ["flash_fwd_mma_kernel", "flash_dq_mma_kernel", "flash_dkv_mma_kernel"]
    assert [flash.KERNELS[(e, torch.float32)] for e in entries] \
        == ["flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"]
    q, k, v = (_t(x) for x in _inputs(3, 1, 2, 9, 32))
    before = {w: (w.launches, dict(w.kernel_launches))
              for w in (flash.flash_forward, flash.flash_dq, flash.flash_dkv)}
    out, lse = flash.flash_forward(q, k, v, 0.5)
    coeff = flash.backward_coeff(out, q, torch.zeros_like(lse))
    flash.flash_dq(q, k, v, q, lse, coeff, 0.5)
    flash.flash_dkv(q, k, v, q, lse, coeff, 0.5)
    assert before == {w: (w.launches, w.kernel_launches) for w in before}


def test_launch_limit_counts_ctas_not_heads():
    """The kernels' grid is one-dimensional: B*H = 65536 (over the old
    second-dimension limit of 65535) passes the wrappers' shape check, and
    only B*H*ceil(S/64) > 2^31 - 1 CTAs is refused, with that limit named.
    `_check_cuda` only reads shapes, dtypes and strides, so CPU tensors (and
    a zero-stride view for the refused shape) exercise it without a launch."""
    q = torch.zeros(32768, 2, 1, 32)
    rows = torch.zeros(32768, 2, 1)
    assert flash._check_cuda("flash_dq", {"q": q, "k": q, "v": q, "g": q},
                             {"lse": rows, "coeff": rows}) == (32768, 2, 1, 32)
    huge = torch.zeros(()).expand(2**16, 2**15, 65, 32)  # 2^31 heads x 2 tiles of 64 rows
    with pytest.raises(ValueError, match=re.escape("B*H*ceil(S/64) <= 2147483647")):
        flash._check_cuda("flash_forward", {"q": huge, "k": huge, "v": huge}, {})
