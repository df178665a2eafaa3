"""Flash attention with its backward, on the JAX layout (B, H, S, D).

The port of moco_tpu/ops/flash_attention.py. Its three TPU kernels,
`_flash_kernel` (:73), `_dq_kernel` (:177) and `_dkv_kernel` (:225), are
the hand-written CUDA kernels of `csrc/flash_attention.cu` (its source note
gives the bound and the tiled design). `flash_forward`, `flash_dq` and
`flash_dkv` launch them for CUDA tensors and take the plain versions
(`attention_reference`, `flash_dq_reference`, `flash_dkv_reference`) only
for CPU tensors; there is no fallback from one to the other. bf16 inputs
go through the tensor-core forward, dq and dk/dv kernels, f32 inputs
through the CUDA-core ones (`KERNELS`). The kernels' grid is
one-dimensional, so any B*H runs as long as B*H*ceil(S/64) CTAs fit it.
`FlashAttention` is the `custom_vjp` (:382-427) as an autograd function:
it saves (q, k, v, out, lse) and takes both cotangents, g and g_lse.

The kernels mask the tail of any S, so the port has no counterpart of
JAX's dense branch for S < block_k (:140, :416), which exists only for
the Pallas tile.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from moco_tpu_torch.ops import build

HEAD_DIMS = (32, 64, 128)  # the widths the kernels are built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # rows of a CTA's tile: a call launches B*H*ceil(S/64) CTAs
_MAX_CTAS = 2**31 - 1  # the CTA count the grid's one dimension holds
# The CUDA kernel each (C entry point, dtype) launches.
KERNELS = {
    ("flash_attention_fwd", torch.float32): "flash_fwd_kernel",
    ("flash_attention_fwd", torch.bfloat16): "flash_fwd_mma_kernel",
    ("flash_attention_dq", torch.float32): "flash_dq_kernel",
    ("flash_attention_dq", torch.bfloat16): "flash_dq_mma_kernel",
    ("flash_attention_dkv", torch.float32): "flash_dkv_kernel",
    ("flash_attention_dkv", torch.bfloat16): "flash_dkv_mma_kernel",
}


def _einsum_f64(eq: str, *xs):
    return torch.einsum(eq, *(x.double() for x in xs))


# The plain versions compute in float64 and round once at the end, so they
# are exact in f32 whatever precision the host's f32 matrix products run
# at (an f32 product taken as bf16 pieces moves lse by ~1e-5 at S = 145).
# For bf16 inputs the logits, p and dS are not rounded to bf16 in between:
# the TPU `_flash_kernel` keeps its logits in f32, as the CUDA kernels do,
# where `_attn_reference` (:51-53) rounds them through a bf16 einsum.


def attention_reference(q, k, v, scale: float):
    """Plain version of the forward, `_attn_reference` (:51) in float64:
    (out in q's dtype, lse in f32)."""
    logits = _einsum_f64("bhqd,bhkd->bhqk", q, k) * scale
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    out = _einsum_f64("bhqk,bhkd->bhqd", probs, v)
    return out.to(q.dtype), lse.float()


def _probs_and_ds(q, k, v, g, lse, coeff, scale: float):
    """p = exp(q.k^T scale - lse) and ds = p (g.v^T + coeff), in float64."""
    p = torch.exp(_einsum_f64("bhqd,bhkd->bhqk", q, k) * scale - lse.double()[..., None])
    return p, p * (_einsum_f64("bhqd,bhkd->bhqk", g, v) + coeff.double()[..., None])


def flash_dq_reference(q, k, v, g, lse, coeff, scale: float):
    """Plain dq = scale * ds.k, `_flash_backward_jnp` (:337) in float64;
    coeff = g_lse - sum(g * out)."""
    _, ds = _probs_and_ds(q, k, v, g, lse, coeff, scale)
    return (_einsum_f64("bhqk,bhkd->bhqd", ds, k) * scale).to(q.dtype)


def flash_dkv_reference(q, k, v, g, lse, coeff, scale: float):
    """Plain (dk, dv): dk = scale * ds^T.q and dv = p^T.g, in float64."""
    p, ds = _probs_and_ds(q, k, v, g, lse, coeff, scale)
    dv = _einsum_f64("bhqk,bhqd->bhkd", p, g)
    dk = _einsum_f64("bhqk,bhqd->bhkd", ds, q) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def backward_coeff(out, g, g_lse):
    """coeff = g_lse - delta with delta = sum(g * out) over D, (B, H, S) f32:
    the per-row term both backward kernels take (delta is computed outside
    the TPU kernels too, :278)."""
    return (g_lse.float() - (g.float() * out.float()).sum(-1)).contiguous()


def flash_backward_reference(q, k, v, out, lse, g, g_lse, scale: float):
    """`_flash_backward_jnp` (:337) with the lse cotangent, in one shot:
    (dq, dk, dv) in the inputs' dtypes."""
    coeff = backward_coeff(out, g, g_lse)
    return (flash_dq_reference(q, k, v, g, lse, coeff, scale),
            *flash_dkv_reference(q, k, v, g, lse, coeff, scale))


def abs_term_sums(q, k, v, g, lse, coeff, scale: float) -> dict:
    """The largest sum of absolute terms behind each output:
    out = sum_k p v / l, dq = scale sum_k ds k, dk = scale sum_q ds q,
    dv = sum_q p g. Rounding p or ds and the output to bf16 (2^-8 relative
    each: bf16 keeps 8 significant bits, as the kernels do) moves an output
    by at most 2^-7 of this sum, which therefore scales the bf16 tolerance
    of a kernel against its plain version on the same bf16 inputs."""
    p, ds = _probs_and_ds(q, k, v, g, lse, coeff, scale)
    p, ds = p.abs(), ds.abs()
    return {
        "out": _einsum_f64("bhqk,bhkd->bhqd", p, v.abs()).max().item(),
        "dq": scale * _einsum_f64("bhqk,bhkd->bhqd", ds, k.abs()).max().item(),
        "dk": scale * _einsum_f64("bhqk,bhqd->bhkd", ds, q.abs()).max().item(),
        "dv": _einsum_f64("bhqk,bhqd->bhkd", p, g.abs()).max().item(),
    }


def _on_cpu(name: str, tensors: dict) -> bool:
    """True for CPU tensors (the plain version runs); raises for a mix."""
    devices = {t.device for t in tensors.values()}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors on several devices: {sorted(map(str, devices))}")
    return next(iter(devices)).type == "cpu"


def _check_cuda(name: str, blocks: dict, rows: dict) -> tuple[int, int, int, int]:
    """(B, H, S, D) after checking what the kernels take: (B, H, S, D)
    `blocks` of one dtype (f32 or bf16) with D in HEAD_DIMS, (B, H, S) f32
    `rows`, all contiguous and 16-byte aligned."""
    q = next(iter(blocks.values()))
    if q.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, S, D) inputs, got shape {tuple(q.shape)}")
    b, h, s, d = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: the kernels take float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take D in {HEAD_DIMS}, got D={d}")
    if not (b * h > 0 and s > 0 and b * h * -(-s // _TILE) <= _MAX_CTAS):
        raise ValueError(f"{name}: needs B*H > 0, S > 0 and B*H*ceil(S/{_TILE}) <= {_MAX_CTAS}"
                         f" (the CTAs of one launch), got {tuple(q.shape)}")
    for tname, t in {**blocks, **rows}.items():
        shape, dtype = ((b, h, s, d), q.dtype) if tname in blocks else ((b, h, s), torch.float32)
        if t.dtype != dtype:
            raise ValueError(f"{name}: {tname} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tname} must be contiguous and 16-byte aligned")
    return b, h, s, d


def _launch(wrapper, fn_name: str, dtype: torch.dtype, pointers: list, ints: list,
            scale: float) -> None:
    """Calls the C entry point `fn_name`, raises on a launch error, and
    counts the launch on `wrapper`: `launches` in all and
    `kernel_launches` by the CUDA kernel that ran."""
    fn = getattr(build.load("flash_attention"), fn_name)
    fn.argtypes = ([ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*pointers, *ints, scale, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: cudaError_t {err}")
    wrapper.launches += 1
    wrapper.kernel_launches[KERNELS[(fn_name, dtype)]] += 1


def _counters(wrapper, fn_name: str) -> None:
    wrapper.launches = 0
    wrapper.kernel_launches = {name: 0 for (f, _), name in KERNELS.items() if f == fn_name}


def flash_forward(q, k, v, scale: float):
    """(out, lse): out = softmax(q.k^T scale) v in q's dtype, (B, H, S, D),
    and lse = logsumexp(q.k^T scale) in f32, (B, H, S).

    CUDA tensors go through the kernel of their dtype (each launch adds
    one to `flash_forward.launches` and to its kernel's entry of
    `flash_forward.kernel_launches`); CPU tensors through the plain version."""
    blocks = {"q": q, "k": k, "v": v}
    if _on_cpu("flash_forward", blocks):
        return attention_reference(q, k, v, scale)
    b, h, s, d = _check_cuda("flash_forward", blocks, {})
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(flash_forward, "flash_attention_fwd", q.dtype,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()],
                [b * h, s, d, _DTYPE_CODES[q.dtype]], scale)
    return out, lse


_counters(flash_forward, "flash_attention_fwd")


def flash_dq(q, k, v, g, lse, coeff, scale: float):
    """dq = scale * sum_k p (g.v^T + coeff) k in q's dtype, (B, H, S, D).

    CUDA tensors go through the kernel of their dtype (each launch adds
    one to `flash_dq.launches` and to its kernel's entry of
    `flash_dq.kernel_launches`); CPU tensors through the plain version."""
    blocks, rows = {"q": q, "k": k, "v": v, "g": g}, {"lse": lse, "coeff": coeff}
    if _on_cpu("flash_dq", {**blocks, **rows}):
        return flash_dq_reference(q, k, v, g, lse, coeff, scale)
    b, h, s, d = _check_cuda("flash_dq", blocks, rows)
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _launch(flash_dq, "flash_attention_dq", q.dtype,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 coeff.data_ptr(), dq.data_ptr()],
                [b * h, s, d, _DTYPE_CODES[q.dtype]], scale)
    return dq


_counters(flash_dq, "flash_attention_dq")


def flash_dkv(q, k, v, g, lse, coeff, scale: float):
    """(dk, dv) in the inputs' dtype: dk = scale * ds^T.q, dv = p^T.g.

    CUDA tensors go through the kernel of their dtype (each launch adds
    one to `flash_dkv.launches` and to its kernel's entry of
    `flash_dkv.kernel_launches`); CPU tensors through the plain version."""
    blocks, rows = {"q": q, "k": k, "v": v, "g": g}, {"lse": lse, "coeff": coeff}
    if _on_cpu("flash_dkv", {**blocks, **rows}):
        return flash_dkv_reference(q, k, v, g, lse, coeff, scale)
    b, h, s, d = _check_cuda("flash_dkv", blocks, rows)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _launch(flash_dkv, "flash_attention_dkv", q.dtype,
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
                 coeff.data_ptr(), dk.data_ptr(), dv.data_ptr()],
                [b * h, s, d, _DTYPE_CODES[q.dtype]], scale)
    return dk, dv


_counters(flash_dkv, "flash_attention_dkv")


class FlashAttention(torch.autograd.Function):
    """(out, lse) with gradients for q, k and v through both cotangents:
    g for out and g_lse for lse (autograd hands in zeros for an output the
    caller does not use, so a zero g_lse gives plain attention's gradient)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        out, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.to(q.dtype).contiguous()
        coeff = backward_coeff(out, g, g_lse)
        dq = flash_dq(q, k, v, g, lse, coeff, ctx.scale)
        dk, dv = flash_dkv(q, k, v, g, lse, coeff, ctx.scale)
        return dq, dk, dv, None


def flash_attention_with_lse(q, k, v, scale: Optional[float] = None):
    """(out, lse) for non-causal attention over (B, H, S, D) inputs,
    differentiable in both outputs; scale defaults to D ** -0.5."""
    return FlashAttention.apply(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention(q, k, v, scale: Optional[float] = None):
    """Attention output only; differentiable."""
    return flash_attention_with_lse(q, k, v, scale)[0]
