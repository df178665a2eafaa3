"""Int8 products for the serving tiers: `torch._int_mm` (cuBLASLt int8 x
int8 -> int32 on the card) behind the padding cuBLASLt asks for, and the
im2col that turns a convolution into one such product. No kernel of this
repository's own: XLA's int8 `dot_general` / `conv_general_dilated` in the
JAX package are library operations too."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ceil8(n: int) -> int:
    return -(-int(n) // 8) * 8


def pad_int8_weight(w: torch.Tensor) -> torch.Tensor:
    """An (N, K) int8 weight zero-padded to N and K multiples of 8, the
    form `int8_matmul` takes."""
    n, k = w.shape
    return F.pad(w, (0, _ceil8(k) - k, 0, _ceil8(n) - n)).contiguous()


def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K')^T int8 -> (M, N) int32 through `torch._int_mm`
    (cuBLASLt int8 -> int32 on the card), `w` already padded by
    `pad_int8_weight` (K' >= K, N and K' multiples of 8). The rows are
    padded past 16 and the columns to K' with zeros, which add nothing to
    the sums; the padding is sliced away. The same padding runs on the CPU,
    where the tests hold it."""
    m, k = a.shape
    if k != w.shape[1]:
        a = F.pad(a, (0, w.shape[1] - k))
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), w.t())[:m]


def im2col(x: torch.Tensor, kernel_size, stride, padding, dilation):
    """(N, H, W, C) -> ((N * Ho * Wo, kh * kw * C), (N, Ho, Wo)): the patch
    rows of a convolution with the module's own geometry, columns in
    (kh, kw, C) order. Any dtype; a 1x1 convolution at stride 1 without
    padding is a view."""
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    if ph or pw:
        x = F.pad(x, (0, 0, pw, pw, ph, ph))
    x = x.contiguous()
    n, h, w, c = x.shape
    ho = (h - dh * (kh - 1) - 1) // sh + 1
    wo = (w - dw * (kw - 1) - 1) // sw + 1
    s_n, s_h, s_w, s_c = x.stride()
    cols = x.as_strided((n, ho, wo, kh, kw, c), (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c))
    return cols.reshape(n * ho * wo, kh * kw * c), (n, ho, wo)


__all__ = ["im2col", "int8_matmul", "pad_int8_weight"]
