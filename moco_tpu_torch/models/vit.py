"""Vision Transformer backbone for MoCo v3, the counterpart of
moco_tpu/models/vit.py: fixed 2-D sin-cos position embedding, pre-LN
blocks, tanh-GELU MLP, a stride-p patch embedding (frozen by the v3 step,
not by the module) and `cls` or `gap` pooling.

What Flax and torch do differently, matched here: LayerNorm eps is 1e-6
(Flax's default); `nn.gelu` is the tanh approximation; the patch
embedding is a VALID stride-p convolution on NHWC input, flattened
row-major over the patch grid; the cls token sits at position 0 with a
zero position embedding in its slot. `MultiHeadDotProductAttention`'s
q/k/v kernels (D, H, Dh) + bias (H, Dh) and `out` kernel (H, Dh, D)
become Linear layers `query`, `key`, `value` (D -> H*Dh) and `out`
(H*Dh -> D); `convert.vit_from_flax` maps the trees.

`use_flash_attention=True` runs attention through
`ops/flash_attention.py` (the CUDA kernels on the card, their plain
versions on the CPU); False is Flax's dense `dot_product_attention` in
plain torch. The parameters are the same either way. The layer groups of
the ZeRO-3 schedule (`group_names`, `group_param_names`, `forward_group`)
are JAX's.

Sequence parallelism (`sequence_parallel=True`, JAX's `sequence_axis`;
moco_tpu/models/vit.py:231-279): inside `sequence_parallel_ring(ring)` the
forward embeds the whole image, keeps this rank's S/n tokens (with their
position embedding), runs every block's attention as ring attention over
the ring's ranks (parallel/ring_attention.py, through the flash kernels
whatever `use_flash_attention` says, as JAX's), and pools with gap: the
local token sum, summed over the ring (`Ring.sum`), over S. Outside that
context (init, kNN, the probe, serving, export) the same module runs
dense, as JAX's does outside its shard_map. JAX's refusals hold, with its
messages: gap pooling only, tokens divisible by the ring, and no layer-
group apply.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from moco_tpu_torch.models.remat import remat_block
from moco_tpu_torch.ops.flash_attention import flash_attention
from moco_tpu_torch.parallel.ring_attention import ring_attention

LN_EPS = 1e-6  # Flax LayerNorm's default
_RING = contextvars.ContextVar("sequence_parallel_ring", default=None)


@contextlib.contextmanager
def sequence_parallel_ring(ring):
    """Run a sequence-parallel ViT's forwards over `ring`
    (parallel/ring_attention.py `Ring`) inside this context."""
    token = _RING.set(ring)
    try:
        yield
    finally:
        _RING.reset(token)


def sincos_2d_posembed(dim: int, grid: int, cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sin-cos position embedding, (1, grid²[+1], dim) f32 (a copy
    of moco_tpu/models/vit.py:74, which is plain numpy)."""
    if dim % 4:
        raise ValueError(f"sincos 2d posembed needs dim % 4 == 0, got {dim}")
    coords = np.arange(grid, dtype=np.float32)
    omega = 1.0 / (10000 ** (np.arange(dim // 4, dtype=np.float32) / (dim // 4)))
    out_h = np.einsum("i,j->ij", coords, omega)  # (grid, dim/4)
    emb_h = np.concatenate([np.sin(out_h), np.cos(out_h)], axis=1)  # (grid, dim/2)
    emb = np.concatenate(
        [
            np.repeat(emb_h[:, None, :], grid, axis=1),  # y
            np.repeat(emb_h[None, :, :], grid, axis=0),  # x
        ],
        axis=-1,
    ).reshape(grid * grid, dim)
    if cls_token:
        emb = np.concatenate([np.zeros((1, dim), np.float32), emb], axis=0)
    return emb[None]


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class MultiHeadAttention(nn.Module):
    """Self-attention as `nn.MultiHeadDotProductAttention` computes it
    (no mask, no dropout), on (B, S, D) tokens."""

    def __init__(self, dim: int, num_heads: int, use_flash_attention: bool = False):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} is not divisible by {num_heads} heads")
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.use_flash_attention = use_flash_attention
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)

    def forward(self, x, ring=None):
        """`ring`: this rank's tokens, the sequence sharded over the ring
        (ring attention)."""
        b, s, _ = x.shape
        q, k, v = (proj(x).view(b, s, self.num_heads, self.head_dim)
                   for proj in (self.query, self.key, self.value))
        if ring is not None:
            heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            y = ring_attention(*heads, ring).transpose(1, 2)
        elif self.use_flash_attention:
            # the kernels' layout, (B, H, S, Dh), as flash_attention_fn (vit.py:40)
            heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
            y = flash_attention(*heads).transpose(1, 2)
        else:
            # Flax's dot_product_attention: the query scaled first, the
            # softmax over keys in f32, the weights back in v's dtype
            w = torch.einsum("bqhd,bkhd->bhqk", q / self.head_dim ** 0.5, k)
            w = torch.softmax(w.float(), dim=-1).to(v.dtype)
            y = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.out(y.reshape(b, s, -1))


class EncoderBlock(nn.Module):
    """Pre-LN block: x + attn(LN(x)), then x + mlp(LN(x))."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int, use_flash_attention: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiHeadAttention(dim, num_heads, use_flash_attention)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MlpBlock(dim, mlp_dim)

    def forward(self, x, ring=None):
        x = x + self.attn(self.norm1(x), ring)
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """ViT returning the final-LN pooled feature, (n, hidden_dim) float32
    from (n, H, W, 3) NHWC images: the token at position 0 (`pool="cls"`)
    or the mean over all tokens (`"gap"`)."""

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, image_size: int = 224,
                 use_flash_attention: bool = False, pool: str = "cls",
                 sequence_parallel: bool = False):
        super().__init__()
        if pool not in ("cls", "gap"):
            raise ValueError(f"pool={pool!r}: choose 'cls' or 'gap'")
        self.patch_size, self.hidden_dim, self.pool = patch_size, hidden_dim, pool
        self.sequence_parallel = sequence_parallel
        self.patch_embed = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        if pool == "cls":
            self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.blocks = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, mlp_dim, use_flash_attention)
            for _ in range(depth))
        self.final_norm = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        # the fixed position embedding for image_size, not a parameter
        self.register_buffer("pos_embed", self._sincos(image_size // patch_size),
                             persistent=False)

    def _sincos(self, grid: int) -> torch.Tensor:
        return torch.from_numpy(sincos_2d_posembed(self.hidden_dim, grid, self.pool == "cls"))

    @property
    def num_features(self) -> int:
        return self.hidden_dim

    def _embed(self, x):
        b, h, w, _ = x.shape
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image {h}x{w} not divisible by patch {self.patch_size}")
        grid = h // self.patch_size
        # NHWC -> NCHW view; the stride-p conv is Flax's VALID patch embedding
        x = self.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        if self.pool == "cls":
            x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        if self.pos_embed.shape[1] != x.shape[1]:  # another image size than built for
            self.pos_embed = self._sincos(grid).to(x.device)
        return x + self.pos_embed.to(x.dtype)

    def _final(self, x, ring=None, seq_total: int = 0):
        x = self.final_norm(x)
        if self.pool == "cls":
            return x[:, 0].float()
        if ring is None:
            return x.float().mean(dim=1)
        return ring.sum(x.float().sum(dim=1)) / seq_total

    def forward(self, x, remat: bool = False):
        """`remat` recomputes each encoder block in the backward
        (models/remat.py). Sequence parallel inside
        `sequence_parallel_ring` (module docstring)."""
        x = self._embed(x)
        ring = _RING.get() if self.sequence_parallel else None
        seq_total = x.shape[1]
        if ring is not None:
            if self.pool != "gap":
                raise ValueError("sequence_axis requires pool='gap' (cls token cannot be sharded)")
            if seq_total % ring.size:
                raise ValueError(
                    f"{seq_total} tokens not divisible by sequence axis size {ring.size}")
            local = seq_total // ring.size
            x = x[:, ring.rank * local:(ring.rank + 1) * local]
        for block in self.blocks:
            x = remat_block(block, x, ring) if remat else block(x, ring)
        return self._final(x, ring, seq_total)

    # -- the layer groups of the ZeRO-3 schedule (parallel/zero.py) ----------

    @property
    def group_names(self) -> tuple:
        """Schedule-ordered layer groups: the patch embedding (and cls
        token), one group per encoder block, the final norm and pool."""
        return ("embed",) + tuple(f"block_{i}" for i in range(len(self.blocks))) + ("final",)

    def group_param_names(self) -> dict:
        """group -> the Flax param-tree children it holds (JAX's)."""
        names = {"embed": ("patch_embed", "cls_token") if self.pool == "cls" else ("patch_embed",),
                 "final": ("final_norm",)}
        for i in range(len(self.blocks)):
            names[f"block_{i}"] = (f"block_{i}",)
        return names

    def _block_index(self, group: str) -> int:
        if group.startswith("block_") and group[6:].isdigit() and int(group[6:]) < len(self.blocks):
            return int(group[6:])
        raise ValueError(f"unknown layer group {group!r}")

    def group_modules(self, group: str) -> list:
        if group == "embed":
            return [self.patch_embed]
        if group == "final":
            return [self.final_norm]
        return [self.blocks[self._block_index(group)]]

    def forward_group(self, group: str, x):
        """One layer group on the previous group's output (the images for
        the embedding); refused for a sequence-parallel ViT, as JAX's."""
        if self.sequence_parallel:
            raise ValueError(
                "layer-group apply does not compose with sequence_axis "
                "(the token shard would cross group boundaries)"
            )
        if group == "embed":
            return self._embed(x)
        if group == "final":
            return self._final(x)
        return self.blocks[self._block_index(group)](x)


_VIT_CONFIGS = {
    "vit_tiny": dict(hidden_dim=192, depth=4, num_heads=3, mlp_dim=768),  # tests
    "vit_s16": dict(hidden_dim=384, depth=12, num_heads=6, mlp_dim=1536),
    "vit_b16": dict(hidden_dim=768, depth=12, num_heads=12, mlp_dim=3072),
    "vit_l16": dict(hidden_dim=1024, depth=24, num_heads=16, mlp_dim=4096),
}


def create_vit(arch: str, image_size: int = 224, **kwargs) -> VisionTransformer:
    if arch not in _VIT_CONFIGS:
        raise ValueError(f"unknown ViT arch {arch!r}; choose from {sorted(_VIT_CONFIGS)}")
    return VisionTransformer(image_size=image_size, **_VIT_CONFIGS[arch], **kwargs)
