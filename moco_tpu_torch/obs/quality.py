"""Model-quality observability: the served encoder's identity and the
compatibility scorer, the port's copy of moco_tpu/obs/quality.py.

- **identity**: `params_digest` (a content hash of an encoder's parameter
  tree) and `model_payload` give a replica its `serve/model_step` /
  `serve/model_digest` gauge pair. `encoder_digest` takes the hash of a
  port encoder over its parameters in the Flax layout
  (`convert.encoder_to_flax`: parameters only, no BN statistics), the tree
  a JAX replica digests, so a JAX replica and a port replica serving the
  same weights report the same digest.
- **compatibility**: `score_compat` embeds a probe set under a candidate
  and the live engine; `compat_cosine` is their mean probe-wise cosine and
  `recall_overlap` the mean top-k id overlap of the two embeddings' queries
  against the same live index; `compat_payload` gives them as the
  `serve/compat_cosine` / `serve/recall_overlap` gauges.
- **probes**: `synthetic_probes`, a seeded uint8 probe set.

The scorer runs on anything with `embed(images) -> (embeddings, executed)`
and an index with `query(feats, k, mode=...)` and `count`.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np


def _flat_leaves(tree, prefix=""):
    """Depth-first (path, array) leaves of a nested-dict tree, keys sorted,
    so the digest does not depend on insertion order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def params_digest(params, length: int = 12) -> str:
    """Content hash (hex, `length` characters) of a parameter tree: sha256
    over every leaf's path, shape, dtype and bytes. Byte-identical weights
    agree; any retrain, EMA tick or corruption disagrees."""
    h = hashlib.sha256()
    for path, leaf in _flat_leaves(params):
        h.update(path.encode())
        h.update(str(leaf.shape).encode())
        h.update(str(leaf.dtype).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return h.hexdigest()[:length]


def encoder_digest(encoder, length: int = 12) -> str:
    """`params_digest` of a port `MoCoEncoder` over its Flax-layout
    parameters (`convert.encoder_to_flax`; a ViT's head count read off its
    first block), the tree JAX's replica digests."""
    from moco_tpu_torch.convert import encoder_to_flax

    blocks = getattr(encoder.backbone, "blocks", None)
    num_heads = blocks[0].attn.num_heads if blocks is not None else None
    sd = {k: v.detach().cpu() for k, v in encoder.state_dict().items()}
    params, _ = encoder_to_flax(sd, num_heads=num_heads)
    return params_digest(params, length)


def model_payload(step: Optional[int], digest: Optional[str]) -> dict:
    """`serve/model_step` (the checkpoint step the encoder came from, null
    when unknown) and `serve/model_digest` (its parameters' hash)."""
    return {
        "serve/model_step": int(step) if step is not None else None,
        "serve/model_digest": str(digest) if digest is not None else None,
    }


def compat_cosine(live_emb, cand_emb) -> float:
    """Mean probe-wise cosine between the live and the candidate encoder's
    L2-normalized (n, d) embeddings of the same probes."""
    a = np.asarray(live_emb, np.float32)
    b = np.asarray(cand_emb, np.float32)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError(f"embedding shapes differ: {a.shape} vs {b.shape}")
    return float(np.mean(np.sum(a * b, axis=1)))


def recall_overlap(live_emb, cand_emb, index, k: int = 5, mode: str = "exact") -> float:
    """Mean top-k id overlap when the same probes query the same index
    under the live and the candidate encoder."""
    k = int(min(int(k), index.count))
    if k < 1:
        raise ValueError("recall_overlap needs a non-empty index")
    _, live_ids = index.query(np.asarray(live_emb, np.float32), k, mode=mode)
    _, cand_ids = index.query(np.asarray(cand_emb, np.float32), k, mode=mode)
    per_probe = [
        len(set(int(i) for i in l) & set(int(i) for i in c)) / k
        for l, c in zip(np.asarray(live_ids), np.asarray(cand_ids))
    ]
    return float(np.mean(per_probe))


def compat_payload(cosine: Optional[float], overlap: Optional[float]) -> dict:
    """`serve/compat_cosine` in [-1, 1] and `serve/recall_overlap` in
    [0, 1], null where not measured."""
    return {
        "serve/compat_cosine": float(cosine) if cosine is not None else None,
        "serve/recall_overlap": float(overlap) if overlap is not None else None,
    }


def score_compat(live_engine, cand_engine, probes, index=None, k: int = 5,
                 mode: str = "exact") -> dict:
    """Embed `probes` under both engines: {"cosine", "overlap" (null
    without a non-empty index), "n_probes", "k"}."""
    probes = np.asarray(probes)
    live_emb, _ = live_engine.embed(probes)
    cand_emb, _ = cand_engine.embed(probes)
    out = {"cosine": compat_cosine(live_emb, cand_emb), "overlap": None,
           "n_probes": int(probes.shape[0]), "k": int(k)}
    if index is not None and index.count > 0:
        out["overlap"] = recall_overlap(live_emb, cand_emb, index, k=k, mode=mode)
    return out


def synthetic_probes(n: int = 32, image_size: int = 32, seed: int = 0) -> np.ndarray:
    """Seeded (n, s, s, 3) uint8 probe images, the engine's wire format."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (int(n), int(image_size), int(image_size), 3)).astype(np.uint8)


__all__ = [
    "compat_cosine",
    "compat_payload",
    "encoder_digest",
    "model_payload",
    "params_digest",
    "recall_overlap",
    "score_compat",
    "synthetic_probes",
]
