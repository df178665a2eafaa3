"""The kNN monitor (the counterpart of moco_tpu/knn.py): weighted kNN on
frozen backbone features, the cheap proxy for the linear probe.

    score(class c) = sum over the top k neighbours i of 1[y_i = c] * exp(sim_i / T)

The cosine top-k scan is the serving index's `topk_cosine`
(serve/index.py), as the JAX package shares its scan between kNN and
`/neighbors`. Features are extracted in eval mode (BN on its running
statistics) from the dataset's decode canvas (no crop), normalized with
the evaluation recipe's statistics and L2-normalized.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from moco_tpu_torch.data.augment import eval_stats, normalize
from moco_tpu_torch.obs.trace import span as obs_span
from moco_tpu_torch.ops.losses import l2_normalize
from moco_tpu_torch.serve.index import topk_cosine
from moco_tpu_torch.utils.device import resolve_device

LOAD_THREADS = 8  # host loads of a batch of examples without `load_batch`


def _load_batch(dataset, idx: np.ndarray, pool: ThreadPoolExecutor):
    if hasattr(dataset, "load_batch"):
        raw, labels = dataset.load_batch(idx)
        return np.asarray(raw), np.asarray(labels, np.int32)
    loads = list(pool.map(lambda i: dataset.load(int(i)), idx))
    return np.stack([im for im, _ in loads]), np.asarray([l for _, l in loads], np.int32)


@torch.no_grad()
def extract_features(backbone, dataset, batch_size: int = 256, image_size: Optional[int] = None,
                     device="cuda", compute_dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
    """(L2-normalized features (N, C) float32, labels (N,) int32) of the
    whole `dataset` through `backbone` in eval mode, in order; the
    backbone's train/eval mode is restored afterwards. `compute_dtype`
    "bfloat16" runs the forward under autocast, as the JAX backbone runs
    in its module's dtype. Loads run on LOAD_THREADS threads."""
    device = resolve_device(device)
    mean, std = eval_stats(image_size or 224)
    was_training = backbone.training
    backbone.eval()
    feats, labels = [], []
    try:
        with ThreadPoolExecutor(max_workers=LOAD_THREADS) as pool:
            for start in range(0, len(dataset), batch_size):
                idx = np.arange(start, min(start + batch_size, len(dataset)))
                raw, y = _load_batch(dataset, idx, pool)
                x = torch.from_numpy(raw).to(device).float() / 255.0
                with torch.autocast(device.type, dtype=torch.bfloat16,
                                    enabled=compute_dtype == "bfloat16"):
                    f = backbone(normalize(x, mean, std))
                feats.append(l2_normalize(f.float()).cpu().numpy())
                labels.append(y)
    finally:
        backbone.train(was_training)
    return np.concatenate(feats), np.concatenate(labels)


@torch.no_grad()
def knn_classify(train_feats: np.ndarray, train_labels: np.ndarray, test_feats: np.ndarray,
                 num_classes: int, k: int = 200, temperature: float = 0.07,
                 batch_size: int = 512, device="cuda") -> np.ndarray:
    """Predicted labels (M,) of `test_feats` (M, C) by temperature-weighted
    kNN against the L2-normalized bank `train_feats` (N, C)."""
    device = resolve_device(device)
    k = min(k, train_feats.shape[0])
    bank = torch.from_numpy(np.ascontiguousarray(train_feats, np.float32)).to(device)
    bank_labels = torch.from_numpy(np.asarray(train_labels, np.int64)).to(device)
    preds = []
    for start in range(0, test_feats.shape[0], batch_size):
        q = torch.from_numpy(np.ascontiguousarray(test_feats[start:start + batch_size],
                                                  np.float32)).to(device)
        top_sims, top_idx = topk_cosine(q, bank, k)  # (m, k)
        weights = torch.exp(top_sims / temperature)
        votes = torch.nn.functional.one_hot(bank_labels[top_idx], num_classes).float()
        scores = torch.einsum("mk,mkc->mc", weights, votes)
        preds.append(torch.argmax(scores, dim=-1).cpu().numpy())
    return np.concatenate(preds)


def knn_eval(backbone, train_dataset, test_dataset, num_classes: int, k: int = 200,
             temperature: float = 0.07, batch_size: int = 256, image_size: Optional[int] = None,
             device="cuda", compute_dtype: str = "float32") -> float:
    """kNN top-1 (%) of the frozen backbone's features: the bank from
    `train_dataset`, the queries from `test_dataset`."""
    with obs_span("knn_eval", bank=len(train_dataset), test=len(test_dataset)):
        with obs_span("knn_extract_bank"):
            train_f, train_y = extract_features(backbone, train_dataset, batch_size,
                                                image_size, device, compute_dtype)
        with obs_span("knn_extract_test"):
            test_f, test_y = extract_features(backbone, test_dataset, batch_size, image_size,
                                              device, compute_dtype)
        with obs_span("knn_classify"):
            preds = knn_classify(train_f, train_y, test_f, num_classes, k, temperature,
                                 device=device)
    return float(100.0 * np.mean(preds == test_y))
