"""Shuffle-BN on one device (the single-device part of
moco_tpu/parallel/shuffle.py).

Shuffle-BN normalizes the key batch in a permuted order, so that no BN
statistic mixes a query's own positive into its co-batch
(`moco/builder.py:~L79-126`). The JAX module does it across devices; on an
axis of size 1 its collectives are identities and each mode reduces to
in-batch permutations, which is what the port runs with
`bn_virtual_groups > 1` (per-group statistics over a permuted batch: a
G-GPU Shuffle-BN inside one device's batch):

- `gather_perm`: `shuffle_gather` is x[perm] and `unshuffle_gather` is
  k[inv_perm] (:62-90);
- `a2a`: `balanced_shuffle` is a local permutation, an all_to_all over one
  device (the identity) and a second local permutation, x[pre][post], and
  `balanced_unshuffle` inverts them (:93-120).

The permutations are drawn from a `torch.Generator` the caller passes,
seeded per step with `step_seed`; a caller may instead pass JAX's own
draws. The collectives wait for the
port's data-parallel slice.
"""

from __future__ import annotations

import numpy as np
import torch


def make_permutation(generator: torch.Generator, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(perm, inv_perm) of `batch` rows, drawn from `generator` on its device."""
    perm = torch.randperm(batch, generator=generator, device=generator.device)
    return perm, torch.argsort(perm)


def shuffle_gather(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """The rows `perm` of the batch: `shuffle_gather` over one device."""
    return x.index_select(0, perm)


def unshuffle_gather(k: torch.Tensor, inv_perm: torch.Tensor) -> torch.Tensor:
    """The keys back in the batch's order: `unshuffle_gather` over one
    device, where the local and the global keys are the same rows."""
    return k.index_select(0, inv_perm)


def local_perms(generator: torch.Generator, batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The (pre, post) local permutations of `balanced_shuffle`, drawn from
    `generator` in that order."""
    pre = torch.randperm(batch, generator=generator, device=generator.device)
    post = torch.randperm(batch, generator=generator, device=generator.device)
    return pre, post


def balanced_shuffle(x: torch.Tensor, pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """x[pre][post]: `balanced_shuffle` over one device."""
    return x.index_select(0, pre).index_select(0, post)


def balanced_unshuffle(y: torch.Tensor, pre: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """The exact inverse of `balanced_shuffle` with the same permutations."""
    return y.index_select(0, torch.argsort(post)).index_select(0, torch.argsort(pre))


def step_seed(seed: int, step: int) -> int:
    """A 64-bit seed for the permutations of `step` of a run seeded `seed`:
    a function of both alone, as JAX's fold_in(root_rng, step) is."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
