"""Shuffle-BN (moco_tpu/parallel/shuffle.py): on one device, and across
the ranks of a data-parallel world.

Shuffle-BN normalizes the key batch in a permuted order, so that no BN
statistic mixes a query's own positive into its co-batch
(`moco/builder.py:~L79-126`).

On one device the JAX module's collectives are identities and each mode
reduces to in-batch permutations, which is what the port runs with
`bn_virtual_groups > 1` (per-group statistics over a permuted batch: a
G-GPU Shuffle-BN inside one device's batch):

- `gather_perm`: `shuffle_gather` is x[perm] and `unshuffle_gather` is
  k[inv_perm] (:62-90);
- `a2a`: `balanced_shuffle` is a local permutation, an all_to_all over one
  device (the identity) and a second local permutation, x[pre][post], and
  `balanced_unshuffle` inverts them (:93-120).

Across a world (parallel/mesh.py), the `dp_*` functions run JAX's
collectives over the data group, each under its comms-ledger site:

- `dp_shuffle_gather`: an all_gather of the images
  (`shuffle.gather_images`), then this rank's slice of the global `perm`;
  `dp_unshuffle_gather`: an all_gather of the keys (`shuffle.gather_keys`)
  put back in the batch's order, returning (k_local, k_global): the global
  keys feed the enqueue, which saves the reference's third gather;
- `dp_balanced_shuffle`: a local permutation, the tiled all_to_all
  (`shuffle.a2a`), a local permutation; `dp_balanced_unshuffle` inverts it
  (`shuffle.a2a_unshuffle`).

The permutations are drawn from a `torch.Generator` the caller passes,
seeded per step with `step_seed`: gather_perm's global one from (seed,
step) on every rank alike, a2a's local ones from (seed, step, data rank),
as JAX folds the data index in (the model ranks of one data rank draw
alike). A caller may instead pass JAX's own draws.
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


def step_seed(seed: int, step: int, rank: int = 0) -> int:
    """A 64-bit seed for the permutations of `step` of a run seeded `seed`
    (and of `rank`'s local ones under a2a): a function of these alone, as
    JAX's fold_in(root_rng, step) is. Rank 0's is the one-device seed."""
    entropy = [seed, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


# -- across a world ----------------------------------------------------------


def dp_shuffle_gather(world, x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """This rank's rows perm[r*b:(r+1)*b] of the global batch (b local
    rows, `perm` the global permutation)."""
    b = x.shape[0]
    x_all = world.all_gather_rows(x, "shuffle.gather_images")
    return x_all.index_select(0, perm[world.data_rank * b:(world.data_rank + 1) * b])


def dp_unshuffle_gather(world, k: torch.Tensor,
                        inv_perm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(k_local, k_global): this rank's keys and the global keys, both in
    the batch's order, from one all_gather of the permuted keys."""
    b = k.shape[0]
    k_all = world.all_gather_rows(k, "shuffle.gather_keys")  # rows in perm order
    k_global = k_all.index_select(0, inv_perm)
    return k_global[world.data_rank * b:(world.data_rank + 1) * b], k_global


def dp_balanced_shuffle(world, x: torch.Tensor, pre: torch.Tensor,
                        post: torch.Tensor) -> torch.Tensor:
    """Local permutation `pre`, the tiled all_to_all, local permutation
    `post`: each rank ends with a random b/n-slice of every rank's rows."""
    x = world.all_to_all_rows(x.index_select(0, pre), "shuffle.a2a")
    return x.index_select(0, post)


def dp_balanced_unshuffle(world, y: torch.Tensor, pre: torch.Tensor,
                          post: torch.Tensor) -> torch.Tensor:
    """The exact inverse of `dp_balanced_shuffle` with the same
    permutations (the tiled exchange is its own inverse)."""
    y = world.all_to_all_rows(y.index_select(0, torch.argsort(post)), "shuffle.a2a_unshuffle")
    return y.index_select(0, torch.argsort(pre))
