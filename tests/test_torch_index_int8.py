"""The port's int8 index tiers and ingest stamps
(moco_tpu_torch/serve/index.py) held against moco_tpu/serve/index.py on
the CPU.

Rows are tie-free clustered unit vectors made with numpy from a seed. Both
packages accumulate the same int8 products exactly (int32 in JAX, the
port's int32 `_int_mm` for exact_i8 and exact f32 sums for the IVF twins)
and rescale in the same order, so ids are equal and scores within 1e-6.
The int8 mirror is held bit for bit against JAX's after snapshots, FIFO
writes and a write that wraps the store."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.serve import index as jax_index
from moco_tpu_torch.ops.int8 import int8_matmul, pad_int8_weight
from moco_tpu_torch.serve import index as port_index
from moco_tpu_torch.serve.index import EmbeddingIndex, IndexRecompileError

I8_MODES = ("exact_i8", "ivf_i8", "ivf_fused_i8")
SCORE_ATOL = 1e-6


def clustered(nc=8, per=32, dim=16, noise=0.2, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(nc, dim))
    rows = np.repeat(centers, per, axis=0) + noise * rng.normal(size=(nc * per, dim))
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows[rng.permutation(rows.shape[0])].astype(np.float32)


def queries(rows, m, seed=1, noise=0.05):
    rng = np.random.default_rng(seed)
    q = rows[rng.integers(0, rows.shape[0], m)] + noise * rng.normal(size=(m, rows.shape[1]))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def assert_same_topk(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), atol=SCORE_ATOL, rtol=0)


def assert_same_mirror(pi, ji):
    """The port's int8 mirror (padded to multiples of 8) against JAX's."""
    cap, dim = pi.capacity, pi.dim
    np.testing.assert_array_equal(pi._rows_i8[:cap, :dim].numpy(), np.asarray(ji._rows_i8))
    assert not pi._rows_i8[cap:].any() and not pi._rows_i8[:, dim:].any()
    np.testing.assert_array_equal(pi._row_scale.numpy(), np.asarray(ji._row_scale))


def both(rows, capacity=None, dim=None, nlist=8, nprobe=4):
    capacity = rows.shape[0] if capacity is None else capacity
    dim = rows.shape[1] if dim is None else dim
    ji = jax_index.EmbeddingIndex(capacity, dim)
    pi = EmbeddingIndex(capacity, dim, device="cpu")
    for idx in (ji, pi):
        idx.snapshot(rows)
        idx.train_ivf(nlist=nlist, nprobe=nprobe)
        idx.enable_int8()
    return ji, pi


@pytest.fixture(scope="module")
def indexes():
    rows = clustered(nc=8, per=32, dim=16)
    return (rows, *both(rows))


def test_quantize_rows_matches_jax():
    rows = clustered(nc=4, per=8, dim=20)
    rows[3] = 0.0  # a zero row: scale 1, values 0
    want_q, want_s = jax_index._quantize_rows_int8(jnp.asarray(rows))
    got_q, got_s = port_index._quantize_rows_int8(torch.from_numpy(rows))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[3] == 1.0 and not got_q[3].any()


@pytest.mark.parametrize("mode", I8_MODES)
@pytest.mark.parametrize("valid", [None, 150])
def test_int8_tiers_match_jax(indexes, mode, valid):
    """Each int8 tier against JAX's on the same rows, IVF and queries: ids
    equal, scores within 1e-6; a partial fill masks the same rows."""
    rows, ji, pi = indexes
    for idx in (ji, pi):
        idx.count = rows.shape[0] if valid is None else valid
    q = queries(rows, 8, seed=5)
    got = pi.query(q, 5, mode=mode)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert_same_topk(got, ji.query(q, 5, mode=mode))
    assert_same_mirror(pi, ji)


def test_int8_scores_within_the_rescale_bound(indexes):
    """JAX's rescale bound (tests/test_serve_ivf.py:142): every int8 score
    within 0.02 of the f32 exact score, and the IVF twins lose nothing
    extra in int8 against exact_i8."""
    rows, _, pi = indexes
    pi.count = rows.shape[0]
    q = queries(rows, 12)
    se, _ = pi.query(q, 10)
    s8, i8e = pi.query(q, 10, mode="exact_i8")
    assert np.abs(s8 - se).max() < 0.02
    for mode in ("ivf_i8", "ivf_fused_i8"):
        _, iv = pi.query(q, 10, mode=mode)
        recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(iv, i8e)])
        assert recall >= 0.95, mode


@pytest.mark.parametrize("mode", I8_MODES)
def test_int8_mirror_follows_fifo_ingest_and_wrap(mode):
    """The mirror follows FIFO writes, one of them crossing the end of the
    store (tests/test_serve_ivf.py:161, :517, :571): mirror, cells and
    answers equal JAX's, and the freshly written rows are their own top-1
    at the write head."""
    rows = clustered(nc=8, per=16, dim=8)
    ji, pi = both(rows)
    fresh = queries(rows, 24, seed=9, noise=0.3)
    for idx in (ji, pi):
        idx.add(fresh[:16])
        idx._ptr = rows.shape[0] - 4  # the next block splits at the end
        idx.add(fresh[16:])
    assert_same_mirror(pi, ji)
    for key in ("cells", "counts", "row_cell", "row_slot"):
        np.testing.assert_array_equal(pi._ivf[key], ji._ivf[key], err_msg=key)
    q = queries(rows, 8, seed=10)
    assert_same_topk(pi.query(q, 5, mode=mode), ji.query(q, 5, mode=mode))
    # slots 0-15 took fresh[:16]; the wrapping block put fresh[16:20] at the
    # last four slots and fresh[20:24] over slots 0-3
    k = rows.shape[0]
    for block, slots in ((fresh[4:8], np.arange(4, 8)), (fresh[16:20], np.arange(k - 4, k)),
                         (fresh[20:24], np.arange(4))):
        s, i = pi.query(block, 1, mode=mode)
        np.testing.assert_array_equal(i[:, 0], slots)
        assert (s[:, 0] > 0.99).all()


def test_snapshot_requantizes_the_mirror():
    rows = clustered(nc=4, per=16, dim=8)
    ji, pi = both(rows)
    other = clustered(nc=4, per=16, dim=8, seed=3)[:40]
    for idx in (ji, pi):
        idx.snapshot(other)
    assert_same_mirror(pi, ji)
    assert pi.int8_enabled and pi._ivf is None


@pytest.mark.parametrize("capacity, dim", [(61, 12), (64, 16), (9, 3)])
def test_exact_i8_pads_to_what_int_mm_takes(capacity, dim):
    """Store sizes off the multiples of 8 that cuBLASLt needs: the padded
    mirror answers exact_i8 as JAX does."""
    rows = clustered(nc=1, per=capacity, dim=dim, seed=capacity)
    ji = jax_index.EmbeddingIndex(capacity, dim)
    pi = EmbeddingIndex(capacity, dim, device="cpu")
    for idx in (ji, pi):
        idx.snapshot(rows)
        idx.enable_int8()
    assert pi._rows_i8.shape[0] % 8 == 0 and pi._rows_i8.shape[1] % 8 == 0
    q = queries(rows, 3)
    k = min(5, capacity)
    assert_same_topk(pi.query(q, k, mode="exact_i8"), ji.query(q, k, mode="exact_i8"))


@pytest.mark.parametrize("m, k, n", [(1, 8, 8), (16, 27, 5), (17, 147, 64), (40, 128, 3)])
def test_int8_matmul_padding_is_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    got = int8_matmul(a, pad_int8_weight(w))[:, :n]
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, a.int() @ w.int().T)


def test_i8_f32_exact_dim_bound():
    """The widest d whose int8 candidate sums stay exact in f32."""
    d = port_index.I8_F32_EXACT_DIM
    assert d * 127**2 < 2**24 <= (d + 1) * 127**2


def test_int8_modes_refuse_without_the_mirror_and_unprepared_shapes():
    rows = clustered(nc=4, per=16, dim=8)
    idx = EmbeddingIndex(rows.shape[0], 8, device="cpu")
    idx.snapshot(rows)
    idx.train_ivf(nlist=4, nprobe=2)
    for mode in I8_MODES:
        with pytest.raises(ValueError, match=r"needs enable_int8\(\) first"):
            idx.prepare([4], k=3, modes=(mode,))
    idx.enable_int8()
    idx.prepare([4], k=3, nprobe=2, modes=("exact_i8", "ivf_i8"))
    idx.freeze()
    q = queries(rows, 4)
    idx.query(q, 3, mode="exact_i8")
    idx.query(q, 3, mode="ivf_i8", nprobe=2)
    for bad in (
        lambda: idx.query(q[:3], 3, mode="exact_i8"),  # unprepared m
        lambda: idx.query(q, 2, mode="ivf_i8", nprobe=2),  # unprepared k
        lambda: idx.query(q, 3, mode="ivf_i8", nprobe=3),  # unprepared nprobe
        lambda: idx.query(q, 3, mode="ivf_fused_i8", nprobe=2),  # unprepared mode
    ):
        with pytest.raises(IndexRecompileError):
            bad()
    assert idx.recompiles_after_warmup == 0


def test_row_age_stats_match_jax():
    """Ingest stamps against JAX's with the same injected `now` values:
    empty, after a snapshot, after FIFO writes (one wrapping), after a
    partial fill."""
    rows = clustered(nc=4, per=16, dim=8)
    ji = jax_index.EmbeddingIndex(rows.shape[0], 8)
    pi = EmbeddingIndex(rows.shape[0], 8, device="cpu")
    assert pi.row_age_stats(now=5.0) == ji.row_age_stats(now=5.0)
    assert pi.row_age_stats(now=5.0)["row_age_max_s"] is None
    steps = [
        lambda idx: idx.snapshot(rows[:40], now=100.0),
        lambda idx: idx.add(rows[40:60], now=130.5),
        lambda idx: idx.add(rows[:16], now=161.25),  # crosses the end of the store
    ]
    for i, step in enumerate(steps):
        for idx in (ji, pi):
            step(idx)
        for now in (170.0, 200.0 + i):
            assert pi.row_age_stats(now=now) == ji.row_age_stats(now=now)
        np.testing.assert_array_equal(pi._row_time, ji._row_time)
    for idx in (ji, pi):
        idx.count = 30
    assert pi.row_age_stats(now=300.0) == ji.row_age_stats(now=300.0)
