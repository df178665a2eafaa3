"""Parity of the PyTorch port's embedding index (moco_tpu_torch/serve/index.py
and the cell-scan kernel's plain version) with moco_tpu/serve/index.py on
the CPU.

Rows are tie-free clustered unit vectors made with numpy from a seed.
Tolerances: ids equal; scores atol 1e-5 (f32 dots of unit vectors summed
in different orders); k-means centroids atol 1e-4 (10 Lloyd iterations
of f32 segment sums) with identical cell tables."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moco_tpu.serve import index as jax_index
from moco_tpu_torch.ops.ivf_scan import fused_cell_scores, fused_cell_scores_reference
from moco_tpu_torch.serve import index as port_index
from moco_tpu_torch.serve.index import EmbeddingIndex, IndexRecompileError

SCORE_ATOL = 1e-5


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


def t(x):
    return torch.from_numpy(np.array(x))


def assert_same_topk(got, want):
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    np.testing.assert_allclose(np.asarray(gs), np.asarray(ws), atol=SCORE_ATOL, rtol=0)


@pytest.fixture(scope="module")
def ivf_case():
    """Rows, queries, and the JAX-fitted IVF (centroids, cell table) both
    packages scan."""
    rows = clustered(nc=8, per=32, dim=16)
    q = queries(rows, 6)
    idx = jax_index.EmbeddingIndex(rows.shape[0], 16)
    idx.snapshot(rows)
    idx.train_ivf(nlist=8, nprobe=4)
    cent = np.asarray(idx._ivf["centroids"])
    cells = np.asarray(idx._ivf["cells"])
    return rows, q, cent, cells


@pytest.mark.parametrize("ptr", [0, 8, 56])
def test_fifo_write_matches_jax(ptr):
    rng = np.random.default_rng(ptr)
    rows = rng.normal(size=(64, 16)).astype(np.float32)
    vals = rng.normal(size=(8, 16)).astype(np.float32)
    want_rows, want_ptr = jax_index.fifo_write(jnp.asarray(rows), jnp.int32(ptr), jnp.asarray(vals))
    got_rows, got_ptr = port_index.fifo_write(t(rows), ptr, t(vals))
    np.testing.assert_array_equal(got_rows.numpy(), np.asarray(want_rows))
    assert got_ptr == int(want_ptr)


@pytest.mark.parametrize("valid", [None, 100])
def test_topk_cosine_matches_jax(valid):
    rows = clustered()
    q = queries(rows, 5)
    want = jax_index.topk_cosine(jnp.asarray(q), jnp.asarray(rows), 10,
                                 valid_count=None if valid is None else jnp.int32(valid))
    assert_same_topk(port_index.topk_cosine(t(q), t(rows), 10, valid_count=valid), want)


def test_kmeans_and_top2_assignment_match_jax():
    rows = clustered(nc=8, per=32, dim=16)
    want = np.asarray(jax_index.kmeans_fit(jnp.asarray(rows), nlist=8, iters=10))
    got = port_index.kmeans_fit(t(rows), nlist=8, iters=10).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    a1, a2 = jax_index._assign_top2(jnp.asarray(rows), jnp.asarray(want))
    b1, b2 = port_index._assign_top2(t(rows), t(want))
    np.testing.assert_array_equal(b1.numpy(), np.asarray(a1))
    np.testing.assert_array_equal(b2.numpy(), np.asarray(a2))


@pytest.mark.parametrize("valid", [256, 200])
def test_ivf_scans_match_jax(ivf_case, valid):
    """The composed scan, the running-top-k loop and the kernel-path scan
    each match their JAX counterpart, on a full and a partial fill."""
    rows, q, cent, cells = ivf_case
    args = (jnp.asarray(q), jnp.asarray(rows), jnp.asarray(cent), jnp.asarray(cells),
            jnp.int32(valid))
    want = jax_index._ivf_topk(*args, k=5, nprobe=4)
    assert_same_topk(port_index._ivf_topk(t(q), t(rows), t(cent), t(cells), valid, 5, 4), want)
    want_fused = jax_index._ivf_topk_fused(*args, k=5, nprobe=4)
    assert_same_topk(
        port_index._ivf_topk_fused(t(q), t(rows), t(cent), t(cells), valid, 5, 4), want_fused
    )
    cell_rows = rows[np.minimum(cells, rows.shape[0] - 1)]
    want_pallas = jax_index._ivf_topk_fused_pallas(
        args[0], args[1], args[2], args[3], jnp.asarray(cell_rows), args[4],
        k=5, nprobe=4, interpret=True,
    )
    assert_same_topk(
        port_index._ivf_topk_fused_kernel(t(q), t(cent), t(cells), t(cell_rows), valid, 5, 4),
        want_pallas,
    )


@pytest.mark.parametrize("pattern", ["top_k", "one_cell", "duplicates"])
def test_cell_scores_reference_matches_pallas_interpret(ivf_case, pattern):
    """The kernel's plain version against the Pallas kernel in interpret
    mode, as tests/test_serve_ivf.py runs it: atol 1e-5. Probes: each
    query's top 4 cells; every pair in one cell; each odd probe repeating
    the one before it (the card tests' patterns)."""
    rows, q, cent, cells = ivf_case
    cell_rows = rows[np.minimum(cells, rows.shape[0] - 1)]
    probes = np.array(jax.lax.top_k(jnp.asarray(q @ cent.T), 4)[1], np.int32)
    if pattern == "one_cell":
        probes = np.full_like(probes, 3)
    elif pattern == "duplicates":
        probes[:, 1::2] = probes[:, 0::2]
    want = np.asarray(jax_index._fused_cell_scores_pallas(
        jnp.asarray(q), jnp.asarray(cell_rows), jnp.asarray(probes), interpret=True
    ))
    got = fused_cell_scores_reference(t(q), t(cell_rows), t(probes)).numpy()
    assert got.shape == want.shape == (q.shape[0], 4, cells.shape[1])
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    # the wrapper takes the plain version for CPU tensors, without a launch
    launches = fused_cell_scores.launches
    np.testing.assert_array_equal(fused_cell_scores(t(q), t(cell_rows), t(probes)).numpy(), got)
    assert fused_cell_scores.launches == launches


def _tf32(x):
    """x rounded to TF32 as csrc/ivf_cell_scores.cu rounds hi: add half a
    TF32 ulp and clear the 13 low bits (cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_trunc(x):
    """x as the tensor cores read a TF32 operand handed to them unrounded:
    its 13 low bits dropped."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_tf32_product_keeps_cell_scores_at_f32_level(seed):
    """The precision argument of the cell-scan kernel, emulated in torch at
    the serving width (d = 128, unit rows): scores from one TF32 product
    (hi.hi) miss the 1e-5 score gate against a float64 oracle; the
    kernel's three split products (lo.hi + hi.lo + hi.hi, hi = tf32(x)
    rounded, lo = x - hi as the tensor cores read it, its low bits
    dropped), summed in float64 and rounded to f32 as the tensor cores' f32
    accumulator leaves them, stay within 1e-6, the f32 level."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(64, 128, generator=gen), dim=1)
    rows = torch.nn.functional.normalize(torch.randn(4096, 128, generator=gen), dim=1)
    want = q.double() @ rows.double().T
    q_hi, rows_hi = _tf32(q), _tf32(rows)
    q_lo, rows_lo = _tf32_trunc(q - q_hi), _tf32_trunc(rows - rows_hi)

    def product(x, y):
        return x.double() @ y.double().T

    one = product(q_hi, rows_hi).float()
    split = (product(q_lo, rows_hi) + product(q_hi, rows_lo) + product(q_hi, rows_hi)).float()
    err_one = (one.double() - want).abs().max().item()
    err_split = (split.double() - want).abs().max().item()
    assert err_split <= 1e-6 < 1e-5 < err_one, (err_one, err_split)


@pytest.mark.parametrize("bad", ["dtype", "probe_dtype", "shape", "rank"])
def test_cell_scores_wrapper_rejects_bad_inputs(bad):
    q = torch.zeros(2, 8)
    cell_rows = torch.zeros(4, 3, 8)
    probes = torch.zeros(2, 2, dtype=torch.int32)
    if bad == "dtype":
        q = q.double()
    elif bad == "probe_dtype":
        probes = probes.long()
    elif bad == "shape":
        cell_rows = torch.zeros(4, 3, 6)
    else:
        probes = probes[0]
    with pytest.raises((TypeError, ValueError)):
        fused_cell_scores(q, cell_rows, probes)


def test_train_ivf_builds_the_jax_cell_table():
    """Same rows -> same centroids (atol 1e-4) and the identical padded
    cell table, counts and spill."""
    rows = clustered(nc=8, per=32, dim=16)
    ji = jax_index.EmbeddingIndex(rows.shape[0], 16)
    ji.snapshot(rows)
    want = ji.train_ivf(nlist=8, nprobe=4)
    pi = EmbeddingIndex(rows.shape[0], 16, device="cpu")
    pi.snapshot(rows)
    got = pi.train_ivf(nlist=8, nprobe=4)
    assert got == want
    np.testing.assert_allclose(
        pi._ivf["centroids"].numpy(), np.asarray(ji._ivf["centroids"]), atol=1e-4, rtol=0
    )
    for key in ("cells", "counts", "row_cell", "row_slot"):
        np.testing.assert_array_equal(pi._ivf[key], ji._ivf[key], err_msg=key)


@pytest.fixture(scope="module")
def both_indexes():
    rows = clustered(nc=8, per=32, dim=16)
    ji = jax_index.EmbeddingIndex(rows.shape[0], 16)
    pi = EmbeddingIndex(rows.shape[0], 16, device="cpu")
    for idx in (ji, pi):
        idx.snapshot(rows)
        idx.train_ivf(nlist=8, nprobe=4)
    return rows, ji, pi


@pytest.mark.parametrize("mode", ["exact", "ivf", "ivf_fused"])
def test_index_query_matches_jax(both_indexes, mode):
    rows, ji, pi = both_indexes
    q = queries(rows, 8, seed=5)
    got = pi.query(q, 5, mode=mode)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    assert_same_topk(got, ji.query(q, 5, mode=mode))


@pytest.mark.parametrize("mode", ["exact", "ivf", "ivf_fused"])
def test_fifo_ingest_keeps_parity(mode):
    """After FIFO writes that cross the end of the store and re-home cells,
    queries still match the JAX index."""
    rows = clustered(nc=8, per=16, dim=8)
    ji = jax_index.EmbeddingIndex(rows.shape[0], 8)
    pi = EmbeddingIndex(rows.shape[0], 8, device="cpu")
    fresh = queries(rows, 24, seed=9, noise=0.3)
    for idx in (ji, pi):
        idx.snapshot(rows)
        idx.train_ivf(nlist=8, nprobe=4)
        idx.add(fresh[:16])
        idx._ptr = rows.shape[0] - 4  # the next block splits at the end
        idx.add(fresh[16:])
    for key in ("cells", "counts", "row_cell", "row_slot"):
        np.testing.assert_array_equal(pi._ivf[key], ji._ivf[key], err_msg=key)
    np.testing.assert_array_equal(pi.rows.numpy(), np.asarray(ji.rows))
    q = queries(rows, 8, seed=10)
    assert_same_topk(pi.query(q, 5, mode=mode), ji.query(q, 5, mode=mode))


def test_from_train_queue_and_partial_fill_match_jax():
    rows = clustered(nc=4, per=16, dim=8)
    ji = jax_index.EmbeddingIndex.from_train_queue(rows, queue_ptr=8, count=40)
    pi = EmbeddingIndex.from_train_queue(rows, queue_ptr=8, count=40, device="cpu")
    assert (pi.count, pi._ptr) == (ji.count, ji._ptr)
    q = queries(rows, 4)
    assert_same_topk(pi.query(q, 6), ji.query(q, 6))


def test_freeze_rejects_unprepared_shapes():
    rows = clustered(nc=4, per=16, dim=8)
    idx = EmbeddingIndex(rows.shape[0], 8, device="cpu")
    idx.snapshot(rows)
    idx.train_ivf(nlist=4, nprobe=2)
    idx.prepare([4], k=3, modes=("exact", "ivf", "ivf_fused"))
    idx.freeze()
    q = queries(rows, 4)
    for mode in ("exact", "ivf", "ivf_fused"):
        idx.query(q, 3, mode=mode)  # prepared: fine
    assert idx.recompiles_after_warmup == 0
    with pytest.raises(IndexRecompileError):
        idx.query(q[:2], 3, mode="ivf_fused")
    with pytest.raises(IndexRecompileError):
        idx.query(q, 4, mode="exact")


@pytest.mark.parametrize("mode", ["exact_i8", "ivf_i8", "ivf_fused_i8", "bogus"])
def test_unported_modes_raise(mode):
    """The int8 tiers answer only after enable_int8(), with JAX's message;
    an unknown mode is refused."""
    idx = EmbeddingIndex(8, 4, device="cpu")
    idx.snapshot(clustered(nc=2, per=4, dim=4))
    match = r"needs enable_int8\(\) first" if mode != "bogus" else "unknown"
    with pytest.raises(ValueError, match=match):
        idx.query(np.zeros((1, 4), np.float32), 2, mode=mode)


def test_ivf_modes_need_training():
    idx = EmbeddingIndex(8, 4, device="cpu")
    with pytest.raises(ValueError, match="train_ivf"):
        idx.query(np.zeros((1, 4), np.float32), 2, mode="ivf_fused")
