"""The plain references against the program on the same inputs, on the
CPU at tiny widths (the test may import both; the reference may not)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.drivers import serve, train
from benchmark.reference import augment, nets, steps
from benchmark.tests.tiny import TINY_TRAIN_TRAFFIC, tiny_v2_config, tiny_v3_config


def cell_of(cfg):
    return harness.Cell("tiny", {"name": "tiny", "chips": 1}, cfg, dict(TINY_TRAIN_TRAFFIC), {},
                        [], [])


def program_state(cfg, seed=3):
    cell = cell_of(cfg)
    config = train.program_config(cell, seed, 50)
    w, gen = weights.make(train.spec_of(cfg), seed, "cpu", residual_gamma=cfg.get(
        "residual_gamma", 1.0))
    queue = None if cfg["moco"].get("v3") else weights.queue(gen, cfg["moco"]["num_negatives"],
                                                            cfg["moco"]["dim"])
    w0 = {n: t.clone() for n, t in w.items()}
    q0 = None if queue is None else queue.clone()
    state = train.build_state(cell, config, w, queue, torch.device("cpu"))
    return config, state, w0, q0


def test_resnet50_and_head_match_the_encoder():
    cfg = tiny_v2_config()
    _, state, w0, _ = program_state(cfg)
    x = torch.rand(4, 72, 72, 3) * 2 - 1
    for train_mode in (False, True):  # eval first: a train forward moves the running stats
        state.encoder_k.train(train_mode)
        with torch.no_grad():
            got = state.encoder_k(x)
            want = nets.resnet50_v2(w0, x, train=train_mode, num_filters=cfg["num_filters"])
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max())


def test_vit_projector_and_predictor_match():
    cfg = tiny_v3_config()
    _, state, w0, _ = program_state(cfg)
    x = torch.rand(4, 80, 80, 3) * 2 - 1
    state.encoder_q.train()
    state.predictor.train()
    with torch.no_grad():
        got = state.predictor(state.encoder_q(x))
        feats = nets.vit_features(w0, x, vit=cfg["vit"])
        want = nets.mlp_head(w0, "predictor", nets.mlp_head(w0, "head", feats, 3, True, True),
                             2, True, True)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_augment_matches_the_pipeline():
    from moco_tpu_torch.data.datasets import SyntheticDataset
    from moco_tpu_torch.data.pipeline import TwoCropPipeline
    from moco_tpu_torch.utils.config import DataConfig

    seed = 2**31 + 17
    dc = DataConfig(dataset="synthetic", image_size=96, aug_plus=True, global_batch=8,
                    num_workers=2)
    with TwoCropPipeline(dc, seed=seed, dataset=SyntheticDataset(800, 96), device="cpu") as p:
        for step in (0, 3):
            got = p.batch(0, step)
            rows = steps.synthetic_batch(seed, 0, step, 8, 800, 96)
            q, k = augment.two_views(torch.from_numpy(rows), seed, 0, step, 96)
            # float32 reductions in another order; the HSV round trip divides by
            # small chroma
            assert (got["im_q"] - q).abs().max() < 5e-4
            assert (got["im_k"] - k).abs().max() < 5e-4


@pytest.mark.parametrize("make", [tiny_v2_config, tiny_v3_config], ids=["v2", "v3"])
def test_one_step_matches(make):
    from moco_tpu_torch.core.moco import make_train_step

    cfg = make()
    config, state, w0, q0 = program_state(cfg)
    fn = make_train_step(config, 200, device="cpu")
    rows = steps.synthetic_batch(3, 0, 0, 8, 1600, cfg["data"]["image_size"])
    im_q, im_k = augment.two_views(torch.from_numpy(rows), 3, 0, 0, cfg["data"]["image_size"])
    metrics = fn(state, {"im_q": im_q, "im_k": im_k})
    ref = steps.Trainer(cfg, w0, weights.kinds(train.spec_of(cfg)), q0, 200, "cpu")
    loss = ref.step(im_q, im_k)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-4)
    grads = train.first_gradient(state, cfg["optim"], w0)
    gaps = train.leaf_gaps(grads, ref.first_grads, list(ref.first_grads))
    assert max(gaps.values()) < 1e-2
    q, k = train.snapshot(state)
    for n in ref.trained:
        assert torch.allclose(q[n], ref.q[n], rtol=1e-4, atol=1e-6), n
    if q0 is not None:
        assert torch.allclose(state.queue[:8], ref.queue[:8], atol=1e-4)


def test_served_embedding_matches_the_engine():
    from moco_tpu_torch.serve.engine import InferenceEngine

    cfg = tiny_v2_config()
    w, _ = weights.make(nets.spec_resnet50_v2(8, 16), 5, "cpu", residual_gamma=0.2)
    w0 = {n: t.clone() for n, t in w.items()}
    engine = InferenceEngine(serve.build_encoder(cfg, w, "cpu"), 72, buckets=(8,), device="cpu")
    imgs = np.random.default_rng(0).integers(0, 256, (6, 72, 72, 3), dtype=np.uint8)
    got, _ = engine.embed(imgs)
    want = serve.reference_embed(cfg, w0, imgs, torch.device("cpu"))
    assert np.allclose(np.asarray(got), want.numpy(), atol=1e-5)


def test_fp8_control_rounds_and_differs():
    x = torch.randn(64, 32)
    w = torch.randn(16, 32)
    f32 = nets.FP32.linear(x, w)
    f8 = nets.Precision("fp8").linear(x, w)
    rel = (f8 - f32).norm() / f32.norm()
    assert 1e-3 < rel < 0.2
    assert torch.equal(nets.Precision("fp8").linear(x, w), f8)


def test_the_ivf_check_takes_a_spill_the_cell_cap_forced():
    """At the serving cell's index, seed 5300000006 leaves one row out of
    the IVF (both its cells full): the check reads 0 for it, and 1 once a
    row whose cell has room is dropped as well."""
    from benchmark.reference import search

    tr = harness.load_cell("v2_r50_serve").traffic
    rows = serve.index_rows(5300000006, tr["index_rows"], 128, tr["centres"], tr["noise"])
    index = serve.program_index(tr, rows, 128, torch.device("cpu"), tr["nprobe"])
    assert index.ivf_stats()["spilled"] == 1
    ivf = serve.ivf_state(index)
    table = torch.from_numpy(rows)
    assert search.ivf_build(table, ivf["centroids"], ivf["cells"], ivf["count"]) == {
        "ivf_misplaced": 0.0}
    cells = ivf["cells"].clone()
    room = int(torch.nonzero((cells < ivf["count"]).sum(dim=1) < cells.shape[1])[0])
    cells[room, 0] = ivf["count"]
    assert search.ivf_build(table, ivf["centroids"], cells, ivf["count"]) == {
        "ivf_misplaced": 1.0}
