"""Each fault a cell can have, planted in the program underneath a run that
skips the harness's look for a card (on the CPU, at tiny widths): the run's
check comes out false. Training: a step that returns its state unchanged,
half of the batch left out with the mean over the rest, and (v2) a key
altered where it is produced; serving: an answer altered where it is
produced, one probe where the cell states more, the first chunk of every
cell left out of the scan, and a top-k that drops the best row. One card, so no exchange between chips to leave out. The same
tiny runs without a fault come out true."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import harness
from benchmark.drivers import serve, train
from benchmark.tests.tiny import TINY_TRAIN_TRAFFIC, tiny_v2_config, tiny_v3_config

# the cells' limits, set on the card at full size
LIMITS = {"v2": harness.load_cell("v2_r50_train").limits,
          "v3": harness.load_cell("v3_vitb16_train").limits}
CONFIGS = {"v2": tiny_v2_config, "v3": tiny_v3_config}


def run_train(kind: str):
    cell = harness.Cell("tiny", {"name": "tiny", "chips": 1}, CONFIGS[kind](),
                        dict(TINY_TRAIN_TRAFFIC), LIMITS[kind], [], [])
    out = train.run(cell, seed=2**31 + 77, seconds=1.0, trace=False, device="cpu",
                    t_start=time.perf_counter())
    ok, checks = harness.judge(out["numbers"], cell.limits)
    return ok and out["correct"], checks


def unchanged_step(real):
    """The step runs and returns its metrics, but leaves the state as it was."""

    def make(config, steps_per_epoch, device="cuda", world=None):
        step = real(config, steps_per_epoch, device=device, world=world)

        def faulty(state, batch, *a):
            mods = [m for m in (state.encoder_q, state.encoder_k, state.predictor) if m is not None]
            saved = [p.detach().clone() for m in mods for p in m.parameters()]
            queue = None if state.queue is None else state.queue.clone()
            metrics = step(state, batch, *a)
            with torch.no_grad():
                for p, s in zip((p for m in mods for p in m.parameters()), saved):
                    p.copy_(s)
                if queue is not None:
                    state.queue.copy_(queue)
            return metrics

        return faulty

    return make


def half_batch_loss(real):
    """The loss over the first half of the rows only."""

    def loss(*args):
        a = list(args)
        h = a[0].shape[0] // 2
        a[0], a[1] = a[0][:h], a[1][:h]
        return real(*a)

    return loss


def altered_keys(real):
    """The enqueue writes keys turned away from the ones computed."""

    def enqueue(queue, ptr, keys):
        bent = keys + 0.3 * torch.roll(keys, 1, dims=1)
        return real(queue, ptr, bent / bent.norm(dim=1, keepdim=True))

    return enqueue


@pytest.mark.parametrize("kind", ["v2", "v3"])
def test_a_sound_tiny_run_is_correct(kind):
    ok, checks = run_train(kind)
    assert ok, checks


@pytest.mark.parametrize("kind,fault", [
    ("v2", "unchanged"), ("v2", "half_batch"), ("v2", "keys"),
    ("v3", "unchanged"), ("v3", "half_batch"),
])
def test_a_planted_training_fault_makes_the_run_incorrect(kind, fault, monkeypatch):
    import moco_tpu_torch.core.moco as core
    import moco_tpu_torch.train as program

    if fault == "unchanged":
        monkeypatch.setattr(program, "make_train_step", unchanged_step(core.make_train_step))
    elif fault == "half_batch" and kind == "v2":
        monkeypatch.setattr(core, "fused_infonce_loss", half_batch_loss(core.fused_infonce_loss))
    elif fault == "half_batch":
        monkeypatch.setattr(core, "cross_entropy", half_batch_loss(core.cross_entropy))
    else:
        monkeypatch.setattr(core, "enqueue", altered_keys(core.enqueue))
    ok, checks = run_train(kind)
    assert not ok, checks


def serve_cell():
    cfg = tiny_v2_config()
    tr = harness.load_json(harness.ROOT / "benchmark/traffic/neighbors_mix.json")
    tr.update({"image_size": 72, "mix": {"1": 0.5, "4": 0.5}, "buckets": [1, 8], "pool": 32,
               "rate_rps": 8.0, "index_rows": 2048, "centres": 64, "noise": 0.3, "nlist": 16,
               "nprobe": 4, "warm_s": 1.0, "check_requests": 6, "check_large": 2,
               "clients": 2})
    return harness.Cell("tiny_serve", {"name": "tiny_serve", "chips": 1}, cfg, tr,
                        harness.load_cell("v2_r50_serve").limits, [], [])


def run_serve(nprobe=None):
    cell = serve_cell()
    out = serve.run(cell, seed=2**31 + 78, seconds=2.0, trace=False, device="cpu",
                    t_start=time.perf_counter(), nprobe=nprobe)
    ok, checks = harness.judge(out["numbers"], cell.limits)
    return ok and out["correct"] and out["failed"] == 0, checks


def test_a_sound_tiny_serving_run_is_correct():
    ok, checks = run_serve()
    assert ok, checks


def test_an_answer_altered_where_it_is_produced_fails(monkeypatch):
    from moco_tpu_torch.serve.server import ServeServer

    real = ServeServer._run_batch

    def altered(self, *args, **kw):
        results, executed = real(self, *args, **kw)
        for key in [k for k in results if k.startswith("indices:")]:
            idx = results[key].copy()
            idx[:, 0] = (idx[:, 0] + 1) % self.index.count  # another row, the score kept
            results[key] = idx
        return results, executed

    monkeypatch.setattr(ServeServer, "_run_batch", altered)
    ok, checks = run_serve()
    assert not ok, checks


def without_the_best(real):
    """The IVF top-k that returns ranks 2..k+1: true scores, in order."""

    def topk(queries, centroids, cell_ids, cell_rows, valid_count, k, nprobe):
        scores, ids = real(queries, centroids, cell_ids, cell_rows, valid_count, k + 1, nprobe)
        return scores[:, 1:], ids[:, 1:]

    return topk


@pytest.mark.parametrize("fault", ["nprobe1", "chunk_skip", "without_the_best"])
def test_a_planted_selection_fault_makes_the_serving_run_incorrect(fault, monkeypatch):
    import moco_tpu_torch.serve.index as index

    if fault == "chunk_skip":
        monkeypatch.setattr(index, "fused_cell_scores", serve.skipped_chunk(index.fused_cell_scores))
    elif fault == "without_the_best":
        monkeypatch.setattr(index, "_ivf_topk_fused_kernel",
                            without_the_best(index._ivf_topk_fused_kernel))
    ok, checks = run_serve(nprobe=1 if fault == "nprobe1" else None)
    assert not ok, checks
    assert checks["select_gap"]["value"] > checks["select_gap"]["limit"], checks


@pytest.mark.parametrize("fault,misplaced", [("far_cell", 2), ("dropped", 1)])
def test_a_misplaced_row_makes_the_serving_run_incorrect(fault, misplaced, monkeypatch):
    """A row moved to the cell farthest from its own (it and the row it
    swaps with are both misplaced), or dropped from its cell, which is
    not full."""
    from moco_tpu_torch.serve.index import EmbeddingIndex

    real = EmbeddingIndex.train_ivf

    def misplacing(self, *args, **kw):
        stats = real(self, *args, **kw)
        ivf = self._ivf
        cells = ivf["cells"]
        if fault == "far_cell":
            far = int(torch.argmin(ivf["centroids"] @ ivf["centroids"][0]))
            cells[0, 0], cells[far, 0] = cells[far, 0], cells[0, 0]
        else:
            last = int(ivf["counts"][0]) - 1
            cells[0, 0], cells[0, last] = cells[0, last], self.capacity
            ivf["counts"][0] = last
        ivf["dirty"] = True
        return stats

    monkeypatch.setattr(EmbeddingIndex, "train_ivf", misplacing)
    ok, checks = run_serve()
    assert not ok, checks
    assert checks["ivf_misplaced"]["value"] == misplaced, checks
