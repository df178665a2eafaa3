"""The lower-precision control fails the check, on the card (skipped where
there is none): the reference computed in fp8 in the program's place reads
at least three times what the program reads on the same seed, on one of
each cell's numbers, at widths a test run holds (ResNet-50 at a quarter
of its width on 112-px images, batch 32; ViT-tiny at 80 px; the serving
check at 72 px). The cells' own readings at full size, from
`benchmark/calibrate.py`, are in PERF.md."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.drivers import serve, train
from benchmark.tests.tiny import TINY_TRAIN_TRAFFIC, tiny_v2_config, tiny_v3_config

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def train_cell(kind):
    if kind == "v2":
        cfg = tiny_v2_config(compute_dtype="bfloat16", num_negatives=4096, dim=128)
        cfg.update(global_batch=32, num_filters=16)
        cfg["data"]["image_size"] = 112
    else:
        cfg = tiny_v3_config()
        cfg["moco"]["compute_dtype"] = "bfloat16"
    tr = {**TINY_TRAIN_TRAFFIC, "dataset_rows": cfg["global_batch"] * 200}
    return harness.Cell("control", {"name": "control", "chips": 1}, cfg, tr, {}, [], [])


@pytest.mark.cuda
@pytest.mark.parametrize("kind,numbers", [("v2", ("loss", "keys")),
                                          ("v3", ("loss", "grad_median"))])
def test_the_training_control_reads_far_above_the_program(kind, numbers, cuda_device):
    cell = train_cell(kind)
    for seed in SEEDS:
        program = train.calibration_numbers(cell, seed, "program", cuda_device)
        control = train.calibration_numbers(cell, seed, "control", cuda_device)
        assert any(control[n] >= 3 * program[n] for n in numbers), (seed, program, control)


@pytest.mark.cuda
def test_the_serving_control_reads_far_above_the_program(cuda_device):
    from benchmark.tests.test_bench_faults import serve_cell

    cell = serve_cell()
    for seed in SEEDS:
        program = serve.calibration_numbers(cell, seed, "program", cuda_device, seconds=2.0)
        control = serve.calibration_numbers(cell, seed, "control", cuda_device, seconds=2.0)
        assert control["score_gap"] >= 3 * program["score_gap"], (seed, program, control)
