"""The yardstick's counts against hand-worked numbers, and the device
trace's arithmetic on a synthetic trace."""

from __future__ import annotations

import pytest

from benchmark import counts, devtrace


def test_infonce_counts_at_the_v2_shapes():
    ops, nbytes = counts.infonce_counts(256, 65536, 128)
    assert ops == 4 * 256 * 65536 * 128 == pytest.approx(8.59e9, rel=1e-3)
    # the queue dominates the bytes: 65536 x 128 f32 = 33.6 MB
    assert nbytes == pytest.approx(4 * (2 * 256 * 128 + 65536 * 128 + 2 * 256 + 256 * 128))
    # bound by the TF32 rate: 8.59e9 / 495e12 = 0.01735 ms > 33.9 MB / 3.35 TB/s = 0.0101 ms
    assert counts.infonce_bound_s(256, 65536, 128) * 1e3 == pytest.approx(0.01735, rel=1e-3)


def test_flash_forward_is_bytes_bound_at_the_v3_shapes():
    # B*H = 512 views x 12 heads, S = 197, D = 64: q, k, v, o in bf16 and the
    # f32 lse; PERF.md's 0.1864 ms
    ops, nbytes = counts.flash_counts(6144, 197, 64, backward=False)
    assert ops == pytest.approx(4 * 6144 * 197 ** 2 * 64)
    assert nbytes == pytest.approx(4 * 2 * 6144 * 197 * 64 + 4 * 6144 * 197)
    assert counts.flash_bound_s(6144, 197, 64, backward=False) * 1e3 == pytest.approx(
        0.1864, rel=2e-3)
    assert ops / counts.PEAK_BF16_FLOPS < nbytes / counts.PEAK_BYTES_PER_S
    b_ops, b_bytes = counts.flash_counts(6144, 197, 64, backward=True)
    assert b_ops == 2 * ops and b_bytes == pytest.approx(8 * 2 * 6144 * 197 * 64 + 4 * 6144 * 197)


def test_model_flops_from_the_shapes():
    # ResNet-50 at 224 px: 4.09 GMACs (torchvision's count) = 8.18 GFLOP
    assert counts.resnet50_forward_flops() == pytest.approx(8.18e9, rel=0.01)
    # ViT-B/16 at 224 px: 17.56 GMACs = 35.1 GFLOP
    assert counts.vit_forward_flops() == pytest.approx(35.1e9, rel=0.01)
    # MoCo v2: 4 forwards' worth per image, about 4 x 8.2 GFLOP
    assert counts.v2_train_flops_per_image() == pytest.approx(4 * 8.18e9, rel=0.03)
    # MoCo v3: 6 x 35 + 2 x 35 = 281 GFLOP per image, plus the heads
    assert counts.v3_train_flops_per_image() == pytest.approx(281e9, rel=0.01)


def test_busy_time_is_the_union_over_streams():
    # two streams: [0, 10) and [5, 12) overlap; [20, 25) alone; window [0, 30)
    assert devtrace.union_length([(0, 10), (5, 12), (20, 25)]) == 17
    assert devtrace.gaps([(0, 10), (5, 12), (20, 25)], 0, 30) == [(12, 20), (25, 30)]
    assert devtrace.union_length([(0, 10), (2, 3)]) == 10


def test_summarize_a_synthetic_trace():
    mark = {"name": "Memcpy DtoD", "cat": "gpu_memcpy", "dur": 1.0,
            "args": {"bytes": devtrace.MARK_BYTES}}
    ev = [
        {**mark, "ts": 100.0},
        {**mark, "ts": 199.0},
        {"name": "gemm", "cat": "kernel", "ts": 90.0, "dur": 30.0, "args": {"stream": 7}},
        {"name": "copy", "cat": "gpu_memcpy", "ts": 110.0, "dur": 20.0, "args": {"stream": 9}},
        {"name": "gemm", "cat": "kernel", "ts": 150.0, "dur": 10.0, "args": {"stream": 7}},
        {"name": "aten::conv2d", "cat": "cpu_op", "ts": 125.0, "dur": 30.0},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 146.0, "dur": 2.0},
    ]
    s = devtrace.summarize(ev)
    assert s["window_s"] == pytest.approx(100e-6)
    # the marks, kernels and copy cover [100, 130), [150, 160) and [199, 200) of [100, 200)
    assert s["busy_s"] == pytest.approx(41e-6)
    assert s["device_ops"][0] == ["gemm", pytest.approx(30e-6)]
    # the gap [130, 150) is covered by the conv op; [160, 199) by nothing
    labels = dict(s["idle_gaps"])
    assert labels["aten::conv2d"] == pytest.approx(20e-6)
    assert labels["(no host op)"] == pytest.approx(39e-6)
    assert devtrace.kernel_seconds(s["kernels"], ("gemm",)) == pytest.approx(30e-6)
    assert devtrace.summarize(ev[1:]) == {}
