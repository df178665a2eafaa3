"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is visible (the
decision is made inside the fixture, never at import). Run on a machine
with an H100 and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine
need not have.)

Tolerances. IVF cell scan: max |kernel - plain| <= 1e-5 on unit-norm f32
rows (the kernel's split-TF32 products are at the f32 level; their order
over d differs from cuBLAS's). InfoNCE on unit rows at T = 0.2 (split-TF32 products on the
tensor cores, f32-level): pos <= 1e-5, lse <= 1e-4 (the kernel merges
per-split logsumexps, the plain version takes one over the row), n_above on every row between the float64 count of logits above
pos by more than 1e-5 and that count plus the near ties within 1e-5 (a
discrete count flips on a rounding difference only there), and
max |dq - plain| <= 1e-4 * max |plain| + 1e-6. Flash attention (forward,
dq, dk/dv) against the plain versions in f32: f32 inputs out <= 1e-5 *
max |out| + 1e-6, lse <= 1e-5, grads <= 1e-4 * max |grad| + 1e-6; bf16
inputs lse <= 1e-5 and each output within 2^-7 of its largest sum of
absolute terms (`abs_term_sums`) + 1e-6: the most that rounding p or dS
and the output to bf16 (2^-8 relative each) can move it.
"""

import dataclasses

import pytest
import torch

from moco_tpu_torch.core.moco import build_encoder, build_predictor, create_state, make_train_step
from moco_tpu_torch.ops.flash_attention import (
    KERNELS,
    abs_term_sums,
    attention_reference,
    backward_coeff,
    flash_dkv,
    flash_dkv_reference,
    flash_dq,
    flash_dq_reference,
    flash_forward,
)
from moco_tpu_torch.ops.fused_infonce import (
    MAX_C,
    fused_infonce_loss,
    infonce_dq,
    infonce_dq_reference,
    infonce_stats,
    infonce_stats_reference,
    query_rows,
)
from moco_tpu_torch.ops.ivf_scan import fused_cell_scores, fused_cell_scores_reference
from moco_tpu_torch.utils.config import DataConfig, MocoConfig, OptimConfig, TrainConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _unit(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return x / x.norm(dim=-1, keepdim=True)


def _probes(pattern, m, nprobe, nlist, gen, device):
    """(m, nprobe) int32 probe ids: `uniform` draws; `one_cell`, every pair
    in one cell; `duplicates`, each odd probe repeats the one before it;
    `skewed`, draws from 20 cells or fewer (the served features probe ~19 of 256);
    `invalid`, uniform with every 5th id outside [0, nlist)."""
    draw = torch.randint(0, nlist, (m, nprobe), generator=gen, device=device, dtype=torch.int32)
    if pattern == "one_cell":
        return torch.full_like(draw, nlist // 2)
    if pattern == "duplicates":
        draw[:, 1::2] = draw[:, 0::2][:, : nprobe // 2]
    elif pattern == "skewed":
        hot = torch.randperm(nlist, generator=gen, device=device)[:20].int()
        draw = hot[torch.randint(0, hot.numel(), (m, nprobe), generator=gen, device=device)]
    elif pattern == "invalid":
        flat = draw.view(-1)
        k = torch.arange(0, flat.numel(), 5, device=device)
        flat[k] = torch.where(k % 2 == 0, -1 - k, nlist + k).int()
    return draw.contiguous()


@pytest.mark.parametrize(
    "m,d,nlist,cell_cap,nprobe,pattern",
    [(1, 128, 256, 512, 16, "uniform"), (128, 128, 256, 512, 16, "uniform"),
     (7, 16, 8, 37, 4, "uniform"), (5, 132, 4, 9, 3, "uniform"),
     # 2048 pairs in one cell; the served path's skew; a row probing a cell twice
     (128, 128, 256, 512, 16, "one_cell"), (128, 128, 256, 512, 16, "skewed"),
     (32, 128, 64, 100, 8, "duplicates"),
     # more pairs than one scan round (2048) and one batch of query rows
     (300, 128, 64, 64, 16, "uniform"), (300, 128, 8, 64, 16, "one_cell"),
     # the widest and narrowest padded widths; cell_cap no multiple of the chunk
     (5, 512, 16, 40, 3, "uniform"), (9, 16, 8, 512, 4, "skewed"),
     (11, 132, 6, 37, 5, "duplicates"),
     # ids outside [0, nlist) mixed with valid ones: NaN exactly there
     (6, 64, 5, 70, 4, "invalid"), (40, 256, 7, 9, 6, "invalid"),
     # more cells than one bitmap window (8192) of probed cells
     (50, 16, 9000, 5, 8, "uniform"), (40, 16, 9000, 3, 8, "invalid")],
)
def test_cell_scores_kernel_matches_plain(cuda, m, d, nlist, cell_cap, nprobe, pattern):
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    q = _unit((m, d), gen, cuda)
    cell_rows = _unit((nlist, cell_cap, d), gen, cuda)
    probes = _probes(pattern, m, nprobe, nlist, gen, cuda)
    before = fused_cell_scores.launches
    got = fused_cell_scores(q, cell_rows, probes)
    torch.cuda.synchronize()
    assert fused_cell_scores.launches == before + 1
    bad = (probes < 0) | (probes >= nlist)
    want = fused_cell_scores_reference(q, cell_rows, probes.clamp(0, nlist - 1))
    assert torch.equal(got.isnan(), bad[:, :, None].expand_as(got))
    assert (got - want)[~bad].abs().max().item() <= 1e-5


@pytest.mark.parametrize("pattern", ["uniform", "skewed", "one_cell"])
def test_cell_scores_kernel_gives_the_same_bits_twice(cuda, pattern):
    """One writer per score and a fixed order over d: two calls on the same
    inputs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = _unit((128, 128), gen, cuda)
    cell_rows = _unit((256, 512, 128), gen, cuda)
    probes = _probes(pattern, 128, 16, 256, gen, cuda)
    first, again = (fused_cell_scores(q, cell_rows, probes) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, again)


def test_cell_scores_kernel_marks_bad_probes(cuda):
    q = torch.ones(2, 8, device=cuda)
    cell_rows = torch.ones(4, 3, 8, device=cuda)
    probes = torch.tensor([[0, 4], [-1, 3]], dtype=torch.int32, device=cuda)
    out = fused_cell_scores(q, cell_rows, probes)
    torch.cuda.synchronize()
    assert out[0, 1].isnan().all() and out[1, 0].isnan().all()
    assert (out[0, 0] == 8).all() and (out[1, 1] == 8).all()


def test_cell_scores_kernel_rejects_unsupported_width(cuda):
    with pytest.raises(ValueError, match="d % 4"):
        fused_cell_scores(torch.zeros(1, 6, device=cuda), torch.zeros(2, 3, 6, device=cuda),
                          torch.zeros(1, 1, dtype=torch.int32, device=cuda))


def _infonce_inputs(b, kk, c, gen, device, tie_rows=0):
    q, k, queue = _unit((b, c), gen, device), _unit((b, c), gen, device), _unit((kk, c), gen, device)
    if tie_rows:  # the positive equals a queue row: an exact tie in the count
        idx = torch.randint(0, kk, (tie_rows,), generator=gen, device=device)
        k[:tie_rows] = queue[idx]
    return q, k, queue


def _count_window(q, k, rows, t, tol=1e-5):
    """Per row of q, (lo, hi): the least and most negatives a count of
    `logit > pos` may report. lo counts the logits above pos by more than
    `tol` in float64; hi adds those within `tol` of pos (near ties, where
    a float32 count may go either way)."""
    pos = (q.double() * k.double()).sum(-1) / t
    diff = q.double() @ rows.double().T / t - pos[:, None]
    lo = (diff > tol).sum(1)
    return lo, lo + (diff.abs() <= tol).sum(1)


@pytest.mark.parametrize(
    "b,kk,c,tie_rows",
    [(256, 65536, 128, 0), (8, 4096, 128, 0), (7, 1000, 20, 0), (70, 1000, 33, 0),
     (16, 130, 128, 0), (32, 4096, 128, 8),
     # the widest C (64-row CTAs), a C no multiple of 8 over three CTAs'
     # rows, and K inside one partial tile
     (64, 4096, 256, 0), (300, 5000, 100, 0), (8, 1, 128, 0), (8, 7, 128, 0)],
)
def test_infonce_kernels_match_plain(cuda, b, kk, c, tie_rows):
    t = 0.2
    gen = torch.Generator(device=cuda).manual_seed(b * 7 + kk + c)
    q, k, queue = _infonce_inputs(b, kk, c, gen, cuda, tie_rows)
    before = (infonce_stats.launches, infonce_dq.launches)
    pos, lse, above = infonce_stats(q, k, queue, t)
    g = torch.rand(b, generator=gen, device=cuda)
    dq = infonce_dq(q, queue, lse, g, t)
    torch.cuda.synchronize()
    assert (infonce_stats.launches, infonce_dq.launches) == (before[0] + 1, before[1] + 1)
    pos_p, lse_p, above_p = infonce_stats_reference(q, k, queue, t)
    assert (pos - pos_p).abs().max().item() <= 1e-5
    assert (lse - lse_p).abs().max().item() <= 1e-4
    lo, hi = _count_window(q, k, queue, t)
    for count in (above, above_p):  # every row, each count inside its window
        assert ((count < lo) | (count > hi)).sum().item() == 0
    if tie_rows:
        assert (hi > lo)[:tie_rows].all()
    dq_p = infonce_dq_reference(q, queue, lse_p, g, t)
    assert (dq - dq_p).abs().max().item() <= 1e-4 * dq_p.abs().max().item() + 1e-6


@pytest.mark.parametrize("b,kk,c", [(256, 65536, 128), (300, 5000, 100)])
def test_infonce_kernels_give_the_same_bits_twice(cuda, b, kk, c):
    """No atomics: the split partials are merged in split order, so two
    calls on the same inputs give the same pos, lse, n_above and dq."""
    gen = torch.Generator(device=cuda).manual_seed(b + c)
    q, k, queue = _infonce_inputs(b, kk, c, gen, cuda)
    g = torch.rand(b, generator=gen, device=cuda)
    first, again = (infonce_stats(q, k, queue, 0.2) for _ in range(2))
    dq1, dq2 = (infonce_dq(q, queue, first[1], g, 0.2) for _ in range(2))
    torch.cuda.synchronize()
    for x, y in zip(first + (dq1,), again + (dq2,)):
        assert torch.equal(x, y)


def test_fused_infonce_loss_gradient_matches_plain(cuda):
    """The autograd function on the card against autograd through the
    plain logits: loss, accuracies and dq."""
    t, b, kk, c = 0.2, 64, 8192, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    q0, k, queue = _infonce_inputs(b, kk, c, gen, cuda)
    q = q0.clone().requires_grad_(True)
    loss, acc = fused_infonce_loss(q, k, queue, t)
    loss.backward()
    qr = q0.clone().requires_grad_(True)
    logits = torch.cat([(qr * k).sum(-1, keepdim=True), qr @ queue.T], dim=1) / t
    want = torch.nn.functional.cross_entropy(logits, torch.zeros(b, dtype=torch.long, device=cuda))
    want.backward()
    assert abs(loss.item() - want.item()) <= 1e-5
    ranks = (logits[:, 1:] > logits[:, :1]).sum(1)
    # an accuracy may differ only by rows whose count window straddles its cut
    lo, hi = _count_window(q0, k, queue, t)
    for name, top in (("acc1", 1), ("acc5", 5)):
        slack = 100.0 * ((lo < top) & (hi >= top)).float().mean().item()
        assert abs(acc[name].item() - 100.0 * (ranks < top).float().mean().item()) <= slack + 1e-9
    assert (q.grad - qr.grad).abs().max().item() <= 1e-4 * qr.grad.abs().max().item() + 1e-6


def test_train_step_launches_the_kernels_for_any_k(cuda):
    """K = 65536 + 64 is no multiple of the JAX kernel's 2048-row tile; the
    step on the card still launches each InfoNCE kernel once, and the
    dense path (fused_infonce=False) none."""
    cfg = TrainConfig(
        moco=MocoConfig(arch="resnet18", dim=16, num_negatives=65600, temperature=0.2, mlp=True,
                        cifar_stem=True, compute_dtype="float32"),
        optim=OptimConfig(cos=True, epochs=2), data=DataConfig(image_size=16, global_batch=16))
    assert cfg.moco.fused_infonce is None and cfg.moco.num_negatives % 2048  # the default
    state = create_state(cfg, build_encoder(cfg.moco, num_filters=4), device=cuda)
    step = make_train_step(cfg, 1, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {v: torch.randn((16, 16, 16, 3), generator=gen, device=cuda) for v in ("im_q", "im_k")}
    before = (infonce_stats.launches, infonce_dq.launches)
    out = step(state, batch)
    torch.cuda.synchronize()
    assert (infonce_stats.launches, infonce_dq.launches) == (before[0] + 1, before[1] + 1)
    assert torch.isfinite(out["loss"]).item() and state.queue_ptr == 16
    dense = dataclasses.replace(cfg, moco=dataclasses.replace(cfg.moco, fused_infonce=False))
    make_train_step(dense, 1, device=cuda)(state, batch)
    torch.cuda.synchronize()
    assert (infonce_stats.launches, infonce_dq.launches) == (before[0] + 1, before[1] + 1)


def _flash_inputs(b, h, s, d, dtype, gen, device):
    q, k, v, g = (torch.randn((b, h, s, d), generator=gen, device=device).to(dtype)
                  for _ in range(4))
    g_lse = torch.randn((b, h, s), generator=gen, device=device)
    return q, k, v, g, g_lse


def flash_errors(q, k, v, g, g_lse):
    """max |kernel - plain| of out, lse, dq, dk and dv on one input, with
    the tolerance of each: f32 out <= 1e-5 max|out| + 1e-6, lse <= 1e-5,
    grads <= 1e-4 max|grad| + 1e-6; bf16 (against the plain version in f32
    on the same bf16 values) 2^-7 of the output's largest absolute-term sum
    (`abs_term_sums`, the bound of its two bf16 roundings) + 1e-6, lse <= 1e-5."""
    scale = q.shape[-1] ** -0.5
    out, lse = flash_forward(q, k, v, scale)
    coeff = backward_coeff(out, g, g_lse)
    dq = flash_dq(q, k, v, g, lse, coeff, scale)
    dk, dv = flash_dkv(q, k, v, g, lse, coeff, scale)
    torch.cuda.synchronize()
    f = [x.float() for x in (q, k, v, g)]
    out_p, lse_p = attention_reference(*f[:3], scale)
    dq_p = flash_dq_reference(*f, lse, coeff, scale)
    dk_p, dv_p = flash_dkv_reference(*f, lse, coeff, scale)
    if q.dtype == torch.float32:
        scales = {n: x.abs().max().item() for n, x in
                  (("out", out_p), ("dq", dq_p), ("dk", dk_p), ("dv", dv_p))}
        rel = {"out": 1e-5, "dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
    else:
        scales = abs_term_sums(*f, lse, coeff, scale)
        rel = dict.fromkeys(scales, 2.0 ** -7)
    errs = {"lse": ((lse - lse_p).abs().max().item(), 1e-5)}
    for name, got, want in (("out", out, out_p), ("dq", dq, dq_p), ("dk", dk, dk_p),
                            ("dv", dv, dv_p)):
        errs[name] = ((got.float() - want).abs().max().item(), rel[name] * scales[name] + 1e-6)
    return errs


@pytest.mark.parametrize(
    "b,h,s,d,dtype",
    [(8, 12, 197, 64, torch.bfloat16), (8, 12, 197, 64, torch.float32),
     (2, 3, 145, 64, torch.float32), (1, 2, 1000, 32, torch.float32),
     (2, 2, 65, 128, torch.float32), (2, 2, 65, 128, torch.bfloat16),
     # the bf16 tensor-core kernels' edges: one partial 16-row chunk, a
     # tail of 1, many ring stages with a masked tail, no tail, D = 128
     (2, 3, 1, 64, torch.bfloat16), (2, 3, 17, 64, torch.bfloat16),
     (1, 2, 1000, 32, torch.bfloat16), (2, 2, 64, 64, torch.bfloat16),
     (2, 2, 197, 128, torch.bfloat16),
     # B*H = 70000 heads, past the 65535 a grid's second dimension holds
     (35000, 2, 8, 32, torch.bfloat16), (35000, 2, 8, 32, torch.float32)],
)
def test_flash_kernels_match_plain(cuda, b, h, s, d, dtype):
    """The three flash-attention kernels against their plain versions, with
    a non-zero lse cotangent, any S (1 and 17 inside one 16-row chunk, 65 <
    the TPU tile, 64 without a tail, 197 and 1000 with a masked tail), each
    head width, and B*H beyond 65535 (the grid is one-dimensional)."""
    gen = torch.Generator(device=cuda).manual_seed(b * s + d)
    before = (flash_forward.launches, flash_dq.launches, flash_dkv.launches)
    errs = flash_errors(*_flash_inputs(b, h, s, d, dtype, gen, cuda))
    assert (flash_forward.launches, flash_dq.launches, flash_dkv.launches) == tuple(
        n + 1 for n in before)
    for name, (err, tol) in errs.items():
        assert err <= tol, (name, err, tol)


def test_flash_wrappers_launch_the_kernel_of_their_dtype(cuda):
    """bf16 goes through the three tensor-core kernels (forward, dq, dk/dv:
    `flash_*_mma_kernel`), f32 through the three CUDA-core ones: the
    wrappers' counts by kernel and the kernel names torch.profiler sees on
    the card agree."""
    from torch.profiler import ProfilerActivity, profile

    wrappers = (flash_forward, flash_dq, flash_dkv)
    entry = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
    gen = torch.Generator(device=cuda).manual_seed(7)
    expected = {torch.bfloat16: {"flash_fwd_mma_kernel", "flash_dq_mma_kernel",
                                 "flash_dkv_mma_kernel"},
                torch.float32: {"flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel"}}
    for dtype in (torch.bfloat16, torch.float32):
        want = {KERNELS[(e, dtype)] for e in entry}
        assert want == expected[dtype]
        before = [dict(w.kernel_launches) for w in wrappers]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_errors(*_flash_inputs(1, 2, 70, 64, dtype, gen, cuda))
            torch.cuda.synchronize()
        launched = {name for w, b in zip(wrappers, before)
                    for name, n in w.kernel_launches.items() if n > b[name]}
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        # no kernel name is a substring of another (flash_fwd_kernel vs flash_fwd_mma_kernel)
        ran = {k for k in KERNELS.values() if any(k in n for n in names)}
        assert launched == want and ran == want, (dtype, launched, names)


def test_v3_step_launches_the_flash_kernels(cuda):
    """One v3 step of vit_tiny (4 blocks) at 32 px, patch 4 (65 tokens), bf16
    autocast: the forward kernel runs once per block in each encoder (8),
    dq and dk/dv once per block of the query encoder (4 each); the loss is
    finite and the frozen patch embedding does not move."""
    cfg = TrainConfig(
        moco=MocoConfig(arch="vit_tiny", dim=16, num_negatives=0, momentum=0.99, temperature=0.2,
                        v3=True, momentum_cos=True, vit_flash_attention=True, vit_patch_size=4),
        optim=OptimConfig(optimizer="adamw", lr=1e-3, weight_decay=0.1, epochs=2, cos=True),
        data=DataConfig(image_size=32, global_batch=8))
    state = create_state(cfg, build_encoder(cfg.moco, mlp_hidden=64), device=cuda,
                         predictor=build_predictor(cfg.moco, mlp_hidden=64))
    patch = state.encoder_q.backbone.patch_embed.weight.detach().clone()
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = {v: torch.randn((8, 32, 32, 3), generator=gen, device=cuda) for v in ("im_q", "im_k")}
    before = (flash_forward.launches, flash_dq.launches, flash_dkv.launches)
    out = make_train_step(cfg, 1, device=cuda)(state, batch)
    torch.cuda.synchronize()
    launched = tuple(n - b for n, b in zip(
        (flash_forward.launches, flash_dq.launches, flash_dkv.launches), before))
    assert launched == (8, 4, 4) and torch.isfinite(out["loss"]).item()
    assert torch.equal(state.encoder_q.backbone.patch_embed.weight, patch)


def test_flash_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(ValueError, match="D in"):
        flash_forward(torch.zeros(1, 2, 8, 48, device=cuda), x[..., :48].contiguous(),
                      x[..., :48].contiguous(), 1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        flash_forward(x.half(), x.half(), x.half(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_forward(x.transpose(1, 2), x.transpose(1, 2), x.transpose(1, 2), 1.0)
    with pytest.raises(ValueError, match="several devices"):
        flash_forward(x, x.cpu(), x, 1.0)
    with pytest.raises(ValueError, match="must be torch.float32"):
        flash_dq(x, x, x, x, torch.zeros(1, 2, 8, device=cuda, dtype=torch.bfloat16),
                 torch.zeros(1, 2, 8, device=cuda), 1.0)


def test_infonce_query_rows_come_from_the_kernels_library(cuda):
    """The split plan's query rows per CTA, read from csrc/infonce.cu: whole
    m16 tiles for every C the kernels take, at least as many in the forward
    (two tiles per warp) as in the backward; other C refused."""
    for c in range(1, MAX_C + 1):
        fwd, bwd = query_rows(c, forward=True), query_rows(c, forward=False)
        assert fwd % 16 == 0 and bwd % 16 == 0 and fwd >= bwd > 0, (c, fwd, bwd)
    for c in (0, MAX_C + 1):
        with pytest.raises(ValueError, match="C <="):
            query_rows(c, forward=True)


def test_infonce_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(4, MAX_C + 4, device=cuda)
    with pytest.raises(ValueError, match="C <="):
        infonce_stats(q, q, torch.zeros(64, MAX_C + 4, device=cuda), 0.2)
    with pytest.raises(TypeError, match="float32"):
        infonce_stats(q[:, :8].double(), q[:, :8].double(), torch.zeros(64, 8, device=cuda), 0.2)
    with pytest.raises(ValueError, match="K > 0"):
        infonce_stats(q[:, :8].contiguous(), q[:, :8].contiguous(), torch.zeros(0, 8, device=cuda), 0.2)
