"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where no CUDA device is visible (the
decision is made inside the fixture, never at import). Run on a machine
with an H100 and the CUDA toolkit:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

(`--noconftest`: tests/conftest.py sets up JAX, which such a machine
need not have.)

Tolerance: max |kernel - plain| <= 1e-5 on unit-norm f32 rows (FMA order
over d differs between the kernel's warp reduction and cuBLAS).
"""

import pytest
import torch

from moco_tpu_torch.ops.ivf_scan import fused_cell_scores, fused_cell_scores_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _unit(shape, gen, device):
    x = torch.randn(shape, generator=gen, device=device)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize(
    "m,d,nlist,cell_cap,nprobe",
    [(1, 128, 256, 512, 16), (128, 128, 256, 512, 16), (7, 16, 8, 37, 4), (5, 132, 4, 9, 3)],
)
def test_cell_scores_kernel_matches_plain(cuda, m, d, nlist, cell_cap, nprobe):
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    q = _unit((m, d), gen, cuda)
    cell_rows = _unit((nlist, cell_cap, d), gen, cuda)
    probes = torch.randint(0, nlist, (m, nprobe), generator=gen, device=cuda, dtype=torch.int32)
    before = fused_cell_scores.launches
    got = fused_cell_scores(q, cell_rows, probes)
    torch.cuda.synchronize()
    assert fused_cell_scores.launches == before + 1
    want = fused_cell_scores_reference(q, cell_rows, probes)
    assert (got - want).abs().max().item() <= 1e-5


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
