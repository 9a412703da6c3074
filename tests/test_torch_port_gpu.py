"""Port: the CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA GPU. The file imports neither JAX nor the JAX package,
so on the card's machine it runs without them:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -q

Tolerance: exact (`torch.equal`); see csbsr_tpu_torch/ops/minplus.py.
The shapes are the main paths' ((99, 449, 449) the HD bank, (1, 449, 449)
its GT border, (6, 1, 224, 224) the training SDF) and the edges of the
kernel's launch plan: one row, ragged row and column groups, k split over
the block's warps, the widest row (2896), all-empty slices (the 1e9 cap).
"""
import pytest
import torch

from csbsr_tpu_torch.ops import cuda_build
from csbsr_tpu_torch.ops.edt import _column_distance
from csbsr_tpu_torch.ops.minplus import MAX_W, minplus_rows, minplus_rows_reference


def _column_pass(shape, density, seed=5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _column_distance(torch.rand(shape, generator=gen, device="cuda") < density).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,empty", [
    ((2, 1, 33, 47), False), ((3, 128, 128), False), ((2, 33, 2100), False),
    ((1, 40, 50), True), ((99, 449, 449), False), ((1, 449, 449), False),
    ((6, 1, 224, 224), False), ((6, 1, 224, 224), True), ((1, 1, 1), False), ((7, 31), False),
    ((9, 33), False), ((3, 2896), False), ((64, 2896), False), ((2, 5, 2896), True),
])
def test_minplus_kernel_equals_plain_version_on_cuda(shape, empty):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the min-plus kernel runs only on the card")
    g = _column_pass(shape, 0.0 if empty else 0.03)
    n = cuda_build.LAUNCHES["minplus_rows"]
    out = minplus_rows(g)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["minplus_rows"] == n + 1
    assert torch.equal(out, minplus_rows_reference(g))


@pytest.mark.gpu
def test_minplus_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the checks guard the kernel launch")
    g = torch.rand(4, 8, 9, device="cuda")
    with pytest.raises(TypeError):
        minplus_rows(g.double())
    with pytest.raises(ValueError):
        minplus_rows(g.transpose(-1, -2))
    with pytest.raises(ValueError):
        minplus_rows(g[0, 0])
    with pytest.raises(ValueError):
        minplus_rows(torch.rand(2, MAX_W + 1, device="cuda"))

