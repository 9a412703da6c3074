"""Port: the CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA GPU. The file imports neither JAX nor the JAX package,
so on the card's machine it runs without them:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -q

Tolerance: exact (`torch.equal`); see csbsr_tpu_torch/ops/minplus.py.
"""
import pytest
import torch

from csbsr_tpu_torch.ops import cuda_build
from csbsr_tpu_torch.ops.edt import _column_distance
from csbsr_tpu_torch.ops.minplus import minplus_rows, minplus_rows_reference


@pytest.mark.gpu
@pytest.mark.parametrize("shape,empty", [
    ((2, 1, 33, 47), False), ((3, 128, 128), False), ((2, 33, 2100), False),
    ((1, 40, 50), True), ((99, 449, 449), False),
])
def test_minplus_kernel_equals_plain_version_on_cuda(shape, empty):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the min-plus kernel runs only on the card")
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.rand(shape, generator=gen, device="cuda") < (0.0 if empty else 0.03)
    g = _column_distance(mask).contiguous()
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
