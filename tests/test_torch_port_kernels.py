"""Port: the min-plus EDT row pass and the EDT against the JAX package.

Tolerance: exact. Every term of the row pass is an integer below 2**24 (or
the 1e9 cap of an empty slice), so the plain PyTorch version, the JAX XLA
path, the Pallas kernel in interpret mode and the CUDA kernel must agree bit
for bit. The Pallas kernel caps empty slices at 1e18 instead of 1e9, so it is
compared on non-empty slices only.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy import ndimage

from csbsr_tpu.ops.edt import _min_plus_rows, _scan_1d_distance, edt as jax_edt
from csbsr_tpu.ops.edt import find_boundaries_inner as jax_fbi
from csbsr_tpu.ops.pallas.minplus import minplus_rows_pallas
from csbsr_tpu_torch.ops import cuda_build
from csbsr_tpu_torch.ops.edt import edt, find_boundaries_inner
from csbsr_tpu_torch.ops.minplus import minplus_rows, minplus_rows_reference

SHAPES = [(2, 1, 33, 47), (3, 128, 128), (2, 33, 2100)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mask(shape, seed, empty=False):
    if empty:
        return np.zeros(shape, bool)
    return np.random.RandomState(seed).rand(*shape) > 0.97


def _g(mask):
    """Column-pass distances from the JAX package, as numpy."""
    return np.array(_scan_1d_distance(jnp.asarray(mask)))


@pytest.mark.parametrize("shape,empty", [(s, False) for s in SHAPES] + [((1, 40, 50), True)])
def test_minplus_reference_equals_jax_xla(shape, empty):
    g = _g(_mask(shape, 0, empty))
    ours = minplus_rows_reference(torch.from_numpy(g)).numpy()
    ref = np.asarray(_min_plus_rows(jnp.asarray(g)))
    assert np.array_equal(ours, ref)
    if empty:  # the 1e9 cap of the XLA path, not the Pallas kernel's 1e18
        assert np.all(ours == np.float32(1e9))


@pytest.mark.parametrize("shape", SHAPES)
def test_minplus_reference_equals_pallas_interpret(shape):
    g = _g(_mask(shape, 1))
    ours = minplus_rows_reference(torch.from_numpy(g)).numpy()
    ref = np.asarray(minplus_rows_pallas(jnp.asarray(g), interpret=True))
    assert np.array_equal(ours, ref)


def test_minplus_wrapper_on_cpu_runs_the_plain_version():
    g = torch.from_numpy(_g(_mask((2, 20, 30), 2)))
    before = dict(cuda_build.LAUNCHES)
    assert torch.equal(minplus_rows(g), minplus_rows_reference(g))
    assert dict(cuda_build.LAUNCHES) == before  # no kernel launch on the CPU


@pytest.mark.parametrize("shape,empty", [((2, 33, 47), False), ((3, 64, 80), False),
                                         ((1, 24, 24), True)])
def test_edt_equals_jax_and_scipy(shape, empty):
    mask = _mask(shape, 3, empty)
    ours = edt(torch.from_numpy(mask)).numpy()
    assert np.array_equal(ours, np.asarray(jax_edt(jnp.asarray(mask))))
    if not empty:
        ref = np.stack([ndimage.distance_transform_edt(~m) for m in mask.reshape(-1, *shape[-2:])])
        np.testing.assert_allclose(ours.reshape(ref.shape), ref, rtol=0, atol=1e-5)


def test_find_boundaries_inner_equals_jax():
    mask = np.random.RandomState(4).rand(2, 30, 41) > 0.5
    ours = find_boundaries_inner(torch.from_numpy(mask)).numpy()
    assert np.array_equal(ours, np.asarray(jax_fbi(jnp.asarray(mask))))


def test_kernel_library_is_named_by_source_hash_for_sm90a():
    path = cuda_build.library_path("minplus")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libminplus_")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
