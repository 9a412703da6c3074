"""Port: resize, batch_blur and patching against the JAX package.

Inputs come from a numpy seed; the port works in NCHW, the JAX package in
NHWC. Tolerance 1e-5 (float32; the two compute the same weights in another
summation order).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from csbsr_tpu.ops.blur import batch_blur as jax_blur
from csbsr_tpu.ops.patch import joint_patch as jax_joint, split_patch as jax_split
from csbsr_tpu.ops.resize import adaptive_avg_pool as jax_pool, resize as jax_resize
from csbsr_tpu_torch.ops.blur import batch_blur
from csbsr_tpu_torch.ops.patch import joint_patch, split_patch
from csbsr_tpu_torch.ops.resize import adaptive_avg_pool, resize

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


@pytest.mark.parametrize("hw_in,hw_out,method,align", [
    ((16, 16), (64, 64), "bicubic", False),  # the KBPN residual, x4 up
    ((7, 7), (21, 21), "bicubic", False),  # the predicted-kernel resize
    ((64, 52), (21, 17), "bicubic", False),  # down
    ((28, 28), (56, 56), "bilinear", False),  # PSPUpsample
    ((6, 6), (28, 28), "bilinear", False),  # pyramid prior
    ((33, 20), (10, 9), "bilinear", False),
    ((28, 28), (224, 224), "bilinear", True),  # aux head
    ((9, 13), (40, 31), "bilinear", True),
])
def test_resize_equals_jax(hw_in, hw_out, method, align):
    x = np.random.RandomState(0).rand(2, *hw_in, 3).astype(np.float32)
    ours = _nhwc(resize(_nchw(x), hw_out, method=method, align_corners=align))
    ref = np.asarray(jax_resize(jnp.asarray(x), hw_out, method=method, align_corners=align))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hw", [(28, 28), (7, 9)])
@pytest.mark.parametrize("size", [1, 2, 3, 6])
def test_adaptive_avg_pool_equals_jax(hw, size):
    x = np.random.RandomState(1).rand(2, *hw, 4).astype(np.float32)
    ours = _nhwc(adaptive_avg_pool(_nchw(x), (size, size)))
    ref = np.asarray(jax_pool(jnp.asarray(x), (size, size)))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("stride,k,hw", [(1, 21, (37, 45)), (1, 7, (30, 29)),
                                         (4, 21, (61, 70)), (4, 7, (58, 49))])
def test_batch_blur_equals_jax(stride, k, hw):
    rng = np.random.RandomState(2)
    x = rng.rand(3, *hw, 3).astype(np.float32)
    kern = rng.rand(3, k, k).astype(np.float32)
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    ours = _nhwc(batch_blur(_nchw(x), torch.from_numpy(kern), stride=stride))
    ref = np.asarray(jax_blur(jnp.asarray(x), jnp.asarray(kern), stride=stride))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_split_joint_patch_roundtrip_and_equal_to_jax():
    img = np.random.RandomState(3).rand(50, 37, 3).astype(np.float32)  # remainders dropped
    patches, ushape = split_patch(np.transpose(img, (2, 0, 1)), 16, 12)
    jp, jshape = jax_split(jnp.asarray(img), 16, 12)
    assert np.array_equal(ushape, np.asarray(jshape))
    assert np.array_equal(np.transpose(patches, (0, 2, 3, 1)), np.asarray(jp))
    joined = joint_patch(torch.from_numpy(np.ascontiguousarray(patches)), ushape)
    assert np.array_equal(_nhwc(joined), np.asarray(jax_joint(jp, jshape)))
    assert np.array_equal(_nhwc(joined)[0], img[:48, :36])
    # torch input, SR-scaled patch entries (as the inference harness uses them)
    tp, tshape = split_patch(torch.from_numpy(np.transpose(img, (2, 0, 1)).copy()), 16, 12)
    assert torch.equal(tp, torch.from_numpy(patches))
    up = torch.from_numpy(np.repeat(np.repeat(patches, 4, axis=2), 4, axis=3))
    tshape[[5, 6]] *= 4
    assert tuple(joint_patch(up, tshape).shape) == (1, 3, 192, 144)
