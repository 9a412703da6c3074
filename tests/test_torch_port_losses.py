"""Port: the training slice's losses, SDF and degradation against the JAX
package, on the CPU in float32, inputs from a numpy seed.

Tolerances: the losses, pseudo-LR, oriented weights and degradation to
rtol 1e-5 (atol 1e-6): the same float32 math summed in another order. The
SDFs and the Gaussian kernel builder to 1e-6: their arithmetic is the JAX
package's, step for step (the EDT's integer squares are exact). Masks are
NCHW here and NHWC in the JAX package.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from csbsr_tpu import losses as jl
from csbsr_tpu.ops import blur as jblur
from csbsr_tpu.ops.edt import sdf_normalized as jax_sdf, signed_distance_map as jax_sdm
from csbsr_tpu_torch import losses as tl
from csbsr_tpu_torch.ops import blur as tblur
from csbsr_tpu_torch.ops.edt import sdf_normalized, signed_distance_map

RTOL, ATOL = 1e-5, 1e-6


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
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def _masks(b=4, hw=24, seed=0):
    """(B, H, W, 1) crack-like binary masks; sample 0 is empty, sample 1 full."""
    rng = np.random.RandomState(seed)
    m = np.zeros((b, hw, hw, 1), np.float32)
    for i in range(2, b):
        for _ in range(3):
            r, c = rng.randint(0, hw, 2)
            dr, dc = rng.choice([-1, 0, 1], 2)
            for _ in range(hw):
                m[i, r % hw, max(c, 0) % hw, 0] = 1.0
                m[i, (r + 1) % hw, max(c, 0) % hw, 0] = 1.0
                r, c = r + dr, c + dc + rng.randint(-1, 2)
    m[1] = 1.0
    return m


def _preds(shape, seed=1):
    """Probabilities in (0, 1) with some saturated exactly to 0 and to 1."""
    rng = np.random.RandomState(seed)
    p = rng.rand(*shape).astype(np.float32)
    p.flat[::17] = 1.0
    p.flat[::23] = 0.0
    return p


SEG_LOSSES = {
    "weighted_bce": (lambda p, t: jl.weighted_bce(p, t, (20, 1)),
                     lambda p, t: tl.weighted_bce(p, t, (20, 1))),
    "weighted_bce_map": (lambda p, t: jl.weighted_bce(p, t, (1, 1), per_pixel=True),
                         lambda p, t: tl.weighted_bce(p, t, (1, 1), per_pixel=True)),
    "binary_dice": (jl.binary_dice, tl.binary_dice),
    "binary_dice_map": (lambda p, t: jl.binary_dice(p, t, per_pixel=True),
                        lambda p, t: tl.binary_dice(p, t, per_pixel=True)),
    "generalized_dice": (jl.generalized_dice, tl.generalized_dice),
    "bce_dice": (lambda p, t: jl.bce_dice(p, t, (20, 1), (1, 2)),
                 lambda p, t: tl.bce_dice(p, t, (20, 1), (1, 2))),
    "boundary": (jl.boundary_loss, tl.boundary_loss),
    "boundary_map": (lambda p, t: jl.boundary_loss(p, t, per_pixel=True),
                     lambda p, t: tl.boundary_loss(p, t, per_pixel=True)),
    "boundary_combo": (lambda p, t: jl.boundary_combo_loss(p, t, 0.7, (1, 1), (1, 1)),
                       lambda p, t: tl.boundary_combo_loss(p, t, 0.7, (1, 1), (1, 1))),
    "boundary_combo_paired": (
        lambda p, t: jl.boundary_combo_loss(p, t, 0.6, (2, 1), (1, 3), per_pixel=True)[0],
        lambda p, t: tl.boundary_combo_loss(p, t, 0.6, (2, 1), (1, 3), per_pixel=True)[0]),
    "boundary_combo_cross": (
        lambda p, t: jl.boundary_combo_loss(p, t, 0.6, (2, 1), (1, 3), per_pixel=True)[1],
        lambda p, t: tl.boundary_combo_loss(p, t, 0.6, (2, 1), (1, 3), per_pixel=True)[1]),
    "boundary_gdice": (lambda p, t: jl.boundary_gdice_loss(p, t, 0.4),
                       lambda p, t: tl.boundary_gdice_loss(p, t, 0.4)),
    "generalized_boundary_combo": (
        lambda p, t: jl.generalized_boundary_combo_loss(p, t, 0.3, (1, 1), (1, 1)),
        lambda p, t: tl.generalized_boundary_combo_loss(p, t, 0.3, (1, 1), (1, 1))),
    "bce": (jl.bce, tl.bce),
}


@pytest.mark.parametrize("name", sorted(SEG_LOSSES))
def test_seg_loss_equals_jax(name):
    jax_fn, port_fn = SEG_LOSSES[name]
    tgt = _masks()
    pred = _preds(tgt.shape)
    ref = np.asarray(jax_fn(jnp.asarray(pred), jnp.asarray(tgt)))
    ours = port_fn(_nchw(pred), _nchw(tgt))
    ours = _nhwc(ours) if ours.dim() == 4 else ours.numpy()
    assert ours.shape == ref.shape
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_weighted_bce_stays_finite_at_saturation():
    """The complement clip: p == 1.0 exactly with target 0 gives
    -log(1e-8 + 1e-8) / 2, not NaN."""
    loss = tl.weighted_bce(torch.ones(1, 1, 2, 2), torch.zeros(1, 1, 2, 2))
    np.testing.assert_allclose(loss.numpy(), [-np.log(2e-8) / 2], rtol=1e-6)


@pytest.mark.parametrize("jax_fn,port_fn", [(jax_sdf, sdf_normalized),
                                             (jax_sdm, signed_distance_map)])
def test_sdf_equals_jax_with_empty_and_full_masks(jax_fn, port_fn):
    m = _masks(b=5, hw=31, seed=2)[..., 0] > 0.5  # (B, H, W); 0 empty, 1 full
    ref = np.asarray(jax_fn(jnp.asarray(m)))
    ours = port_fn(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    assert not ours[0].any()  # an empty slice is zero


def test_sdf_has_no_gradient_and_is_shared_by_the_boundary_loss():
    m = _nchw(_masks())
    sdf = tl.boundary_sdf(m)
    assert not sdf.requires_grad
    p = torch.rand(m.shape, requires_grad=True)
    loss = tl.boundary_combo_loss(p, m, 0.5, sdf=sdf).sum()
    loss.backward()
    np.testing.assert_allclose(
        tl.boundary_combo_loss(p.detach(), m, 0.5).numpy(),
        tl.boundary_combo_loss(p.detach(), m, 0.5, sdf=sdf).numpy(), rtol=0, atol=0)


def _sr_inputs(b=3, hw=32, k=7, seed=3):
    rng = np.random.RandomState(seed)
    hr_pred = rng.rand(b, hw, hw, 3).astype(np.float32)
    hr = rng.rand(b, hw, hw, 3).astype(np.float32)
    lr = rng.rand(b, hw // 4, hw // 4, 3).astype(np.float32)
    kvec = rng.rand(b, k * k).astype(np.float32) + 0.1
    gt_k = rng.rand(b, k, k).astype(np.float32)
    gt_k /= gt_k.sum(axis=(1, 2), keepdims=True)
    return hr_pred, hr, lr, kvec, gt_k


def test_get_pseudo_lr_equals_jax():
    hr_pred, _, _, kvec, _ = _sr_inputs()
    lr_j, k_j = jl.get_pseudo_lr(jnp.asarray(hr_pred), jnp.asarray(kvec), 7, 4)
    lr_t, k_t = tl.get_pseudo_lr(_nchw(hr_pred), torch.from_numpy(kvec), 7, 4)
    np.testing.assert_allclose(_nhwc(lr_t), np.asarray(lr_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weights,only_kernel", [
    ((0.4, 0.4, 0, 2), None),  # the recipes' typo'd default: kernel-MSE weight 0
    ((0.4, 0.4, 0.2), False),
    ((0.4, 0.4, 0.2), True),  # inside the kernel window: the kernel MSE alone
])
def test_kbpn_loss_equals_jax(weights, only_kernel):
    hr_pred, hr, lr, kvec, gt_k = _sr_inputs()
    kw = dict(ksize=7, scale_factor=4, weights=weights, only_kernel_loss_in_window=only_kernel)
    ref, k_j = jl.kbpn_loss(jnp.asarray(hr_pred), jnp.asarray(hr), jnp.asarray(lr),
                            jnp.asarray(kvec), jnp.asarray(gt_k), 5, **kw)
    ours, k_t = tl.kbpn_loss(_nchw(hr_pred), _nchw(hr), _nchw(lr), torch.from_numpy(kvec),
                             torch.from_numpy(gt_k), 5, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("variant", ["exp", "linear"])
def test_kbpn_loss_with_oriented_weights_equals_jax(variant):
    hr_pred, hr, lr, kvec, gt_k = _sr_inputs()
    seg_t = _masks(b=3, hw=32, seed=4)
    seg_p = _preds(seg_t.shape, seed=5)
    kw = dict(ksize=7, scale_factor=4, weights=(0.4, 0.4, 0.2), co_amp=0.5, sfo_amp=2.0,
              co_bias=1.0, sfo_bias=0.5, weight_iter=3, weight_variant=variant)
    ref, _ = jl.kbpn_loss(jnp.asarray(hr_pred), jnp.asarray(hr), jnp.asarray(lr),
                          jnp.asarray(kvec), jnp.asarray(gt_k), 5,
                          segment_preds=jnp.asarray(seg_p), segment_targets=jnp.asarray(seg_t),
                          **kw)
    ours, _ = tl.kbpn_loss(_nchw(hr_pred), _nchw(hr), _nchw(lr), torch.from_numpy(kvec),
                           torch.from_numpy(gt_k), 5, segment_preds=_nchw(seg_p),
                           segment_targets=_nchw(seg_t), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["crack_exp", "crack_linear", "failure_exp", "failure_linear"])
def test_oriented_weights_equal_jax(name):
    gt = _masks(b=3, hw=20, seed=6)
    pred = _preds(gt.shape, seed=7)
    fn = {
        "crack_exp": lambda p, t, m: m.crack_oriented_exp_weight(t, 0.7),
        "crack_linear": lambda p, t, m: m.crack_oriented_weight(t, 2.0, 1.0, 7, 2.0),
        "failure_exp": lambda p, t, m: m.segment_failure_oriented_exp_weight(p, t, 3.0),
        "failure_linear": lambda p, t, m: m.segment_failure_oriented_weight(p, t, 2.0, 0.5),
    }[name]
    ref = np.asarray(fn(jnp.asarray(pred), jnp.asarray(gt), jl))
    ours = _nhwc(fn(_nchw(pred), _nchw(gt), tl))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("size,sigma_range2,isotropic", [
    (21, None, False), (21, (0.5, 2.0), False), (7, None, True), (21, None, True)])
def test_gaussian_builder_equals_jax_on_its_draws(size, sigma_range2, isotropic):
    key, batch, sigma_range = jax.random.PRNGKey(11), 16, (0.2, 4.0)
    ref = np.asarray(jblur.gaussian_kernels(key, batch, size, sigma_range, sigma_range2,
                                            isotropic=isotropic))
    # the uniform draws the JAX sampler takes from this key
    u = [torch.from_numpy(np.array(jax.random.uniform(k, (batch,))))
         for k in jax.random.split(key, 3)]
    params = tblur.gaussian_params(*u, sigma_range, sigma_range2, isotropic=isotropic)
    ours = tblur.gaussian_kernels_from(*params, size=size).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_sampled_kernels_stay_in_range_and_sum_to_one():
    n, size = 2000, 21
    gen = torch.Generator().manual_seed(3)
    kernels = tblur.make_kernel_sampler("gaus", size, (0.2, 4.0))(gen, n)
    assert kernels.shape == (n, size, size) and bool((kernels >= 0).all())
    np.testing.assert_allclose(kernels.sum(dim=(1, 2)).numpy(), 1.0, rtol=0, atol=1e-5)
    # the same draws, seen through the parameter map: ranges and U[a, b] moments
    u = torch.rand((3, n), generator=torch.Generator().manual_seed(3))
    theta, sx, sy = tblur.gaussian_params(u[0], u[1], u[2], (0.2, 4.0))
    assert torch.equal(kernels, tblur.gaussian_kernels_from(theta, sx, sy, size))
    assert 0.0 <= float(theta.min()) and float(theta.max()) < np.pi
    for s in (sx, sy):
        assert 0.2 <= float(s.min()) and float(s.max()) <= 4.0
        # U[0.2, 4]: mean 2.1, sd 1.097; the mean of 2000 within 4 standard errors
        assert abs(float(s.mean()) - 2.1) < 4 * 1.097 / np.sqrt(n)
    assert abs(float(theta.mean()) - np.pi / 2) < 4 * (np.pi / np.sqrt(12)) / np.sqrt(n)


@pytest.mark.parametrize("mode", ["disk", "motion", "all_rand", "gaus-motion"])
def test_unported_blur_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tblur.make_kernel_sampler(mode)


@pytest.mark.parametrize("k,hw", [(21, (48, 40)), (7, (32, 32))])
def test_degrade_equals_jax(k, hw):
    rng = np.random.RandomState(8)
    hr = rng.rand(3, *hw, 3).astype(np.float32)
    kern = rng.rand(3, k, k).astype(np.float32)
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    ref = np.asarray(jblur.degrade(jnp.asarray(hr), jnp.asarray(kern), 4, "bicubic"))
    ours = _nhwc(tblur.degrade(_nchw(hr), torch.from_numpy(kern), 4, "bicubic"))
    assert ours.shape == ref.shape == (3, hw[0] // 4, hw[1] // 4, 3)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)


def test_identity_kernels_leave_the_image_to_the_resize():
    hr = torch.rand(2, 3, 16, 16)
    k = tblur.identity_kernels(2, 7)
    assert torch.equal(k.sum(dim=(1, 2)), torch.ones(2)) and float(k[0, 3, 3]) == 1.0
    np.testing.assert_allclose(tblur.degrade(hr, k).numpy(),
                               torch.nn.functional.interpolate(hr, size=(4, 4), mode="bicubic",
                                                               align_corners=False).numpy(),
                               rtol=RTOL, atol=ATOL)
