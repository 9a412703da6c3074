"""Port: PSNR, SSIM, IoU over thresholds and the device HD/MSD bank against
the JAX package, on inputs from a numpy seed.

Tolerances: 1e-5 for PSNR/SSIM/IoU (float32 sums in another order); 1e-4
for the HD/MSD bank: the EDTs agree bit for bit, and the area-weighted
means are sums in another order.

Ties of the robust percentile: where the weighted CDF of the distances
reaches the target exactly at some distance d (contour weights are 1,
sqrt(2)/2 and sqrt(2), so at the 50th percentile this is common), both
packages sum the CDF in float32, as the JAX package does, but in another
order, so either may round to d or to the next distance of the set. So
where the two HD values differ, the check requires a tie there and both
values among the two answers that the percentile's definition allows up to
that rounding, computed here in numpy float64 from the same EDT maps.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy import ndimage

from csbsr_tpu.metrics import device_metrics as jdm
from csbsr_tpu.metrics.device_surface import distance_metrics_banked as jax_banked
from csbsr_tpu_torch.metrics.device_metrics import iou_thresholds, psnr, ssim
from csbsr_tpu_torch.metrics.device_surface import _codes, _contour_length_table, \
    distance_metrics_banked
from csbsr_tpu_torch.ops.edt import edt
from csbsr_tpu_torch.ops.minplus import minplus_rows_reference

TH = np.array([i * 0.01 for i in range(1, 100)], np.float32)


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


def test_psnr_ssim_equal_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(3, 40, 52, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(psnr(_nchw(a), _nchw(b)).numpy(),
                               np.asarray(jdm.psnr(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    np.testing.assert_allclose(ssim(_nchw(a), _nchw(b)).numpy(),
                               np.asarray(jdm.ssim(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-5)


def test_iou_thresholds_equal_jax():
    rng = np.random.RandomState(1)
    out = rng.rand(2, 33, 41, 1).astype(np.float32)
    tgt = (rng.rand(2, 33, 41, 1) > 0.7).astype(np.float32)
    ours = iou_thresholds(_nchw(out), _nchw(tgt), torch.from_numpy(TH)).numpy()
    ref = np.asarray(jdm.iou_thresholds(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(TH)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def _field(rng, h, w, sigma):
    f = ndimage.gaussian_filter(rng.rand(h, w), sigma)
    return ((f - f.min()) / (f.max() - f.min() + 1e-9)).astype(np.float32)


def _cases():
    """(prob (B, H, W), gt (B, H, W)) banks: blobs, an empty GT, an all-low
    prediction (empty at every threshold), both empty, edge-touching
    objects."""
    rng = np.random.RandomState(2)
    h, w = 48, 56
    prob = np.stack([_field(rng, h, w, 3) for _ in range(2)])
    gt = np.stack([_field(rng, h, w, 4) > 0.6 for _ in range(2)])
    yield "blobs", prob, gt
    yield "gt_empty", prob[:1], np.zeros((1, h, w), bool)
    yield "pred_empty", np.zeros((1, h, w), np.float32), gt[:1]
    yield "both_empty", np.zeros((1, h, w), np.float32), np.zeros((1, h, w), bool)
    edge_gt = np.zeros((1, h, w), bool)
    edge_gt[0, :, :5] = True  # touches three borders
    edge_gt[0, 20:30, w - 3:] = True
    edge_prob = np.zeros((1, h, w), np.float32)
    edge_prob[0, :10, :] = np.linspace(0, 1, w)[None]
    edge_prob[0, 40:, w - 8:] = 0.7
    yield "edge", edge_prob, edge_gt


def _percentile_answers(dist, weight, frac):
    """The distances the weighted percentile may return: the exact one, and
    the next one of the set when the CDF meets the target to within float32
    rounding (a tie)."""
    keep = weight > 0
    d, w = dist[keep].astype(np.float64), weight[keep].astype(np.float64)
    order = np.argsort(d, kind="stable")
    d, cdf = d[order], np.cumsum(w[order])
    target = frac * w.sum()
    k = int(np.searchsorted(cdf, target * (1 - 1e-12), side="left"))
    answers = {d[k]}
    if abs(cdf[k] - target) <= 1e-6 * w.sum():
        later = d[d > d[k]]
        if later.size:
            answers.add(later.min())
    return answers


def _hd_answers(prob, gt, th, frac=0.5):
    """Per (image, threshold): the set of admissible HD values, from the
    port's own codes and EDT maps (bit-equal to the JAX package's)."""
    table = torch.as_tensor(_contour_length_table(), dtype=torch.float32)
    out = []
    for p_img, g_img in zip(prob, gt):
        w_g, b_g = _codes(torch.from_numpy(g_img), table)
        d_g = edt(b_g).numpy()
        row = []
        for t in th:
            w_p, b_p = _codes(torch.from_numpy(p_img > t), table)
            if not b_p.any() or not b_g.any():
                row.append(None)
                continue
            d_p = edt(b_p).numpy()
            a = _percentile_answers(d_p, w_g.numpy(), frac)
            b = _percentile_answers(d_g, w_p.numpy(), frac)
            row.append({max(x, y) for x in a for y in b})
        out.append(row)
    return out


@pytest.mark.parametrize("name,prob,gt", list(_cases()), ids=[c[0] for c in _cases()])
def test_distance_bank_equals_jax(name, prob, gt):
    ours = distance_metrics_banked(torch.from_numpy(prob), torch.from_numpy(gt),
                                   torch.from_numpy(TH), max_len=60.0)
    ref = jax_banked(jnp.asarray(prob), jnp.asarray(gt), jnp.asarray(TH),
                     max_len=jnp.float32(60.0))
    assert ours[0].shape == ours[1].shape == (prob.shape[0], len(TH))
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]), rtol=1e-4, atol=1e-4)
    hd, hd_jax = ours[0].numpy(), np.asarray(ref[0])
    answers = _hd_answers(prob, gt, TH)
    for i, j in zip(*np.nonzero(~np.isclose(hd, hd_jax, rtol=1e-4, atol=1e-4))):
        ok = answers[i][j]
        assert ok is not None and len(ok) == 2, (name, i, j, hd[i, j], hd_jax[i, j])
        assert any(abs(hd[i, j] - a) <= 1e-4 for a in ok)
        assert any(abs(hd_jax[i, j] - a) <= 1e-4 for a in ok)
    # away from ties, both return the one admissible answer
    for i, row in enumerate(answers):
        for j, ok in enumerate(row):
            if ok is not None and len(ok) == 1:
                assert abs(hd[i, j] - min(ok)) <= 1e-4, (name, i, j, hd[i, j], ok)
    if name == "both_empty":
        assert float(ours[0].abs().max()) == 0.0 and float(ours[1].abs().max()) == 0.0
    if name in ("gt_empty", "pred_empty"):
        assert float(ours[0].min()) == 60.0


def test_distance_bank_row_pass_is_pluggable():
    """The plain row pass gives the same bank (the check chip_smoke.py makes
    on the card against the kernel)."""
    _, prob, gt = next(_cases())
    th = torch.from_numpy(TH)
    a = distance_metrics_banked(torch.from_numpy(prob), torch.from_numpy(gt), th)
    b = distance_metrics_banked(torch.from_numpy(prob), torch.from_numpy(gt), th,
                                row_pass=minplus_rows_reference)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
