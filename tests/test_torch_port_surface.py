"""Port: the rest of the training surface against the JAX package, on the
CPU, without a JAX model compile: CrackFormer's class-balanced BCE, the
disk / motion / compound blur kernels and the BLUR.MODE dispatch, the
photometric and RandomResizedCrop transforms (against OpenCV, which the
JAX package calls), the retinal, road and SR-pretrain train sets, SGD, the
SR-only, inverse and SR-less loss-glue branches, and the ImageNet-backbone
and SR `.pth` loads. Inputs come from numpy seeds.

Tolerances: the CrackFormer loss and the loss-glue branches in float64
(scoped `enable_x64`) to rtol 1e-12; blur kernels from the same parameters
atol 1e-6 in float32, the draw -> parameter maps exactly; flips, crops,
draws and datasets exactly; resize and HSV in float32 within 1e-3 on the
0-255 scale (uint8 resize within one level of OpenCV); SGD rtol 1e-6 in
float32; the weight loads exactly.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from csbsr_tpu.data import datasets as jax_datasets
from csbsr_tpu.data import transforms as jax_tf
from csbsr_tpu.engine.losses_glue import build_loss_fn as jax_build_loss_fn
from csbsr_tpu.engine.phase import compute_phase as jax_compute_phase
from csbsr_tpu.engine.phase import phase_config_from_cfg as jax_phase_config
from csbsr_tpu.losses import seg_losses as jax_seg_losses
from csbsr_tpu.ops import blur as jblur
from csbsr_tpu_torch.data import datasets as port_datasets
from csbsr_tpu_torch.data import transforms as port_tf
from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
from csbsr_tpu_torch.engine.train_state import (KERNEL, SEG, SR_CORE, MaskedSGD, grad_group_ids,
                                                group_multipliers, make_lr_schedule)
from csbsr_tpu_torch.losses import cross_entropy_loss_rcf
from csbsr_tpu_torch.ops import blur as tblur
from tests.test_torch_port_models import nchw
from tests.test_torch_port_train import NUM_TRAIN, WINDOWS
from tests.test_torch_port_zoo import narrow_hrnet, zoo_cfgs  # noqa: F401

SIZE = 21


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --------------------------------------------------------------------------
# CrackFormerLoss


@pytest.mark.parametrize("channels", [1, 5])
def test_cross_entropy_loss_rcf_equals_jax_float64(channels):
    rng = np.random.RandomState(channels)
    pred = rng.uniform(0.0, 1.0, (3, 12, 10, channels))
    pred[0, :2] = 0.0  # the clamp at both ends
    pred[1, :2] = 1.0
    label = np.broadcast_to((rng.rand(3, 12, 10, 1) > 0.8).astype(np.float64), pred.shape)
    label = label.copy()
    label[2] = 0.0  # no positives: beta 1
    with jax.enable_x64(True):
        ref = np.asarray(jax_seg_losses.cross_entropy_loss_rcf(jnp.asarray(pred),
                                                               jnp.asarray(label)))
    ours = cross_entropy_loss_rcf(nchw(pred), nchw(label)).numpy()
    assert ours.dtype == np.float64 and ours.shape == (3,)
    np.testing.assert_allclose(ours, ref, rtol=1e-12)


# --------------------------------------------------------------------------
# blur kernels


def _u(key, n):
    return np.asarray(jax.random.uniform(key, (n,)))


def _family_draws(name, key, n):
    """The uniform draws a JAX family makes from `key`, in the port's order."""
    if name == "disk":
        return [_u(key, n)]
    return [_u(k, n) for k in jax.random.split(key, 3)]  # gaus: theta, sx, sy; motion


def _mode_draws(mode, key, n):
    if mode == "all_rand":
        k_sel, k_m, k_g, k_d = jax.random.split(key, 4)
        rows = [_u(k_sel, n)] + _family_draws("motion", k_m, n) + \
            _family_draws("gaus", k_g, n) + _family_draws("disk", k_d, n)
    elif "-" in mode:
        (a, b), (ka, kb) = mode.split("-"), jax.random.split(key)
        rows = _family_draws(a, ka, n) + _family_draws(b, kb, n)
    else:
        rows = _family_draws(mode, key, n)
    return torch.from_numpy(np.stack(rows))


@pytest.mark.parametrize("mode", ["gaus", "disk", "motion", "all_rand", "gaus-disk",
                                  "disk-motion", "motion-gaus"])
def test_kernel_sampler_equals_jax_from_the_same_draws(mode):
    """The port's kernels from the uniform draws the JAX sampler makes from
    its key equal the JAX sampler's kernels: the draw -> parameter maps and
    the kernels together (ratio range (0.05, 1.0) reaches det's clamp at 1)."""
    n, rr = 64, (0.05, 1.0)
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jblur.make_kernel_sampler(mode, SIZE, (0.2, 4.0), None, rr)(key, n))
    u = _mode_draws(mode, key, n)
    assert u.shape == (tblur.draws_per_sample(mode), n)
    ours = tblur.kernels_from_draws(mode, u, SIZE, (0.2, 4.0), None, rr).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_draw_to_parameter_maps_are_exact():
    """disk_params and motion_params equal the JAX package's expressions
    (ops/blur.py:disk_kernels, motion_kernels) on the same draws, with even
    and odd dets, both parity draws and the clamps."""
    rng = np.random.RandomState(0)
    n, size, (a, b) = 4000, SIZE, (0.05, 1.0)
    u = rng.rand(3, n).astype(np.float32)
    u[1, :4] = [0.0, 0.999999, 0.5, 0.25]
    ju = jnp.asarray(u)
    det = jnp.round(size * (ju[1] * (b - a) + a))
    deg = 180.0 * ju[0]
    det_m = jnp.maximum(det, 1.0)
    bump = jnp.where(ju[2] < 0.5, -1.0, 1.0)  # jax.random.bernoulli(k, 0.5) is uniform < 0.5
    length = jnp.clip(jnp.where(jnp.mod(det_m, 2.0) == 0.0, det_m + bump, det_m), 1.0, size)
    t = torch.from_numpy(u)
    assert np.array_equal(tblur.disk_params(t[1], size, (a, b)).numpy(), np.asarray(det))
    deg_t, len_t = tblur.motion_params(t[0], t[1], t[2], size, (a, b))
    assert np.array_equal(deg_t.numpy(), np.asarray(deg))
    assert np.array_equal(len_t.numpy(), np.asarray(length))
    lengths = set(len_t.numpy().tolist())
    assert lengths <= set(range(1, size + 1, 2)) and {1.0, float(size)} <= lengths


@pytest.mark.parametrize("size", [21, 20])
def test_motion_and_disk_kernels_from_parameters_equal_jax(size):
    """All four quadrants (and their edges), odd lengths from 1 to the
    largest, an even kernel size; disks through det's clamp at 1."""
    deg = np.array([0.0, 10.0, 44.99, 45.0, 60.0, 89.99, 90.0, 100.0, 134.5, 135.0, 170.0,
                    179.99], np.float32)
    top = size if size % 2 else size - 1
    for length in sorted({1, 3, 5, 9, top - 2, top}):
        lens = np.full_like(deg, length)
        ref = np.asarray(jblur.motion_kernel_from(jnp.asarray(deg), jnp.asarray(lens), size))
        ours = tblur.motion_kernel_from(torch.from_numpy(deg), torch.from_numpy(lens), size)
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    det = np.array([-3.0, 0.0, 1.0, 2.0, 3.0, 8.0, 13.0, float(size), 2.0 * size], np.float32)
    ref = np.asarray(jblur.disk_kernel_from(jnp.asarray(det), size))
    np.testing.assert_allclose(tblur.disk_kernel_from(torch.from_numpy(det), size).numpy(), ref,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kb", [21, 7])
def test_kernel_compound_equals_jax(kb):
    rng = np.random.RandomState(kb)
    a = rng.rand(5, 21, 21).astype(np.float32) ** 3
    b = rng.rand(5, kb, kb).astype(np.float32) ** 3
    ref = np.asarray(jblur.kernel_compound(jnp.asarray(a), jnp.asarray(b)))
    ours = tblur.kernel_compound(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert ours.shape == (5, 21, 21)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_degrade_fn_reads_blur_mode_and_ratio_range():
    """make_degrade_fn builds BLUR.MODE's sampler with BLUR.RATIO_RANGE: its
    kernels are kernels_from_draws of the generator's draws."""
    from csbsr_tpu_torch.engine.trainer import make_degrade_fn

    cfg = zoo_cfgs("dbpn", extra=["BLUR.MODE", "disk-motion", "BLUR.RATIO_RANGE", [0.3, 0.6]])[1]
    lr, kernels = make_degrade_fn(cfg)(torch.rand(3, 3, 32, 32), torch.Generator().manual_seed(4))
    u = torch.rand((4, 3), generator=torch.Generator().manual_seed(4))
    assert lr.shape == (3, 3, 8, 8)
    assert torch.equal(kernels, tblur.kernels_from_draws("disk-motion", u, SIZE,
                                                         ratio_range=(0.3, 0.6)))


# --------------------------------------------------------------------------
# transforms


def _float_img(seed, h=20, w=24, scale=255.0):
    return (np.random.RandomState(seed).rand(h, w, 3) * scale).astype(np.float32)


def _both(make, img, mask, seed):
    """(port, JAX) outputs of one transform from the same RandomState seed,
    and whether both left the RandomState at the same point."""
    ra, rb = np.random.RandomState(seed), np.random.RandomState(seed)
    a = make(port_tf)(img.copy(), None if mask is None else mask.copy(), ra)
    b = make(jax_tf)(img.copy(), None if mask is None else mask.copy(), rb)
    return a, b, ra.randint(1 << 30) == rb.randint(1 << 30)


@pytest.mark.parametrize("name", ["RandomContrast", "RandomBrightness", "RandomSaturation",
                                  "RandomValue", "RandomHue", "RandomLightingNoise"])
def test_photometric_steps_draw_and_compute_like_jax(name):
    for seed in range(12):
        img = _float_img(seed, scale=1.0 if name in ("RandomSaturation", "RandomHue") else 255.0)
        (a, _), (b, _), same_draws = _both(lambda m: getattr(m, name)(), img, None, seed)
        assert same_draws and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pair", [("RGB", "HSV"), ("BGR", "HSV"), ("HSV", "RGB"), ("HSV", "BGR"),
                                  ("BGR", "RGB")])
def test_convert_color_equals_opencv(pair):
    """Float32 colour conversions as cv2.cvtColor computes them: H in
    degrees, S in [0, 1]; saturated, grey, negative and > 1 saturations."""
    rng = np.random.RandomState(1)
    if pair[0] == "HSV":
        img = np.stack([rng.uniform(0, 360, (16, 16)), rng.uniform(-0.2, 1.4, (16, 16)),
                        rng.uniform(0, 255, (16, 16))], -1).astype(np.float32)
        img[0, :, 1] = 0.0
    else:
        img = _float_img(2, 16, 16)
        img[0] = 77.0  # grey
        img[1, :, 0] = 255.0
    a, _ = port_tf.ConvertColor(*pair)(img.copy(), None)
    b, _ = jax_tf.ConvertColor(*pair)(img.copy(), None)
    assert a.shape == b.shape and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


def test_photometric_distort_chain_equals_jax():
    """The whole chain from the same seeds: both branch orders, every step
    on and off; the draws stay in step, the images within 1e-3."""
    worst = 0.0
    for seed in range(60):
        img = _float_img(100 + seed)
        (a, _), (b, _), same_draws = _both(lambda m: m.PhotometricDistort(), img, None, seed)
        assert same_draws
        worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= 1e-3, worst


@pytest.mark.parametrize("scale,ratio", [((1.0, 1.0), (1.0, 1.0)), ((0.5, 1.0), (0.75, 1.333)),
                                         ((0.05, 0.3), (0.2, 5.0))])
def test_random_resized_crop_equals_jax(scale, ratio):
    """The same draws and crop window (the mask is an index image, so its
    resized crop shows the window), the float32 resize within 1e-3."""
    h, w = 40, 30
    idx = np.arange(h * w, dtype=np.float32).reshape(h, w, 1)
    for seed in range(10):
        img = _float_img(seed, h, w)
        make = lambda m: m.RandomResizedCrop((24, 28), scale, ratio)
        (a, am), (b, bm), same_draws = _both(make, img, idx, seed)
        assert same_draws and a.shape == b.shape == (24, 28, 3) and am.shape == bm.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
        np.testing.assert_allclose(am, bm, rtol=0, atol=1e-3)


@pytest.mark.parametrize("hw,out", [((30, 28), (24, 24)), ((300, 200), (224, 224)),
                                    ((64, 64), (32, 32)), ((17, 33), (40, 20)),
                                    ((9, 13), (56, 56))])
def test_resize_linear_against_opencv(hw, out):
    """float32: within 1e-3 of cv2.resize INTER_LINEAR; uint8: within one
    level everywhere, and equal on these downscales (cv2's vectorised
    rounding; its scalar tail rounds once, which upscales reach)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.RandomState(hw[0])
    for c in (1, 3):
        img = (rng.rand(*hw, c) * 255).astype(np.float32)
        ref = cv2.resize(img, out[::-1], interpolation=cv2.INTER_LINEAR).reshape(*out, c)
        ours = port_tf.resize_linear(img, out)
        assert ours.dtype == np.float32 and ours.shape == (*out, c)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)
        u8 = img.astype(np.uint8)
        ref8 = cv2.resize(u8, out[::-1], interpolation=cv2.INTER_LINEAR).reshape(*out, c)
        diff = np.abs(port_tf.resize_linear(u8, out).astype(int) - ref8.astype(int))
        assert diff.max() <= (0 if out[0] <= hw[0] and out[1] <= hw[1] else 1)


def test_train_chain_with_photometric_and_resized_crop_equals_jax():
    """A config chain with RandomResizedCrop and PhotometricDistort (the
    card's blur_photometric variant's) through TrainTransforms, from the
    same seeds: within 1e-3 of the 0-255 scale after the /255."""
    chain = [["ConvertFromInts", None],
             ["RandomResizedCrop", {"scale": [0.5, 1.0], "ratio": [0.75, 1.333]}],
             ["PhotometricDistort", None], ["RandomMirror", None]]
    jcfg, cfg = zoo_cfgs("dbpn", image_size=24)
    for c in (jcfg, cfg):
        c.DATASET.DATA_AUGMENTATION = chain
    rng = np.random.RandomState(3)
    img = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
    mask = ((rng.rand(40, 36, 1) > 0.7) * 255).astype(np.uint8)
    for seed in range(8):
        a = port_tf.TrainTransforms(cfg)(img, mask, np.random.RandomState(seed))
        b = jax_tf.TrainTransforms(jcfg)(img, mask, np.random.RandomState(seed))
        assert a[0].shape == (24, 24, 3) and a[1].shape == (24, 24, 1)
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-3 / 255)


# --------------------------------------------------------------------------
# train sets


@pytest.fixture(scope="module")
def png_dirs(tmp_path_factory):
    """RetinalSeg-like pairs (0/1 masks), road pairs (0/255 masks) and
    image-only pretraining pngs, 36 x 40."""
    root = tmp_path_factory.mktemp("surface_pngs")
    rng = np.random.RandomState(5)
    dirs = {}
    for name, mask_high in (("RetinalSeg", 1), ("mass_road", 255), ("pretrain", None)):
        img_dir, mask_dir = root / name / "images", root / name / "masks"
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for i in range(4):
            Image.fromarray((rng.rand(36, 40, 3) * 255).astype(np.uint8)).save(
                img_dir / f"p{i}.png")
            if mask_high is not None:
                m = ((rng.rand(36, 40) > 0.7) * mask_high).astype(np.uint8)
                Image.fromarray(m, "L").save(mask_dir / f"p{i}.png")
        dirs[name] = (str(img_dir), str(mask_dir))
    return dirs


@pytest.mark.parametrize("name,cls", [("RetinalSeg", "RetinalDataSet"),
                                      ("mass_road", "MassRoadDataset"),
                                      ("pretrain", "SRPretrainDataSet")])
def test_train_sets_equal_jax(png_dirs, name, cls):
    jcfg, cfg = zoo_cfgs("dbpn", image_size=32)
    img_dir, mask_dir = png_dirs[name]
    args = (img_dir,) if cls == "SRPretrainDataSet" else (img_dir, mask_dir)
    ours = getattr(port_datasets, cls)(cfg, *args, port_tf.TrainTransforms(cfg))
    ref = getattr(jax_datasets, cls)(jcfg, *args, jax_tf.TrainTransforms(jcfg))
    assert len(ours) == len(ref) == 4
    for i in range(4):
        a, b = ours.get(i, np.random.RandomState(i)), ref.get(i, np.random.RandomState(i))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.float32 and np.array_equal(x, y)
    seg = a[1]
    if cls == "SRPretrainDataSet":
        assert seg.shape == (32, 32, 1) and not seg.any()
    else:  # binary after the /255 (the retinal 0/1 masks through their x255)
        assert set(np.unique(seg)) == {0.0, 1.0}


@pytest.mark.parametrize("name,only_images,cls", [("RetinalSeg", False, "RetinalDataSet"),
                                                  ("mass_road", False, "MassRoadDataset"),
                                                  ("pretrain", True, "SRPretrainDataSet")])
def test_build_datasets_dispatches_as_the_root_cli(png_dirs, name, only_images, cls):
    from csbsr_tpu_torch.train import build_datasets, split_and_eval_batches

    cfg = zoo_cfgs("dbpn", image_size=32, extra=["SOLVER.BATCH_SIZE", 1])[1]
    cfg.DATASET.TRAIN_IMAGE_DIR, cfg.DATASET.TRAIN_MASK_DIR = png_dirs[name]
    cfg.DATASET.ONLY_IMAGES = only_images
    ds = build_datasets(cfg, synthetic=False)
    assert type(ds).__name__ == cls
    train_idx, evals = split_and_eval_batches(cfg, ds)
    # the retinal set trains on min(12, n) images, the others on 95%
    assert len(train_idx) == (4 if name == "RetinalSeg" else 3) and len(evals) == 4 - len(train_idx)


# --------------------------------------------------------------------------
# SGD


def test_masked_sgd_equals_optax_sgd():
    """Three steps of optax.sgd(schedule) with the group multipliers on the
    gradient and the update ([1, 0, 1, 1] in the second: KERNEL frozen, bit
    for bit), a None grad counting as zero; rtol 1e-6 in float32."""
    import optax

    from csbsr_tpu.engine.train_state import make_optimizer

    jcfg, cfg = zoo_cfgs("dbpn", extra=WINDOWS + ["MODEL.OPTIMIZER", "SGD", "SOLVER.LR", 0.05])
    tx = make_optimizer(jcfg, jax_phase_config(jcfg, 6))
    shapes = {"sr_model.predictor.feat_ext.0.layer.weight": (4, 3, 3, 3),
              "sr_model.feat.0.weight": (5, 3), "segmentation_model.final.0.bias": (7,)}
    rng = np.random.RandomState(0)
    p0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()} for _ in range(3)]
    grads[2]["segmentation_model.final.0.bias"] = None
    mults = [[1.0] * 4, [1.0, 0.0, 1.0, 1.0], [1.0] * 4]
    gid = grad_group_ids(shapes.items())
    assert [gid[n] for n in shapes] == [KERNEL, SR_CORE, SEG]

    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    st = tx.init(jp)
    params = {n: torch.tensor(v) for n, v in p0.items()}
    opt = MaskedSGD(list(params.items()), gid, make_lr_schedule(cfg, phase_config_from_cfg(cfg, 6)))
    for g, m in zip(grads, mults):
        gm = {n: (np.zeros(shapes[n], np.float32) if v is None else v) * m[gid[n]]
              for n, v in g.items()}
        upd, st = tx.update({n: jnp.asarray(v) for n, v in gm.items()}, st, jp)
        jp = optax.apply_updates(jp, {n: u * m[gid[n]] for n, u in upd.items()})
        before = {n: p.clone() for n, p in params.items()}
        for n, p in params.items():
            p.grad = None if g[n] is None else torch.tensor(g[n])
        opt.step(m)
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-9)
            moved = not torch.equal(p, before[n])
            assert moved == (m[gid[n]] == 1.0 and g[n] is not None), n
    assert opt.state_dict() == {"count": 3} and opt.count == 3


def test_create_train_state_picks_the_optimizer():
    from csbsr_tpu_torch.engine.train_state import MaskedAdam, create_train_state

    for name, cls in (("Adam", MaskedAdam), ("SGD", MaskedSGD)):
        cfg = zoo_cfgs("dbpn", extra=["MODEL.OPTIMIZER", name])[1]
        model = torch.nn.Linear(2, 2)
        assert type(create_train_state(cfg, model, phase_config_from_cfg(cfg, 6)).optimizer) \
            is cls
    cfg.MODEL.OPTIMIZER = "RMSprop"
    with pytest.raises(NotImplementedError, match="RMSprop"):
        create_train_state(cfg, model, phase_config_from_cfg(cfg, 6))


@pytest.mark.parametrize("joint", [True, False])
def test_inverse_group_multipliers_equal_jax(joint):
    """The inverse model trains both stages throughout when staged (the
    reference's inverse staging is commented out); the JAX package's
    multipliers at every window edge."""
    from csbsr_tpu.engine.train_state import group_multipliers as jax_group_multipliers

    extra = WINDOWS + ["MODEL.SR_SEG_INV", True, "MODEL.JOINT_LEARNING", joint]
    jcfg, cfg = zoo_cfgs("dbpn", extra=extra)
    pc, pc_j = phase_config_from_cfg(cfg, NUM_TRAIN), jax_phase_config(jcfg, NUM_TRAIN)
    for it in (1, 2, 3, 4, 5, 6, 20):
        for inv in (True, False):
            ref = jax_group_multipliers(jax_compute_phase(it, pc_j), pc_j, blurskip_only=False,
                                        sr_seg_inv=inv)
            ours = group_multipliers(compute_phase(it, pc), pc, False, inv)
            assert ours == np.asarray(ref).tolist(), (it, inv)


# --------------------------------------------------------------------------
# loss glue


GLUE_CASES = {
    "sr_only_kbpn": ("dbpn", ["MODEL.SR", "KBPN", "SOLVER.SR_LOSS_FUNC", "KBPN",
                              "DATASET.ONLY_IMAGES", True]),
    "sr_only_l1": ("dbpn", ["DATASET.ONLY_IMAGES", True]),
    "inverse": ("dbpn", ["MODEL.SR_SEG_INV", True]),
    "inverse_staged": ("dbpn", ["MODEL.SR_SEG_INV", True, "MODEL.JOINT_LEARNING", False]),
    "inverse_l2_dice": ("dbpn", ["MODEL.SR_SEG_INV", True, "SOLVER.SR_LOSS_FUNC", "L2",
                                 "SOLVER.SEG_LOSS_FUNC", "Dice"]),
    "x1": ("dbpn", ["MODEL.SCALE_FACTOR", 1]),
    "bicubic": ("dbpn", ["MODEL.SR", "bicubic"]),
    "crackformer_rcf": ("crackformer", ["SOLVER.SEG_LOSS_FUNC", "CrackFormerLoss"]),
}


def _glue_outputs(case, jcfg, b, rng):
    """Random NHWC float64 outputs of the case's model, at HR 32 / LR 8."""
    hr, lr = 32, 32 // max(int(jcfg.MODEL.SCALE_FACTOR), 1)
    if case.startswith("x1"):
        lr = hr
    p = lambda *s: rng.uniform(0.02, 0.98, s)
    out = {"sr": p(b, hr, hr, 1 if "inverse" in case else 3), "kernel": rng.rand(b, SIZE * SIZE)}
    if case.startswith("sr_only"):
        return out
    out["seg"] = out["sr"] if "inverse" in case else p(b, hr, hr, 1)
    if "inverse" in case:
        out["lr_seg"], out["aux"] = p(b, lr, lr, 1), p(b, lr, lr, 1)
    else:
        out["aux"] = p(b, hr, hr, 5 if case == "crackformer_rcf" else 1)
    return out


@pytest.mark.parametrize("case", list(GLUE_CASES))
def test_new_loss_glue_branches_equal_jax_float64(case):
    """Each new branch of build_loss_fn on the same random outputs and batch,
    at iterations inside and past the pretrain windows (and past the
    windows' end, where the inverse model's staged total is the SR loss):
    the port's total, seg and SR losses equal the JAX package's to 1e-12 in
    float64. Both SDFs are float32, as outside x64."""
    from tests.test_torch_port_train import _batch

    recipe, extra = GLUE_CASES[case]
    jcfg, cfg = zoo_cfgs(recipe, extra=WINDOWS + extra)
    rng = np.random.RandomState(len(case))
    batch = {k: v.astype(np.float64) for k, v in _batch().items()}
    if case == "x1":
        batch["lr"] = batch["hr"]
    outs = _glue_outputs(case, jcfg, 2, rng)
    loss_j, loss_t = jax_build_loss_fn(jcfg), build_loss_fn(cfg)
    pc, pc_j = phase_config_from_cfg(cfg, NUM_TRAIN), jax_phase_config(jcfg, NUM_TRAIN)
    t = lambda a: nchw(a) if a.ndim == 4 else torch.from_numpy(a)
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        sdf = jax_seg_losses.sdf_normalized
        mp.setattr(jax_seg_losses, "sdf_normalized", lambda m: sdf(m).astype(jnp.float32))
        for it in (2, 4, 6):
            ref = loss_j({k: jnp.asarray(v) for k, v in outs.items()},
                         {k: jnp.asarray(v) for k, v in batch.items()},
                         jax_compute_phase(it, pc_j))
            ours = loss_t({k: t(v) for k, v in outs.items()}, {k: t(v) for k, v in batch.items()},
                          compute_phase(it, pc))
            for k in ("total", "seg_loss", "sr_loss"):
                assert ours[k].dtype == torch.float64, k
                np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-12, atol=0,
                                           err_msg=f"{case} {k} at {it}")
    if case.startswith("sr_only"):
        assert float(ours["seg_loss"]) == 0.0 and float(ours["total"]) == float(ours["sr_loss"])
    elif case in ("x1", "bicubic"):
        assert float(ours["sr_loss"]) == 0.0 and float(ours["total"]) == float(ours["seg_loss"])
    elif case == "inverse_staged":
        assert float(ours["total"]) == float(ours["sr_loss"])


def test_inverse_loss_shares_one_sdf_between_main_and_aux(monkeypatch):
    """PSPNet's main and aux maps are both at the LR size: the boundary loss
    of the inverse model computes one SDF (two EDT row passes)."""
    import csbsr_tpu_torch.engine.losses_glue as glue
    from tests.test_torch_port_train import _batch

    cfg = zoo_cfgs("dbpn", extra=WINDOWS + ["MODEL.SR_SEG_INV", True])[1]
    calls = []
    real = glue.boundary_sdf
    monkeypatch.setattr(glue, "boundary_sdf", lambda m: calls.append(m.shape) or real(m))
    outs = _glue_outputs("inverse", cfg, 2, np.random.RandomState(0))
    batch = {k: torch.from_numpy(v) if v.ndim < 4 else nchw(v) for k, v in _batch().items()}
    build_loss_fn(cfg)({k: nchw(v) if v.ndim == 4 else torch.from_numpy(v)
                        for k, v in outs.items()}, batch,
                       compute_phase(6, phase_config_from_cfg(cfg, NUM_TRAIN)))
    assert calls == [torch.Size([2, 1, 8, 8])]


# --------------------------------------------------------------------------
# pretrained weights


def _torch_layout(shape, kind):
    """A flax leaf's shape in torch layout (conv HWIO -> OIHW, Dense IO -> OI,
    a PReLU's scalar slope -> (1,))."""
    if kind == "alpha":
        return (1,)
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return tuple(shape[::-1]) if len(shape) == 2 else tuple(shape)


def _release_file(tree, stats, translate, rng, prefix="", extra=None):
    """A state dict in a release's names: every leaf the translator names,
    random values in torch layout (the JAX package's convert_tree kinds)."""
    from flax import traverse_util

    sd = {}
    for source, is_stats in ((tree, False), (stats or {}, True)):
        for path, leaf in traverse_util.flatten_dict(source).items():
            kind = path[-1] if is_stats else {"embedding": "kernel"}.get(path[-1], path[-1])
            key = translate(path, kind)
            if key is not None:
                shift = 0.5 if kind == "var" else -0.5  # variances stay positive
                v = rng.rand(*_torch_layout(np.shape(leaf), kind)) + shift
                sd[prefix + key] = torch.tensor(v, dtype=torch.float32)
    sd.update(extra or {})
    return sd


def _loaded_pair(tmp_path, monkeypatch, name, extra, files, narrow=None):
    """(the port's state dict, the JAX loads' state dict in port names) after
    both packages load the files from tmp_path/weights/pretrain."""
    from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
    from csbsr_tpu.utils import pretrained as jax_pretrained
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils import pretrained
    from csbsr_tpu_torch.utils.convert import state_dict_from_jax
    from tests.test_torch_port_models import random_variables

    jcfg, cfg = zoo_cfgs(name, extra=extra)
    jm = jax_model_from_cfg(jcfg)
    lr = 32 // jcfg.MODEL.SCALE_FACTOR
    variables = random_variables(jm, jnp.zeros((1, lr, lr, 3)), None, False, train=False, seed=3)
    params, stats = variables["params"], variables.get("batch_stats", {})
    wdir = tmp_path / "weights" / "pretrain"
    wdir.mkdir(parents=True)
    for fname, make in files.items():
        torch.save(make(params, stats), wdir / fname)
    monkeypatch.chdir(tmp_path)
    logs_j, logs = [], []
    p, s = jax_pretrained.load_imagenet_backbones(jcfg, params, stats, logs_j.append)
    if "sr_model" in p:
        p, s = jax_pretrained.load_pretrained_sr(jcfg, p, s, logs_j.append)
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    pretrained.load_imagenet_backbones(cfg, model, str(wdir), logs.append)
    pretrained.load_pretrained_sr(cfg, model, str(wdir), logs.append)
    return model.state_dict(), state_dict_from_jax(p, s), state_dict_from_jax(params, stats), \
        logs, logs_j


def _assert_loads_equal(ours, ref, before):
    assert set(ref) <= set(ours)
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k
    return {k for k in ref if not torch.equal(ref[k], before[k])}


def test_imagenet_and_sr_loads_equal_jax_flagship(tmp_path, monkeypatch):
    """VGG16 into KBPN's feat head, ResNet-34 into PSPNet's extractor (with
    torchvision's unused fc and num_batches_tracked keys), then a released
    KBPN file under "module.sr_model." prefixes: the port's weights after
    its loads equal the JAX package's after its loads, exactly."""
    from csbsr_tpu.utils import translators

    rng = np.random.RandomState(0)
    name = "KBPN_pretrain_x4_stage2_bicubic7.pth"
    files = {
        "vgg16-397923af.pth": lambda p, s: _release_file(
            p["sr_model"], None, translators.imagenet_vgg16_kbpn_feat, rng,
            extra={"classifier.0.weight": torch.rand(3, 4)}),
        "resnet34-333f7ec4.pth": lambda p, s: _release_file(
            p["segmentation_model"], s.get("segmentation_model"),
            translators.imagenet_resnet_pspnet, rng,
            extra={"fc.weight": torch.rand(3, 4), "bn1.num_batches_tracked": torch.tensor(9)}),
        name: lambda p, s: _release_file(p["sr_model"], None, translators.translate_kbpn, rng,
                                         prefix="module.sr_model."),
    }
    ours, ref, before, logs, logs_j = _loaded_pair(
        tmp_path, monkeypatch, "dbpn", ["MODEL.SR", "KBPN", "BLUR.KERNEL_SIZE", 7,
                                        "BLUR.KERNEL_SIZE_OUTPUT", 21], files)
    moved = _assert_loads_equal(ours, ref, before)
    assert {k.split(".")[0] for k in moved} == {"sr_model", "segmentation_model"}
    assert any(k.startswith("segmentation_model.feats.layer4") for k in moved)
    assert not any(k.startswith("segmentation_model.ppm") for k in moved)
    assert any("VGG16->KBPN.feat" in m for m in logs)
    assert any("resnet34->PSPNet.feats" in m for m in logs)
    assert logs[-1].startswith("SR pretrained model was loaded from") and name in logs[-1]
    assert len(logs) == len(logs_j) == 3


def test_imagenet_loads_equal_jax_unet16(tmp_path, monkeypatch):
    """VGG16 into U-Net16's encoder (and KBPN's feat head); no SR file: both
    log it and keep the random SR weights."""
    from csbsr_tpu.utils import translators

    rng = np.random.RandomState(1)
    vgg = {}

    def make(p, s):
        for tree, tr in ((p["sr_model"], translators.imagenet_vgg16_kbpn_feat),
                         (p["segmentation_model"], translators.imagenet_vgg16_unet16)):
            vgg.update(_release_file(tree, None, tr, rng))
        return vgg

    ours, ref, before, logs, logs_j = _loaded_pair(tmp_path, monkeypatch, "unet16", [],
                                                   {"vgg16.pth": make})
    moved = _assert_loads_equal(ours, ref, before)
    assert any(k.startswith("segmentation_model.conv5.4") for k in moved)
    assert not any(k.startswith("segmentation_model.dec") for k in moved)
    assert any("not found" in m for m in logs) and any("not found" in m for m in logs_j)


def test_imagenet_loads_equal_jax_hrnet(tmp_path, monkeypatch, narrow_hrnet):
    """HRNet-W48's backbone (at the tests' narrow width), the classification
    head's keys unused."""
    from csbsr_tpu.utils import translators

    rng = np.random.RandomState(2)
    files = {"hrnetv2_w48_imagenet_pretrained.pth": lambda p, s: _release_file(
        p["segmentation_model"], s.get("segmentation_model"), translators.imagenet_hrnet_w48,
        rng, extra={"classifier.weight": torch.rand(3, 4)})}
    ours, ref, before, logs, _ = _loaded_pair(tmp_path, monkeypatch, "hrnet", [], files)
    moved = _assert_loads_equal(ours, ref, before)
    assert moved and all(k.startswith("segmentation_model.backbone.") for k in moved
                         if k.startswith("segmentation_model."))
    assert any("HRNet-W48->OCR.backbone" in m for m in logs)


def test_loads_that_do_not_fit_are_skipped(tmp_path, monkeypatch):
    """The inverse model's 1-channel KBPN takes neither VGG16's 3-channel
    first conv nor a 3-channel SR file: both packages log and skip, and
    SR_SCRATCH skips the SR file unread."""
    from csbsr_tpu.utils import translators
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils import pretrained

    rng = np.random.RandomState(4)
    name = "KBPN_pretrain_x4_stage2.pth"
    three = {}

    def sr_file(p, s):
        sd = _release_file(p["sr_model"], None, translators.translate_kbpn, rng)
        sd["feat.0.weight"] = torch.rand(64, 3, 3, 3)
        three.update(sd)
        return sd

    files = {"vgg16.pth": lambda p, s: {"features.0.weight": torch.rand(64, 3, 3, 3),
                                        "features.0.bias": torch.rand(64)},
             name: sr_file}
    cfg = zoo_cfgs("dbpn", extra=["MODEL.SR", "KBPN", "MODEL.SR_SCRATCH", True])[1]
    ours, ref, before, logs, logs_j = _loaded_pair(
        tmp_path, monkeypatch, "dbpn", ["MODEL.SR", "KBPN", "MODEL.SR_SEG_INV", True], files)
    assert _assert_loads_equal(ours, ref, before) == set()
    assert any("failed" in m for m in logs) and any("failed" in m for m in logs_j)
    assert any("incomplete" in m for m in logs) and any("incomplete" in m for m in logs_j)

    model = model_from_cfg(cfg, device="cpu")
    assert not pretrained.load_pretrained_sr(cfg, model, "weights/pretrain", logs.append)
