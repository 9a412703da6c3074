"""Port: the serving half of the test CLI against the JAX package, on the
CPU: unlabelled-image inference (`inference_tti`, TTICrackDataSetTest), the
retinal set with the classification metrics, the host surface-distance
oracle, the offline test-set degrader, and the CLI's new flags. The model is
the flagship cut as in tests/test_torch_port_inference.py (2 KBPN stages,
float32), weights carried across; images are tiny numpy-seeded files.

Tolerances:
  - TTI: SR PNGs within one uint8 level (float32 outputs agree to ~1e-6, so
    a value at a rounding boundary may round the other way), masks equal
    except where |seg - threshold| < 1e-5, the same PNG set;
  - retinal summary (PSNR, SSIM, PSNR_kernel, AIU, IoU_max, Acc, Sens,
    Spec, host AHD/AMSD) within 1e-6; the host surface distances exactly
    (the same numpy code on the same masks);
  - make_test_blur: given the same kernels, every PNG within one level;
  - the uint8 SR crossing: bit for bit the bytes `save_img` writes.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
import jax

from tests.test_torch_port_models import joint_models

TTI_PATCH = 8  # LR patch of the engine-level TTI test (the CLI forces 64)
CHUNK = 4  # patches per model call: 6 patches -> chunks of 4 and 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _png(path):
    from PIL import Image

    return np.asarray(Image.open(path))


def _write_images(directory, n, hw, ext, seed):
    from PIL import Image

    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(directory / f"im{i}.{ext}")


@pytest.fixture(scope="module")
def models():
    return joint_models(image_size=4 * TTI_PATCH, stages=2, seed=5)


def _tree(out_dir):
    return sorted(str(p.relative_to(out_dir)) for p in Path(out_dir).rglob("*.png"))


def test_tti_outputs_equal_jax(models, tmp_path):
    from csbsr_tpu.data import TTICrackDataSetTest as JaxTTI
    from csbsr_tpu.engine.inference import inference_tti as jax_tti
    from csbsr_tpu_torch.data import TTICrackDataSetTest
    from csbsr_tpu_torch.engine.inference import inference_tti

    jcfg, cfg, jm, variables, model = models
    img_dir = tmp_path / "tti"
    _write_images(img_dir, 2, (2 * TTI_PATCH + 3, 3 * TTI_PATCH + 1), "png", seed=3)
    for c in (jcfg, cfg):
        c.INPUT.IMAGE_SIZE = [TTI_PATCH, TTI_PATCH]
    ours_ds, ref_ds = TTICrackDataSetTest(cfg, str(img_dir)), JaxTTI(jcfg, str(img_dir))
    item, ref_item = ours_ds.get(1), ref_ds.get(1)
    np.testing.assert_array_equal(np.transpose(item[0], (0, 2, 3, 1)), ref_item[0])
    assert item[1] == ref_item[1] and item[0].shape[0] == 6
    np.testing.assert_array_equal(item[2], ref_item[2])
    np.testing.assert_array_equal(item[3], ref_item[3])

    jax_tti(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables), ref_ds,
            output_dir=str(tmp_path / "jax"), max_patches_per_call=CHUNK, log_fn=lambda *a: None)
    inference_tti(cfg, model, ours_ds, output_dir=str(tmp_path / "port"), device="cpu",
                  max_patches_per_call=CHUNK, log_fn=lambda *a: None)
    files = _tree(tmp_path / "jax")
    assert _tree(tmp_path / "port") == files
    assert len(files) == 2 * (1 + 2 + 11 + 1)  # image, two kernels, 11 masks, raw
    # the JAX package's float seg map of each image, which its masks threshold
    import jax.numpy as jnp
    from csbsr_tpu.engine.inference import build_infer_fn
    from csbsr_tpu.ops.patch import joint_patch

    infer = build_infer_fn(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables))
    seg = {}
    for i in range(len(ref_ds)):
        patches, fname, _, seg_ushape = ref_ds.get(i)
        seg[fname] = np.asarray(joint_patch(infer(jnp.asarray(patches))[1], seg_ushape))[0, ..., 0]
    for name in files:
        a = _png(tmp_path / "port" / name).astype(int)
        b = _png(tmp_path / "jax" / name).astype(int)
        assert a.shape == b.shape, name
        if name.startswith("masks/th_"):
            near = np.abs(seg[name.split("/")[-1]] - float(name.split("/")[1][3:])) < 1e-5
            assert not np.any((a != b) & ~near), name
        else:
            assert np.abs(a - b).max() <= 1, name


def test_tti_mask_thresholds_follow_the_float_map(models):
    """The masks threshold the float32 seg map exactly (no 8-bit rounding):
    the port's seg crossing is float32 and equals the JAX package's within
    1e-5 except where it sits that close to a threshold."""
    from csbsr_tpu.engine.inference import build_infer_fn
    from csbsr_tpu.ops.patch import joint_patch as jax_joint
    from csbsr_tpu_torch.engine.inference import tti_outputs
    import jax.numpy as jnp

    jcfg, cfg, jm, variables, model = models
    rng = np.random.RandomState(9)
    patches = rng.rand(6, 3, TTI_PATCH, TTI_PATCH).astype(np.float32)
    ushape = np.array([1, 1, 2, 3, 3, 4 * TTI_PATCH, 4 * TTI_PATCH])
    seg_ushape = ushape.copy()
    seg_ushape[4] = 1
    sr_u8, seg, k2d = tti_outputs(cfg, model, patches, ushape, seg_ushape, device="cpu",
                                  max_patches_per_call=CHUNK)
    infer = build_infer_fn(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables))
    sr_j, seg_j, k_j = infer(jnp.asarray(np.transpose(patches, (0, 2, 3, 1))))
    seg_j = np.asarray(jax_joint(seg_j, seg_ushape))
    assert seg.dtype == np.float32 and sr_u8.dtype == np.uint8
    np.testing.assert_allclose(np.transpose(seg, (0, 2, 3, 1)), seg_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(k2d, np.asarray(k_j[:1]), rtol=1e-4, atol=1e-6)


def test_uint8_sr_crossing_is_the_png_save_img_writes(tmp_path):
    from csbsr_tpu_torch.engine.inference import sr_to_uint8
    from csbsr_tpu_torch.utils.save_output import save_img

    rng = np.random.RandomState(4)
    sr = rng.uniform(-0.2, 1.2, (1, 3, 17, 19)).astype(np.float32)
    # exact halves between levels (k + 0.5) / 255 and values at 0 and 1
    sr[0, 0, 0, :10] = (np.arange(10) * 25 + 0.5) / 255.0
    sr[0, 1, 0, :4] = [0.0, 1.0, -0.0, 1.0 + 1e-7]
    save_img(str(tmp_path), sr, ["x.png"])
    u8 = sr_to_uint8(torch.from_numpy(sr)).numpy()
    np.testing.assert_array_equal(_png(tmp_path / "images" / "x.png"),
                                  np.transpose(u8[0], (1, 2, 0)))
    # and the float image the TTI path saves from those bytes is the same PNG
    save_img(str(tmp_path / "again"), u8.astype(np.float32) / 255.0, ["x.png"])
    np.testing.assert_array_equal(_png(tmp_path / "again" / "images" / "x.png"),
                                  _png(tmp_path / "images" / "x.png"))


@pytest.fixture(scope="module")
def retinal_dirs(tmp_path_factory):
    """<root>/RetinalSeg/{images,masks} png pairs (masks 0/1, scaled x255 by
    the dataset) and the degraded LR set made by the JAX package's tool."""
    from PIL import Image

    from csbsr_tpu.data.make_test_blur import make_test_blur_dir

    root = tmp_path_factory.mktemp("port_retinal") / "RetinalSeg"
    _write_images(root / "images", 2, (64, 64), "png", seed=11)
    (root / "masks").mkdir()
    rng = np.random.RandomState(12)
    for i in range(2):
        Image.fromarray((rng.rand(64, 64) > 0.7).astype(np.uint8), "L").save(
            root / "masks" / f"im{i}.png")
    assert make_test_blur_dir(str(root / "images"), str(root / "blur" / "02_40"),
                              pattern="*.png") == 2
    return str(root / "images"), str(root / "masks"), str(root / "blur")


@pytest.fixture(scope="module")
def retinal_models(retinal_dirs):
    jcfg, cfg, jm, variables, model = joint_models(image_size=32, stages=2, seed=5)
    img, mask, blur = retinal_dirs
    for c in (jcfg, cfg):
        c.merge_from_list(["DATASET.TEST_IMAGE_DIR", img, "DATASET.TEST_MASK_DIR", mask,
                           "DATASET.TEST_BLURED_DIR", blur])
    return jcfg, cfg, jm, variables, model


@pytest.mark.parametrize("host_distances", [False, True], ids=["device_hd", "host_hd"])
def test_retinal_summary_with_classification_metrics_equals_jax(retinal_dirs, retinal_models,
                                                                host_distances, tmp_path):
    from csbsr_tpu.data import RetinalDataSetTest as JaxRetinal
    from csbsr_tpu.engine.inference import inference_for_ss as jax_inference
    from csbsr_tpu_torch.data import RetinalDataSetTest
    from csbsr_tpu_torch.engine.inference import inference_for_ss

    jcfg, cfg, jm, variables, model = retinal_models
    args = (*retinal_dirs[:3], "02_40")
    ours_ds, ref_ds = RetinalDataSetTest(cfg, *args), JaxRetinal(jcfg, *args)
    item, ref_item = ours_ds.get(0), ref_ds.get(0)
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else np.transpose(a, (1, 2, 0))
    for k in (0, 1, 2):
        np.testing.assert_array_equal(nhwc(item[k]), ref_item[k])
    assert set(np.unique(item[2])) == {0.0, 1.0}  # masks x255 then /255: binary
    np.testing.assert_array_equal(item[3], ref_item[3])
    np.testing.assert_array_equal(item[6], ref_item[6])

    kw = dict(test_aiu=True, test_surface_distance=host_distances,
              surface_distance_device=not host_distances, test_classification_metrics=True,
              log_fn=lambda *a: None)
    ref = jax_inference(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables), ref_ds,
                        output_dir=str(tmp_path / "jax"), **kw)
    ours = inference_for_ss(cfg, model, ours_ds, output_dir=str(tmp_path / "port"),
                            device="cpu", **kw)
    assert list(ours) == list(ref)
    assert {"Acc", "Sens", "Spec"} <= set(ours) and ("AHD" in ours) == host_distances
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6, atol=1e-6, err_msg=key)


def test_host_surface_distances_equal_jax_exactly():
    from csbsr_tpu.metrics.surface_distance import calc_distance_metrics as jax_calc
    from csbsr_tpu_torch.metrics.surface_distance import calc_distance_metrics

    rng = np.random.RandomState(2)
    prob = rng.rand(2, 1, 23, 29)
    preds = prob > np.array([0.3, 0.7, 0.999, 1.0])[None, :, None, None]  # last: empty
    gts = rng.rand(2, 1, 23, 29) > 0.8
    gts[1] = False  # an empty ground truth
    gts[0, 0, -1, :] = True  # touching the bottom edge
    hd, msd = calc_distance_metrics(preds, gts)
    hd_j, msd_j = jax_calc(preds, gts, use_native=False)
    np.testing.assert_array_equal(hd, hd_j)
    np.testing.assert_array_equal(msd, msd_j)
    assert hd[1, 3] == 0.0 and hd[0, 3] == 29  # empty vs empty; one empty: the max side


def test_retinal_metrics_equal_jax():
    from csbsr_tpu.metrics.retinal import get_retinal_seg_metrics as jax_metrics
    from csbsr_tpu_torch.metrics.retinal import get_retinal_seg_metrics

    rng = np.random.RandomState(8)
    seg = (rng.rand(3, 9, 7) > 0.5).astype(np.int16)
    gt = (rng.rand(3, 9, 7) > 0.6).astype(np.int16)
    gt[2] = 0  # no positives: sensitivity 1
    ours, ref = get_retinal_seg_metrics(seg, gt), jax_metrics(seg, gt)
    for key in ("acc", "sens", "spec"):
        np.testing.assert_array_equal(ours[key], ref[key])


def test_make_test_blur_equals_jax_given_the_same_kernels(tmp_path, monkeypatch):
    import jax.numpy as jnp

    import csbsr_tpu.ops.blur as jax_blur
    from csbsr_tpu.data.make_test_blur import make_test_blur_dir as jax_make
    from csbsr_tpu_torch.data.make_test_blur import make_test_blur_dir, main

    src = tmp_path / "hr"
    _write_images(src, 2, (24, 28), "jpg", seed=6)
    from PIL import Image  # one grayscale image: stacked to three channels

    Image.fromarray((np.random.RandomState(1).rand(24, 28) * 255).astype(np.uint8), "L").save(
        src / "im2.jpg")
    rng = np.random.RandomState(7)
    kernels = rng.rand(3, 21, 21).astype(np.float32) ** 4
    kernels /= kernels.sum(axis=(1, 2), keepdims=True)
    draws = iter(kernels)
    monkeypatch.setattr(jax_blur, "gaussian_kernels",
                        lambda *a, **k: jnp.asarray(next(draws))[None])
    assert jax_make(str(src), str(tmp_path / "jax")) == 3
    assert make_test_blur_dir(str(src), str(tmp_path / "port"), device="cpu",
                              kernels=kernels) == 3
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port") and len(files) == 9
    for name in files:
        a, b = _png(tmp_path / "port" / name).astype(int), _png(tmp_path / "jax" / name)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1, name
    # the seeded draws: the CLI makes the same three-folder layout on the CPU
    main([str(src), str(tmp_path / "cli"), "--device", "cpu", "--seed", "3"])
    assert _tree(tmp_path / "cli") == files


def _run_dir(tmp_path, cfg, model, it="7"):
    test_dir = tmp_path / "run"
    (test_dir / "checkpoints").mkdir(parents=True)
    (test_dir / "config.yaml").write_text(cfg.dump())
    torch.save(model.state_dict(), test_dir / "checkpoints" / f"{it}.pth")
    return test_dir


def test_cli_tti_int8_on_cpu(models, tmp_path):
    """--tti_crack_dataset --int8_serve --batch_size: 64 x 64 patches (the CLI
    forces them), int8 calibrated on the first batch_size patches, outputs
    in eval/tti_building/<tag>_size64."""
    from csbsr_tpu_torch.test import main

    cfg, model = models[1], models[4]
    img_dir = tmp_path / "photos"
    _write_images(img_dir, 1, (64, 64), "png", seed=2)
    test_dir = _run_dir(tmp_path, cfg, model)
    assert main(["--tti_crack_dataset", "--int8_serve", "--batch_size", "1", "--num_workers",
                 "2", "--device", "cpu", str(test_dir), "7", "DATASET.TEST_IMAGE_DIR",
                 str(img_dir)]) is None
    out = test_dir / "eval" / "tti_building" / "iter_7_size64"
    assert _png(out / "images" / "im0.png").shape == (256, 256, 3)
    assert len(list((out / "masks").iterdir())) == 12
    assert (out / "kernels_max" / "im0.png").is_file()


def test_cli_retinal_flags_on_cpu(retinal_models, tmp_path):
    """The retinal dispatch ('RetinalSeg' in TEST_IMAGE_DIR) with
    --test_classification_metrics, --surface_distance_host and --int8_serve
    (narrow scope), patches of INPUT.IMAGE_SIZE under --origin_img_size false."""
    from csbsr_tpu_torch.test import main

    cfg, model = retinal_models[1], retinal_models[4]
    test_dir = _run_dir(tmp_path, cfg, model)
    summary = main(["--test_classification_metrics", "--test_surface_distance",
                    "--surface_distance_host", "--int8_serve", "--int8_scope", "narrow",
                    "--origin_img_size", "false", "--sf_save_image", "--device", "cpu",
                    str(test_dir), "7"])
    assert {"Acc", "Sens", "Spec", "AHD", "AMSD"} <= set(summary)
    assert all(np.isfinite(v) for v in summary.values())
    assert (test_dir / "eval" / "02_40" / "iter_7" / "iou_log.csv").is_file()
    with pytest.raises(NotImplementedError, match="wandb"):
        main(["--wandb_flag", "--device", "cpu", str(test_dir), "7"])
