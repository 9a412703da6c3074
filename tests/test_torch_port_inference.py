"""Port: the evaluation harness and its CLI against the JAX package, on a
tiny on-disk fixture (the layout of tests/test_inference_engine.py) with the
cut-down flagship model, weights carried across.

Tolerances: PSNR, SSIM and PSNR_kernel to 1e-4 relative (float32 model
outputs agree to ~1e-6). AIU and IoU_max to 1e-3 absolute, AHD and AMSD to
1e-2 relative: a probability within ~1e-6 of one of the 99 thresholds may
binarise the other way, which moves one IoU term by about 1/union and an HD
or MSD term by up to a pixel, averaged over the 99 thresholds and the images.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax

from tests.test_torch_port_models import joint_models

IMAGE_SIZE = 32  # LR patch 8, 2x2 patches per 64x64 image


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fixture_dirs(tmp_path_factory):
    from PIL import Image

    from csbsr_tpu.data.make_test_blur import make_test_blur_dir

    root = tmp_path_factory.mktemp("port_testdata")
    img_dir, mask_dir = root / "gt" / "images", root / "gt" / "masks"
    img_dir.mkdir(parents=True)
    mask_dir.mkdir(parents=True)
    rng = np.random.RandomState(7)
    for i in range(2):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(img_dir / f"im{i}.jpg")
        Image.fromarray(((rng.rand(64, 64) > 0.8) * 255).astype(np.uint8), "L").save(
            mask_dir / f"im{i}.jpg")
    assert make_test_blur_dir(str(img_dir), str(root / "test_blured" / "02_40"),
                              kernel_size=21) == 2
    return str(img_dir), str(mask_dir), str(root / "test_blured")


@pytest.fixture(scope="module")
def models(fixture_dirs):
    img_dir, mask_dir, blur_dir = fixture_dirs
    jcfg, cfg, jm, variables, model = joint_models(image_size=IMAGE_SIZE, stages=2, seed=5)
    for c in (jcfg, cfg):
        c.merge_from_list(["DATASET.TEST_IMAGE_DIR", img_dir, "DATASET.TEST_MASK_DIR", mask_dir,
                           "DATASET.TEST_BLURED_DIR", blur_dir])
    return jcfg, cfg, jm, variables, model


def test_dataset_items_equal_jax(fixture_dirs, models):
    from csbsr_tpu.data import CrackDataSetTest as JaxSet
    from csbsr_tpu_torch.data import CrackDataSetTest

    jcfg, cfg = models[:2]
    args = (cfg.DATASET.TEST_IMAGE_DIR, cfg.DATASET.TEST_MASK_DIR, cfg.DATASET.TEST_BLURED_DIR,
            "02_40")
    ours, ref = CrackDataSetTest(cfg, *args).get(1), JaxSet(jcfg, *args).get(1)
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1)) if a.ndim == 4 else np.transpose(a, (1, 2, 0))
    for k in (0, 1, 2):
        assert np.array_equal(nhwc(ours[k]), ref[k])
    assert np.array_equal(ours[3], ref[3]) and ours[4] == ref[4]
    assert np.array_equal(ours[5], ref[5]) and np.array_equal(ours[6], ref[6])


def test_inference_summary_equals_jax(fixture_dirs, models, tmp_path):
    from csbsr_tpu.data import CrackDataSetTest as JaxSet
    from csbsr_tpu.engine.inference import inference_for_ss as jax_inference
    from csbsr_tpu_torch.data import CrackDataSetTest
    from csbsr_tpu_torch.engine.inference import inference_for_ss

    jcfg, cfg, jm, variables, model = models
    args = (cfg.DATASET.TEST_IMAGE_DIR, cfg.DATASET.TEST_MASK_DIR, cfg.DATASET.TEST_BLURED_DIR,
            "02_40")
    ref = jax_inference(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables),
                        JaxSet(jcfg, *args), output_dir=str(tmp_path / "jax"),
                        test_aiu=True, test_surface_distance=True, log_fn=lambda *a: None)
    out_dir = str(tmp_path / "port")
    ours = inference_for_ss(cfg, model, CrackDataSetTest(cfg, *args), output_dir=out_dir,
                            device="cpu", test_aiu=True, test_surface_distance=True,
                            save_images=True, log_fn=lambda *a: None)
    assert set(ours) == set(ref)
    for key in ("PSNR", "SSIM", "PSNR_kernel"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, err_msg=key)
    for key in ("AIU", "IoU_max"):
        np.testing.assert_allclose(ours[key], ref[key], atol=1e-3, err_msg=key)
    for key in ("AHD", "AMSD"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-2, err_msg=key)
    assert all(np.isfinite(v) for v in ours.values())
    # artifacts
    rows = [json.loads(line) for line in open(os.path.join(out_dir, "metrics.jsonl"))]
    assert sum("PSNR_score" in r for r in rows) == 2 and "HD95_score_median" in rows[-1]
    for name in ("iou_log.csv", "IoU_vs_threshold.png", "HD95_median_vs_threshold.png",
                 "images/im0.jpg", "masks/th_0.50/im0.png", "kernels_max/im0.png"):
        assert os.path.isfile(os.path.join(out_dir, name)), name


def test_cli_runs_on_cpu(fixture_dirs, models, tmp_path):
    from csbsr_tpu_torch.test import main

    cfg, model = models[1], models[4]
    test_dir = tmp_path / "run"
    (test_dir / "checkpoints").mkdir(parents=True)
    (test_dir / "config.yaml").write_text(cfg.dump())
    torch.save(model.state_dict(), test_dir / "checkpoints" / "7.pth")
    summary = main(["--test_surface_distance", "--sf_save_image", "--device", "cpu",
                    str(test_dir), "7"])
    assert all(np.isfinite(v) for v in summary.values()) and "AHD" in summary
    out = test_dir / "eval" / "02_40" / "iter_7"
    assert (out / "iou_log.csv").is_file() and not (out / "images").exists()
