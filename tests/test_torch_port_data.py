"""Port: the train data path against the JAX package, bit for bit.

The datasets, the flagship augmentation chain and the iteration-based
loader are numpy in both packages, so their batches must be equal exactly
(`np.array_equal`); the port's batches are the JAX package's transposed to
NCHW.
"""
import numpy as np
import pytest

from csbsr_tpu.config import get_cfg_defaults as jax_cfg_defaults
from csbsr_tpu.data import CrackDataSet as JaxCrackDataSet
from csbsr_tpu.data import IterationBasedLoader as JaxLoader
from csbsr_tpu.data import SubsetView as JaxSubsetView
from csbsr_tpu.data import SyntheticCrackDataSet as JaxSynthetic
from csbsr_tpu.data import TrainTransforms as JaxTrainTransforms
from csbsr_tpu_torch.config import get_cfg_defaults
from csbsr_tpu_torch.data import (CrackDataSet, IterationBasedLoader, SubsetView,
                                  SyntheticCrackDataSet, TrainTransforms)

FLAGSHIP_YAML = "configs/config_csbsr_pspnet.yaml"


def _cfgs(image_size=32):
    out = []
    for cfg in (jax_cfg_defaults(), get_cfg_defaults()):
        cfg.merge_from_file(FLAGSHIP_YAML)
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", [image_size, image_size]])
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def crack_dirs(tmp_path_factory):
    """Six 40x48 jpg images with same-name masks, larger than the 32x32 crop."""
    from PIL import Image

    root = tmp_path_factory.mktemp("port_train_data")
    img_dir, mask_dir = root / "images", root / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(3)
    for i in range(6):
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype(np.uint8)).save(img_dir / f"c{i}.jpg")
        Image.fromarray(((rng.rand(40, 48) > 0.8) * 255).astype(np.uint8), "L").save(
            mask_dir / f"c{i}.jpg")
    return str(img_dir), str(mask_dir)


def _nhwc(batch):
    return {k: np.transpose(v, (0, 2, 3, 1)) for k, v in batch.items()}


def _assert_batches_equal(ours, ref, n):
    for i, (a, b) in enumerate(zip(ours, ref)):
        assert set(a) == set(b) == {"hr", "seg"}
        assert a["hr"].dtype == np.float32 and a["hr"].flags["C_CONTIGUOUS"]
        for k, v in _nhwc(a).items():
            assert np.array_equal(v, b[k]), (i, k)
    assert i == n - 1


@pytest.mark.parametrize("start_iter", [0, 2])
def test_synthetic_loader_batches_equal_jax(start_iter):
    jcfg, cfg = _cfgs()
    perm = np.random.RandomState(1121).permutation(40)[:30]
    ours = IterationBasedLoader(SubsetView(SyntheticCrackDataSet(cfg, 40, (32, 32)), perm), 4,
                                5, seed=1121, start_iter=start_iter, num_workers=2)
    ref = JaxLoader(JaxSubsetView(JaxSynthetic(jcfg, 40, (32, 32)), perm), 4, 5, seed=1121,
                    start_iter=start_iter, num_workers=2)
    _assert_batches_equal(ours, ref, 5)


@pytest.mark.parametrize("start_iter", [0, 2])
def test_crack_dataset_loader_with_the_flagship_augmentation_equals_jax(crack_dirs, start_iter):
    """Mirror, vertical flip (p 0.3) and the random 32x32 crop, drawn per
    sample: the epochs wrap (6 images, batch 2) and the crops differ."""
    jcfg, cfg = _cfgs()
    ours = IterationBasedLoader(CrackDataSet(cfg, *crack_dirs, TrainTransforms(cfg)), 2, 6,
                                seed=7, start_iter=start_iter, num_workers=3)
    ref = JaxLoader(JaxCrackDataSet(jcfg, *crack_dirs, JaxTrainTransforms(jcfg)), 2, 6, seed=7,
                    start_iter=start_iter, num_workers=3)
    batches = list(ours)
    _assert_batches_equal(batches, ref, 6)
    assert batches[0]["hr"].shape == (2, 3, 32, 32) and batches[0]["seg"].shape == (2, 1, 32, 32)
    assert 0.0 <= batches[0]["hr"].min() and batches[0]["hr"].max() <= 1.0


def test_train_transforms_draw_like_jax_per_sample():
    jcfg, cfg = _cfgs(image_size=24)
    rng = np.random.RandomState(0)
    img = (rng.rand(30, 28, 3) * 255).astype(np.uint8)
    mask = ((rng.rand(30, 28, 1) > 0.5) * 255).astype(np.uint8)
    for seed in range(8):
        a = TrainTransforms(cfg)(img, mask, np.random.RandomState(seed))
        b = JaxTrainTransforms(jcfg)(img, mask, np.random.RandomState(seed))
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_unported_augmentations_raise():
    cfg = get_cfg_defaults()  # the default chain ends with RandomResizedCrop
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TrainTransforms(cfg)


def test_split_and_eval_batches_follow_the_seeded_permutation():
    from csbsr_tpu_torch.train import split_and_eval_batches

    cfg = _cfgs()[1]
    ds = SyntheticCrackDataSet(cfg, 256, (32, 32))
    train_idx, evals = split_and_eval_batches(cfg, ds, max_eval_batches=1)
    perm = np.random.RandomState(cfg.SEED).permutation(256)
    assert np.array_equal(train_idx, perm[:243])
    assert len(evals) == 1 and evals[0]["hr"].shape == (6, 3, 32, 32)
    assert np.array_equal(evals[0]["seg"][0], np.transpose(ds.get(int(perm[243]))[1], (2, 0, 1)))
