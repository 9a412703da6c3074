"""Training CLI of the port: python -m csbsr_tpu_torch.train.

Mirrors the root `train.py` (the JAX package's): the config is the defaults
merged with --config_file and trailing `KEY VALUE` overrides, a copy goes to
OUTPUT_DIR/config.yaml, and the dataset under DATASET.TRAIN_IMAGE_DIR is
chosen as there: SRPretrainDataSet with DATASET.ONLY_IMAGES, RetinalDataSet
for a "RetinalSeg" directory, MassRoadDataset for one named "road",
CrackDataSet otherwise; with --synthetic or without that directory, the
synthetic set of max(256, 21 * BATCH_SIZE) crops. A seeded 95/5 split (12
images for the retinal set) gives the train stream and the eval batches.
Runs on CUDA unless given --device cpu; without CUDA the default raises.

  python -m csbsr_tpu_torch.train --config_file configs/config_csbsr_pspnet.yaml \\
      --synthetic [--device cuda] [KEY VALUE ...]

Pretrained weights are read from weights/pretrain/ under the working
directory when present (utils/pretrained.py): SR-only pretraining
(DATASET.ONLY_IMAGES True) of KBPN x4 with 4 stages saves
checkpoints/<iter>.pth; copied to weights/pretrain/KBPN_pretrain_x4_stage4.pth
it starts the joint training of the flagship recipe.
"""
from __future__ import annotations

import argparse
import os
import random
import shutil

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CSBSR training (PyTorch port)")
    p.add_argument("--config_file", type=str, default="", metavar="FILE")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--log_step", type=int, default=50)
    p.add_argument("--save_step", type=int, default=2000)
    p.add_argument("--eval_step", type=int, default=2000)
    p.add_argument("--resume_iter", type=int, default=0)
    p.add_argument("--max_eval_batches", type=int, default=0,
                   help="cap eval batches (0 = the full eval split)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--synthetic", action="store_true", help="force synthetic data")
    p.add_argument("--wandb_flag", action="store_true", help="enable wandb logging")
    p.add_argument("--wandb_prj_name", type=str, default="CSBSR-TPU")
    p.add_argument("--output_dirname", type=str, default="",
                   help="accepted for parity with the reference CLI; unused")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run fails if it is 'cuda' and CUDA is absent")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def build_datasets(cfg, synthetic: bool, log_fn=print):
    from .data import (CrackDataSet, MassRoadDataset, RetinalDataSet, SRPretrainDataSet,
                       SyntheticCrackDataSet, TrainTransforms)

    image_dir = cfg.DATASET.TRAIN_IMAGE_DIR
    if not synthetic and os.path.isdir(image_dir):
        transforms = TrainTransforms(cfg)
        if cfg.DATASET.ONLY_IMAGES:
            ds = SRPretrainDataSet(cfg, image_dir, transforms)
        else:
            cls = (RetinalDataSet if "RetinalSeg" in image_dir else
                   MassRoadDataset if "road" in image_dir.lower() else CrackDataSet)
            ds = cls(cfg, image_dir, cfg.DATASET.TRAIN_MASK_DIR, transforms)
        if len(ds) > 0:
            return ds
        log_fn(f"No images found under {cfg.DATASET.TRAIN_IMAGE_DIR}; using synthetic data")
    elif not synthetic:
        log_fn("Train data dir not found; using synthetic data")
    # the pool grows with the batch so the 5% eval split fills an eval batch
    return SyntheticCrackDataSet(cfg, size=max(256, 21 * cfg.SOLVER.BATCH_SIZE),
                                 image_hw=cfg.INPUT.IMAGE_SIZE)


def split_and_eval_batches(cfg, dataset, max_eval_batches: int = 0):
    """The seeded random 95/5 split: (train indices, eval batches of host
    numpy {"hr", "seg", "degrade_seed"}, NCHW); the retinal set trains on 12."""
    n_train = int(len(dataset) * cfg.SOLVER.TRAIN_DATASET_RATIO)
    if "RetinalSeg" in cfg.DATASET.TRAIN_IMAGE_DIR:
        n_train = min(12, len(dataset))
    perm = np.random.RandomState(cfg.SEED).permutation(len(dataset))
    eval_idx = perm[n_train:]
    b = cfg.SOLVER.BATCH_SIZE
    if max_eval_batches:
        eval_idx = eval_idx[: max_eval_batches * b]
    rng = np.random.RandomState(cfg.SEED)
    eval_batches = []
    for s in range(0, len(eval_idx) - b + 1, b):
        samples = [dataset.get(int(i), rng) for i in eval_idx[s: s + b]]
        eval_batches.append({
            "hr": np.ascontiguousarray(np.stack([x[0] for x in samples]).transpose(0, 3, 1, 2)),
            "seg": np.ascontiguousarray(np.stack([x[1] for x in samples]).transpose(0, 3, 1, 2)),
            "degrade_seed": cfg.SEED + s,
        })
    return perm[:n_train], eval_batches


def main(argv=None):
    args = parse_args(argv)
    from .config import get_cfg_defaults
    from .data import IterationBasedLoader, SubsetView
    from .engine.trainer import do_train
    from .models import model_from_cfg
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    if args.wandb_flag:
        raise NotImplementedError("wandb logging is not ported yet; see ROADMAP.md, queue 1")
    cfg = get_cfg_defaults()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    if "_ds_" in cfg.DATASET.TRAIN_IMAGE_DIR:  # a pre-downsampled set: crops shrink by SF
        cfg.INPUT.IMAGE_SIZE = [int(s / cfg.MODEL.SCALE_FACTOR) for s in cfg.INPUT.IMAGE_SIZE]
    cfg.freeze()

    np.random.seed(cfg.SEED)
    random.seed(cfg.SEED)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    if args.config_file:
        shutil.copy(args.config_file, os.path.join(cfg.OUTPUT_DIR, "config.yaml"))
    else:
        with open(os.path.join(cfg.OUTPUT_DIR, "config.yaml"), "w") as f:
            f.write(cfg.dump())

    dataset = build_datasets(cfg, args.synthetic)
    train_idx, eval_batches = split_and_eval_batches(cfg, dataset, args.max_eval_batches)
    train_loader = IterationBasedLoader(
        SubsetView(dataset, train_idx), cfg.SOLVER.BATCH_SIZE,
        cfg.SOLVER.MAX_ITER - args.resume_iter, seed=cfg.SEED, start_iter=args.resume_iter,
        num_workers=args.num_workers)
    model = model_from_cfg(cfg, device=device)
    return do_train(cfg, model, train_loader, eval_batches, resume_iter=args.resume_iter,
                    log_step=args.log_step, save_step=args.save_step,
                    eval_step_every=args.eval_step, num_train_ds=len(train_idx),
                    debug=args.debug)


if __name__ == "__main__":
    main()
