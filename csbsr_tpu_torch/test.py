"""Evaluation and serving CLI of the port: python -m csbsr_tpu_torch.test.

Mirrors the root `test.py` (the JAX package's): the config comes from
`<test_dir>/config.yaml` (or --config_file) plus trailing `KEY VALUE`
overrides. Weights are a torch state dict in the reference's names:
<test_dir>/checkpoints/<iter>.pth for an iteration number, else
<test_dir>/<weight_name> (parameters a reference checkpoint holds but never
uses, CrackFormer's down{3,4,5}.nn3, are dropped before the strict load).
Three dispatches, as in the root CLI:

  - labelled crack set (default): PSNR/SSIM/kernel PSNR, AIU and, with
    --test_surface_distance, HD/MSD on the device (--surface_distance_host:
    the host oracle); output in <test_dir>/eval/<TEST_BLURED_NAME>/<tag>;
  - retinal set, when DATASET.TEST_IMAGE_DIR contains "RetinalSeg" (patches
    of 560 x 560 unless --origin_img_size false); --test_classification_metrics
    adds Acc/Sens/Spec at threshold 0.5;
  - --tti_crack_dataset: unlabelled png images, each the LR input, in 64 x 64
    patches, --batch_size of them per model call; SR images, kernels and
    masks to <test_dir>/eval/tti_building/<tag>_size64.

--int8_serve serves with int8 convs (--int8_scope all|narrow), calibrated on
the first test item's patches (the first --batch_size of them for TTI).
As with the root test.py, flags go before the positionals: everything after
them is read as `KEY VALUE` overrides.

  python -m csbsr_tpu_torch.test --test_surface_distance [--device cuda] \\
      <test_dir> <iter|weight_name> [KEY VALUE ...]
  python -m csbsr_tpu_torch.test --tti_crack_dataset --int8_serve <test_dir> <iter> \\
      DATASET.TEST_IMAGE_DIR <png dir>
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="CSBSR evaluation (PyTorch port)")
    p.add_argument("test_dir", type=str)
    p.add_argument("trained_iter", type=str)
    p.add_argument("--output_dirname", type=str, default="")
    p.add_argument("--config_file", type=str, default="")
    p.add_argument("--test_aiu", action="store_true", default=True)
    p.add_argument("--no_test_aiu", dest="test_aiu", action="store_false")
    p.add_argument("--test_surface_distance", action="store_true")
    p.add_argument("--surface_distance_host", action="store_true",
                   help="score HD/MSD with the host (scipy) oracle instead of on the device")
    p.add_argument("--test_classification_metrics", action="store_true")
    # reference polarity: images are saved by default; the flag turns it off
    p.add_argument("--sf_save_image", action="store_false", default=True,
                   help="If you do not want the output images to be saved, pass this flag.")
    p.add_argument("--tti_crack_dataset", action="store_true")
    p.add_argument("--int8_serve", action="store_true",
                   help="serve with int8 convs, calibrated on the first test item; check "
                        "the accuracy with python -m csbsr_tpu_torch.int8_accuracy first")
    p.add_argument("--int8_scope", choices=("all", "narrow"), default="all")
    p.add_argument("--wandb_flag", action="store_true",
                   help="not supported by the port (no network): raises")
    p.add_argument("--test_blured_name", type=str, default="")
    # batch_size bounds the patches per model call of the TTI path;
    # num_workers is accepted for parity with the root CLI
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--origin_img_size", type=lambda v: v.lower() != "false", default=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; the run fails if it is 'cuda' and CUDA is absent")
    p.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def weights_path(test_dir: str, trained_iter: str):
    """(state-dict path, output tag) for an iteration number or a file name."""
    if trained_iter.isdigit():
        return os.path.join(test_dir, "checkpoints", f"{trained_iter}.pth"), f"iter_{trained_iter}"
    return os.path.join(test_dir, trained_iter), os.path.splitext(trained_iter)[0]


def main(argv=None):
    args = parse_args(argv)
    if args.wandb_flag:
        raise NotImplementedError("wandb logging is not ported (the run has no network); "
                                  "metrics.jsonl and the curve pngs hold the same content")
    import torch

    from .config import get_cfg_defaults
    from .data import CrackDataSetTest, RetinalDataSetTest, TTICrackDataSetTest
    from .engine.inference import calibrate_int8, inference_for_ss, inference_tti
    from .models import model_from_cfg
    from .utils.convert import drop_unused_reference_keys
    from .utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = get_cfg_defaults()
    cfg_path = args.config_file or os.path.join(args.test_dir, "config.yaml")
    if os.path.isfile(cfg_path):
        cfg.merge_from_file(cfg_path)
    if args.test_blured_name:
        cfg.DATASET.TEST_BLURED_NAME = args.test_blured_name
    if args.opts:
        cfg.merge_from_list(args.opts)
    path, tag = weights_path(args.test_dir, args.trained_iter)
    if args.tti_crack_dataset:
        output_dirname = args.output_dirname or os.path.join(
            args.test_dir, "eval", "tti_building", f"{tag}_size64")
        cfg.INPUT.IMAGE_SIZE = [64, 64]
    else:
        output_dirname = args.output_dirname or os.path.join(
            args.test_dir, "eval", cfg.DATASET.TEST_BLURED_NAME, tag)
    retinal = "RetinalSeg" in cfg.DATASET.TEST_IMAGE_DIR
    if retinal and args.origin_img_size:
        cfg.INPUT.IMAGE_SIZE = [560, 560]
    cfg.OUTPUT_DIR = output_dirname
    cfg.freeze()

    model = model_from_cfg(cfg, device=device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model.load_state_dict(drop_unused_reference_keys(sd), strict=True)

    if args.tti_crack_dataset:
        dataset = TTICrackDataSetTest(cfg, cfg.DATASET.TEST_IMAGE_DIR)
        assert len(dataset) > 0, "Dataset size is 0!!"
        if args.int8_serve:
            calibrate_int8(model, dataset.get(0)[0][:args.batch_size], args.int8_scope)
        inference_tti(cfg, model, dataset, output_dir=output_dirname, device=device,
                      max_patches_per_call=args.batch_size)
        return None

    ds_cls = RetinalDataSetTest if retinal else CrackDataSetTest
    dataset = ds_cls(cfg, cfg.DATASET.TEST_IMAGE_DIR, cfg.DATASET.TEST_MASK_DIR,
                     cfg.DATASET.TEST_BLURED_DIR, cfg.DATASET.TEST_BLURED_NAME)
    assert len(dataset) > 0, "Dataset size is 0!!"
    if args.int8_serve:
        calibrate_int8(model, dataset.get(0)[0], args.int8_scope)
    summary = inference_for_ss(
        cfg, model, dataset, output_dir=output_dirname, device=device,
        test_aiu=args.test_aiu, test_surface_distance=args.test_surface_distance,
        surface_distance_device=not args.surface_distance_host,
        test_classification_metrics=args.test_classification_metrics,
        save_images=args.sf_save_image,
    )
    print(summary)
    return summary


if __name__ == "__main__":
    main()
