"""Evaluation CLI of the port: python -m csbsr_tpu_torch.test.

Mirrors the root `test.py` (the JAX package's): the config comes from
`<test_dir>/config.yaml` (or --config_file) plus trailing `KEY VALUE`
overrides, the output goes to <test_dir>/eval/<TEST_BLURED_NAME>/<tag>, and
the harness scores PSNR/SSIM/kernel PSNR, AIU and, with
--test_surface_distance, HD/MSD on the device. Weights are a torch state
dict in the reference's names: <test_dir>/checkpoints/<iter>.pth for an
iteration number, else <test_dir>/<weight_name> (parameters a reference
checkpoint holds but never uses, CrackFormer's down{3,4,5}.nn3, are dropped
before the strict load). As with the root test.py,
flags go before the positionals: everything after them is read as
`KEY VALUE` overrides.

  python -m csbsr_tpu_torch.test --test_surface_distance [--device cuda] \\
      <test_dir> <iter|weight_name> [KEY VALUE ...]
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
    # reference polarity: images are saved by default; the flag turns it off
    p.add_argument("--sf_save_image", action="store_false", default=True,
                   help="If you do not want the output images to be saved, pass this flag.")
    p.add_argument("--test_blured_name", type=str, default="")
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
    import torch

    from .config import get_cfg_defaults
    from .data import CrackDataSetTest
    from .engine.inference import inference_for_ss
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
    output_dirname = args.output_dirname or os.path.join(
        args.test_dir, "eval", cfg.DATASET.TEST_BLURED_NAME, tag)
    cfg.OUTPUT_DIR = output_dirname
    cfg.freeze()

    model = model_from_cfg(cfg, device=device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model.load_state_dict(drop_unused_reference_keys(sd), strict=True)

    dataset = CrackDataSetTest(cfg, cfg.DATASET.TEST_IMAGE_DIR, cfg.DATASET.TEST_MASK_DIR,
                               cfg.DATASET.TEST_BLURED_DIR, cfg.DATASET.TEST_BLURED_NAME)
    assert len(dataset) > 0, "Dataset size is 0!!"
    summary = inference_for_ss(
        cfg, model, dataset, output_dir=output_dirname, device=device,
        test_aiu=args.test_aiu, test_surface_distance=args.test_surface_distance,
        save_images=args.sf_save_image,
    )
    print(summary)
    return summary


if __name__ == "__main__":
    main()
