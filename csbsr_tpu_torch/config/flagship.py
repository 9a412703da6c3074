"""The flagship recipe, `configs/config_csbsr_pspnet.yaml`, without PyYAML.

KBPN 4 stages x4 (md 128, predicted kernel 7 -> applied kernel 21),
instance-norm, PSPNet with the dilated ResNet-34, IMAGE_SIZE 224, bf16
compute; trained at batch 6 with Adam (lr 2e-5), the BoundaryCombo seg loss,
the KBPN SR loss and beta 0.3, after the SR-pretrain windows. The file's keys
are set by attribute so a run needs no PyYAML; where PyYAML imports and the
file is present, the file must agree.
"""
from __future__ import annotations

from pathlib import Path

from .defaults import get_cfg_defaults

YAML = Path(__file__).resolve().parents[2] / "configs" / "config_csbsr_pspnet.yaml"
_KEYS = {
    ("MODEL", "SR"): "KBPN",
    ("MODEL", "SCALE_FACTOR"): 4,
    ("MODEL", "NUM_STAGES"): 4,
    ("MODEL", "DETECTOR_TYPE"): "PSPNet",
    ("MODEL", "UP_SAMPLE_METHOD"): "pixel_shuffle",
    ("MODEL", "OPTIMIZER"): "Adam",
    ("SOLVER", "MAX_ITER"): 700000,
    ("SOLVER", "BATCH_SIZE"): 6,
    ("SOLVER", "LR"): 2e-5,
    ("SOLVER", "SCHEDULER"): False,
    ("SOLVER", "TASK_LOSS_WEIGHT"): 0.3,
    ("SOLVER", "NORM_SR_OUTPUT"): "instance",
    ("SOLVER", "SEG_LOSS_FUNC"): "BoundaryCombo",
    ("SOLVER", "BCELOSS_WEIGHT"): [1, 1],
    ("SOLVER", "WB_AND_D_WEIGHT"): [1, 1],
    ("SOLVER", "SR_LOSS_FUNC"): "KBPN",
    ("SOLVER", "SR_PRETRAIN_ITER"): [1, 30001],
    ("SOLVER", "SR_SR_MODULE_PRETRAIN_ITER"): [1, 10001],
    ("SOLVER", "SR_KERNEL_MODULE_PRETRAIN_ITER"): [10001, 20001],
    ("BLUR", "FLAG"): True,
    ("BLUR", "KERNEL_SIZE"): 7,
    ("BLUR", "KERNEL_SIZE_OUTPUT"): 21,
    ("INPUT", "IMAGE_SIZE"): [224, 224],
    ("DATASET", "DATA_AUGMENTATION"): [["ConvertFromInts", "None"], ["RandomMirror", "None"],
                                       ["ToTensor", "None"], ["RandomVerticalFlip", 0.3],
                                       ["RandomCrop", "None"]],
    ("TPU", "COMPUTE_DTYPE"): "bfloat16",
}


def flagship_cfg(seed: int = 1121):
    cfg = get_cfg_defaults()
    for (sec, key), value in _KEYS.items():
        cfg[sec][key] = value
    cfg.SEED = seed
    try:
        import yaml  # noqa: F401
    except ImportError:
        return cfg
    if YAML.is_file():
        ref = get_cfg_defaults()
        ref.merge_from_file(str(YAML))
        for sec, key in _KEYS:
            if cfg[sec][key] != ref[sec][key]:
                raise AssertionError(f"{sec}.{key}: {cfg[sec][key]} != {YAML.name} {ref[sec][key]}")
    return cfg
