"""The flagship recipe, `configs/config_csbsr_pspnet.yaml`, without PyYAML.

KBPN 4 stages x4 (md 128, predicted kernel 7 -> applied kernel 21),
instance-norm, PSPNet with the dilated ResNet-34, IMAGE_SIZE 224, bf16
compute. The model keys are set by attribute so a run needs no PyYAML; where
PyYAML imports and the file is present, the file must agree.
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
    ("SOLVER", "NORM_SR_OUTPUT"): "instance",
    ("BLUR", "KERNEL_SIZE"): 7,
    ("BLUR", "KERNEL_SIZE_OUTPUT"): 21,
    ("INPUT", "IMAGE_SIZE"): [224, 224],
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
