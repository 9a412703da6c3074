"""Legacy KBPN config tree (the standalone-KBPN TRAINER.* schema).

Key-for-key copy of `csbsr_tpu/config/defaults_kbpn.py`, so KBPN-era YAML
overlays merge into the port without edits. CSBSR itself reads `defaults.py`.
"""
from .node import CfgNode as CN

_CK = CN()

_CK.TRAINER = CN()
_CK.TRAINER.EPOCHS = 200
_CK.TRAINER.BATCH_SIZE = 16
_CK.TRAINER.LR = 1e-4
_CK.TRAINER.GAMMA = 0.1
_CK.TRAINER.SR_PRETRAIN = False
_CK.TRAINER.KERNEL_PRETRAIN = False
_CK.TRAINER.HR_LOSS_WEIGHT = 0.4
_CK.TRAINER.LR_LOSS_WEIGHT = 0.4
_CK.TRAINER.KERNEL_LOSS_WEIGHT = 0.2

_CK.MODEL = CN()
_CK.MODEL.SCALE_FACTOR = 4
_CK.MODEL.NUM_STAGES = 4
_CK.MODEL.KERNEL_SIZE = 21
_CK.MODEL.RESIDUAL_LEARNING = True

_CK.DATASET = CN()
_CK.DATASET.TRAIN_DIR = ""
_CK.DATASET.TEST_DIR = ""

_CK.OUTPUT_DIR = "output/KBPN"
_CK.SEED = 123


def get_kbpn_cfg_defaults() -> CN:
    return _CK.clone()
