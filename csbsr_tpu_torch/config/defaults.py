"""Default configuration tree.

Key-for-key copy of `csbsr_tpu/config/defaults.py`, `TPU.*` included, so
every `configs/*.yaml` and every saved `config.yaml` merges into the port
unchanged. The port reads `TPU.COMPUTE_DTYPE` as its compute dtype (params
stay float32) and `TPU.PSPNET_BACKEND` for the PSPNet extractor; the other
`TPU.*` keys configure the JAX package only.
"""
from .node import CfgNode as CN

_C = CN()
_C.DEVICE = "tpu"  # kept for schema parity; the port takes `device` explicitly

_C.MODEL = CN()
_C.MODEL.SCALE_FACTOR = 4
_C.MODEL.DETECTOR_TYPE = "u-net16"
_C.MODEL.SR = "DBPN"
_C.MODEL.UP_SAMPLE_METHOD = "deconv"
_C.MODEL.DETECTOR_DBPN_NUM_STAGES = 4
_C.MODEL.OPTIMIZER = "Adam"
_C.MODEL.NUM_CLASSES = 1
_C.MODEL.NUM_STAGES = 4
_C.MODEL.SR_SEG_INV = False
_C.MODEL.JOINT_LEARNING = True
_C.MODEL.SR_RESIDUAL_LEARNING = True
_C.MODEL.KBPN_KERNEL_SFT = True
_C.MODEL.SR_PIXEL_SHUFFLE = False
_C.MODEL.SR_SCRATCH = False
_C.MODEL.DSRL_UPSAMPLE = "bilinear"
_C.MODEL.SUM_LR_ERROR_POS = "HR"
_C.MODEL.ZERO_PAD_KERNEL = False

_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 300000
_C.SOLVER.TRAIN_DATASET_RATIO = 0.95
_C.SOLVER.SR_PRETRAIN_ITER = [1, 150001]
_C.SOLVER.SR_SR_MODULE_PRETRAIN_ITER = [1, 50001]
_C.SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER = [50001, 100000]
_C.SOLVER.ONLY_KERNEL_LOSS_FOR_PRETRAIN = False

_C.SOLVER.SEG_PRETRAIN_ITER = [0, 0]
_C.SOLVER.BATCH_SIZE = 8

_C.SOLVER.TASK_LOSS_WEIGHT = 0.5
_C.SOLVER.INCRESE_TASK_W_ITER = [30000, 170000]
_C.SOLVER.SEG_LOSS_FUNC = "Dice"
_C.SOLVER.BOUNDARY_DEC_RATIO = 1.0
_C.SOLVER.WB_AND_D_WEIGHT = [1, 1]
_C.SOLVER.BCELOSS_WEIGHT = [20, 1]
_C.SOLVER.SEG_AUX_LOSS_WEIGHT = 0.4
_C.SOLVER.SEG_MAIN_LOSS_WEIGHT = 1.0
_C.SOLVER.DSRL_FA_WEIGHT = 0.5
_C.SOLVER.DSRL_SR_WEIGHT = 0.5
_C.SOLVER.DSRL_SEG_WEIGHT = 1.0

_C.SOLVER.ORIENTED_WEIGHT_GAUS = 2
_C.SOLVER.ORIENTED_WEIGHT_ITER = -1
_C.SOLVER.CRACK_ORIENTED_WEIGHT4SR_AMP = 0.0
_C.SOLVER.CRACK_ORIENTED_WEIGHT4SR_BIAS = 1.0
_C.SOLVER.CRACK_ORIENTED_WEIGHT4SS_AMP = 0.0
_C.SOLVER.CRACK_ORIENTED_WEIGHT4SS_BIAS = 1.0
_C.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SR_AMP = 0.0
_C.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SR_BIAS = 1.0
_C.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SS_AMP = 0.0
_C.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SS_BIAS = 1.0
_C.SOLVER.INTERM_SSLOSSWEGHT4SR = False

_C.SOLVER.SR_LOSS_FUNC = "L1"
# the 4-element value (comma for decimal point) is the recipe schema's own;
# only [0:3] are read
_C.SOLVER.SR_LOSS_FUNC_SR_WEIGHT = [0.4, 0.4, 0, 2]

_C.SOLVER.LR_LOSS_FUNC = "L1"
_C.SOLVER.ALPHA_MIN = 0.01
_C.SOLVER.DECREASE_RATIO = 1.0
_C.SOLVER.SYNC_BATCHNORM = True
_C.SOLVER.NORM_SR_OUTPUT = "all"  # 'all' | 'instance' | '' (none)
_C.SOLVER.LR = 1e-3
_C.SOLVER.LR_STEPS = []
_C.SOLVER.SCHEDULER = True
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.WARMUP_FACTOR = 1.0
_C.SOLVER.WARMUP_ITERS = 5000
_C.SOLVER.DOWNSCALE_INTERPOLATION = "bicubic"

_C.BLUR = CN()
_C.BLUR.FLAG = True
_C.BLUR.KERNEL_SIZE = 21  # size predicted by the network
_C.BLUR.KERNEL_SIZE_OUTPUT = 21  # size applied to images (upsampled if !=)
_C.BLUR.ISOTROPIC = False
_C.BLUR.MODE = "gaus"
_C.BLUR.SIGMA_RANGE = [0.2, 4.0]
_C.BLUR.SIGMA_RANGE2 = []
_C.BLUR.RATIO_RANGE = [0.1, 1.0]

_C.INPUT = CN()
_C.INPUT.IMAGE_SIZE = [448, 448]  # H x W
_C.INPUT.MEAN = [0.4741, 0.4937, 0.5048]
_C.INPUT.STD = [0.1621, 0.1532, 0.1523]

_C.DATASET = CN()
_C.DATASET.ONLY_IMAGES = False
_C.DATASET.DATA_AUGMENTATION = [
    ["ConvertFromInts", None],
    ["RandomMirror", None],
    ["ToTensor", None],
    ["RandomVerticalFlip", {"p": 0.3}],
    ["RandomResizedCrop", {"scale": (1.0, 1.0), "ratio": (1.0, 1.0)}],
]
_C.DATASET.TRAIN_IMAGE_DIR = "datasets/crack_segmentation_dataset/train/images"
_C.DATASET.TRAIN_MASK_DIR = "datasets/crack_segmentation_dataset/train/masks"
_C.DATASET.TEST_IMAGE_DIR = "datasets/crack_segmentation_dataset/test_blured/gt/images"
_C.DATASET.TEST_MASK_DIR = "datasets/crack_segmentation_dataset/test_blured/gt/masks"
_C.DATASET.TEST_BLURED_DIR = "datasets/crack_segmentation_dataset/test_blured/"
_C.DATASET.TEST_BLURED_NAME = "02_40"

_C.OUTPUT_DIR = "output/CSSR_SR-SS"
_C.SEED = 1121

_C.BASE_NET = "weights/vgg16_reducedfc.pth"

# JAX-package knobs, kept so saved configs merge; see the module docstring
_C.TPU = CN()
_C.TPU.MESH_SHAPE = [-1]
_C.TPU.MESH_AXES = ["data"]
_C.TPU.COMPUTE_DTYPE = "bfloat16"  # conv/matmul compute dtype
_C.TPU.PARAM_DTYPE = "float32"
_C.TPU.REMAT = False
_C.TPU.REMAT_SCOPE = "full"
_C.TPU.REMAT_SEG = False
_C.TPU.OPT_MU_DTYPE = "float32"
_C.TPU.ZERO1 = ""
_C.TPU.DEGRADE_ON_DEVICE = True
_C.TPU.ORIENTED_WEIGHT_VARIANT = "exp"
_C.TPU.DSRL_BACKBONE = "resnet"
_C.TPU.PSPNET_BACKEND = "resnet34"


def get_cfg_defaults() -> CN:
    return _C.clone()
