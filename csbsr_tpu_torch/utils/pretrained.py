"""Pretrained weights at the start of training (`csbsr_tpu/utils/pretrained.py`).

`do_train` calls these before it resumes a run, in the JAX package's order:

1. `load_imagenet_backbones`: the published ImageNet initialisations the
   reference downloads when it builds a model, where a file is present:
   VGG16 (`vgg16*.pth`) into KBPN's `feat` head and U-Net16's encoder,
   ResNet (`<TPU.PSPNET_BACKEND>*.pth`) into PSPNet's `feats` extractor,
   HRNet-W48 (`hrnetv2_w48_imagenet_pretrained.pth`, else `hrnetv2_w48*.pth`)
   into HRNet-OCR's `backbone`, ResNet-101 (`resnet101*.pth`) into DSRL's
   `backbone` when TPU.DSRL_BACKBONE is "resnet". Each is a partial load: the tensors the file
   holds under the torchvision name of a port tensor (the tables below, the
   port's copy of `csbsr_tpu/utils/translators.py:imagenet_*`); a shape that
   disagrees skips that file.
2. `load_pretrained_sr`: the SR network's released or SR-only-pretrained
   weights, `DBPN_pretrain_x<SF>_stage<N>.pth` or
   `KBPN_pretrain_x<SF>_stage<N>.pth` (`..._bicubic<KERNEL_SIZE>.pth` when
   KERNEL_SIZE differs from KERNEL_SIZE_OUTPUT), unless MODEL.SR_SCRATCH. The
   port's modules carry the reference's names, so after `strip_prefixes`
   the file is a strict `load_state_dict` on `sr_model`; a file that lacks a
   tensor of it, or holds one of another shape, is skipped. SrcNetSR has
   no file name here, as in the JAX package (ROADMAP.md, section 3).
3. `load_pretrained_dsrl`: DSRL's released weights, `DSRLx4.pth` with
   MODEL.DSRL_UPSAMPLE "deconv" (the x4 chain), else `DSRL.pth`, unless
   MODEL.SR_SCRATCH; only with the ResNet backbone, the one they hold. After
   stripping `module.` and `parallel_model.` the file is a strict load on
   `parallel_model`, or is skipped as in 2.

Files are looked up in `weights_dir`, by default the reference's relative
`weights/pretrain`, DSRL's one level up (`weights/DSRL.pth`, as in the JAX
package); an absent file is logged and training starts from the random
weights, as in the JAX package. No weights are fetched.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Dict, Optional

import torch

from .convert import _UNET_ENC

__all__ = ["WEIGHTS_DIR", "load_torch_state_dict", "strip_prefixes", "sr_checkpoint_name",
           "load_imagenet_backbones", "load_pretrained_sr", "load_pretrained_dsrl"]

WEIGHTS_DIR = os.path.join("weights", "pretrain")
# torchvision vgg16.features indices of KBPN's feat convs (the reference
# drops vgg16's first max-pool) and of U-Net16's encoder convs
_KBPN_FEAT_VGG_IDX = (0, 2, 5, 7)
_UNET16_VGG_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def strip_prefixes(sd: Dict, words=("module.", "sr_model.")) -> Dict:
    """Each key with every leading word of `words` removed, in order."""
    out = {}
    for k, v in sd.items():
        for w in words:
            if k.startswith(w):
                k = k[len(w):]
        out[k] = v
    return out


def sr_checkpoint_name(cfg) -> Optional[str]:
    sf, n = cfg.MODEL.SCALE_FACTOR, cfg.MODEL.NUM_STAGES
    if cfg.MODEL.SR == "DBPN":
        return f"DBPN_pretrain_x{sf}_stage{n}.pth"
    if cfg.MODEL.SR == "KBPN":
        if cfg.BLUR.KERNEL_SIZE == cfg.BLUR.KERNEL_SIZE_OUTPUT:
            return f"KBPN_pretrain_x{sf}_stage{n}.pth"
        return f"KBPN_pretrain_x{sf}_stage{n}_bicubic{cfg.BLUR.KERNEL_SIZE}.pth"
    return None


def _find_weight(weights_dir: str, *patterns) -> Optional[str]:
    for pat in patterns:
        hits = sorted(glob.glob(os.path.join(weights_dir, pat)))
        if hits:
            return hits[0]
    return None


def _vgg_table(port_idx_to_vgg: Dict[str, int]) -> Callable[[str], Optional[str]]:
    """port key -> vgg16 key, for the port layer prefixes in the table."""
    def name(key):
        layer, _, leaf = key.rpartition(".")
        idx = port_idx_to_vgg.get(layer)
        return None if idx is None else f"features.{idx}.{leaf}"
    return name


def _strip(prefix: str) -> Callable[[str], Optional[str]]:
    return lambda key: key[len(prefix):] if key.startswith(prefix) else None


def _imagenet_jobs(cfg, model, weights_dir):
    """(module, port key -> file key, path, label) of each file present."""
    jobs = []
    sr = getattr(model, "sr_model", None)
    seg = getattr(model, "segmentation_model", None)
    dsrl = getattr(model, "parallel_model", None)
    if dsrl is not None and cfg.TPU.DSRL_BACKBONE == "resnet":
        path = _find_weight(weights_dir, "resnet101*.pth")
        if path:
            jobs.append((dsrl, _strip("backbone."), path, "ResNet101->DSRL.backbone"))
    vgg = _find_weight(weights_dir, "vgg16*.pth")
    if cfg.MODEL.SR == "KBPN" and sr is not None and vgg:
        feat = _vgg_table({f"feat.{2 * i}": v for i, v in enumerate(_KBPN_FEAT_VGG_IDX)})
        jobs.append((sr, feat, vgg, "VGG16->KBPN.feat"))
    det = cfg.MODEL.DETECTOR_TYPE
    if seg is None:
        return jobs
    if det == "u-net16" and vgg:
        enc = _vgg_table({f"{blk}.{j}": v for (blk, j), v in zip(_UNET_ENC, _UNET16_VGG_IDX)})
        jobs.append((seg, enc, vgg, "VGG16->UNet16.encoder"))
    elif det.startswith("PSPNet"):
        backend = str(cfg.TPU.PSPNET_BACKEND)
        path = _find_weight(weights_dir, f"{backend}*.pth") if backend.startswith("resnet") \
            else None
        if path:
            jobs.append((seg, _strip("feats."), path, f"{backend}->PSPNet.feats"))
    elif det == "HRNet_OCR":
        path = _find_weight(weights_dir, "hrnetv2_w48_imagenet_pretrained.pth",
                            "hrnetv2_w48*.pth")
        if path:
            jobs.append((seg, _strip("backbone."), path, "HRNet-W48->OCR.backbone"))
    return jobs


@torch.no_grad()
def load_imagenet_backbones(cfg, model, weights_dir: str = WEIGHTS_DIR, log_fn=print) -> int:
    """Partial loads of the ImageNet backbones found; returns the tensors loaded."""
    total = 0
    for module, file_key, path, label in _imagenet_jobs(cfg, model, weights_dir):
        sd = strip_prefixes(load_torch_state_dict(path))
        own = module.state_dict()
        found = {k: sd[file_key(k)] for k in own
                 if not k.endswith("num_batches_tracked") and file_key(k) in sd}
        bad = [(k, tuple(v.shape)) for k, v in found.items() if v.shape != own[k].shape]
        if bad:
            log_fn(f"(ImageNet init {label} from {path} failed: shape mismatch at {bad[0][0]}: "
                   f"file {bad[0][1]} vs model {tuple(own[bad[0][0]].shape)}; skipping)")
            continue
        module.load_state_dict(found, strict=False)
        total += len(found)
        log_fn(f"ImageNet init: {label} from {path} ({len(found)} tensors)")
    return total


def _load_whole(module, sd, path, what, log_fn) -> bool:
    """A strict load of `sd` on `module` when it holds every tensor of it
    (the BatchNorm step counters aside) at its shape; else logged, False."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    bad = [k for k in own if k in sd and sd[k].shape != own[k].shape]
    if missing or bad:
        log_fn(f"(pretrained {what} conversion incomplete: {len(missing)} tensors missing, "
               f"{len(bad)} of another shape, e.g. {(missing + bad)[:3]}; training from scratch)")
        return False
    module.load_state_dict({k: sd.get(k, v) for k, v in own.items()}, strict=True)
    log_fn(f"{what} pretrained model was loaded from {path}")
    return True


@torch.no_grad()
def load_pretrained_sr(cfg, model, weights_dir: str = WEIGHTS_DIR, log_fn=print) -> bool:
    """The SR network's pretrained weights, when found; returns whether loaded."""
    name = sr_checkpoint_name(cfg)
    if cfg.MODEL.SR_SCRATCH or name is None or not hasattr(model, "sr_model"):
        return False
    path = os.path.join(weights_dir, name)
    if not os.path.isfile(path):
        log_fn(f"(pretrained SR weights not found at {path}; training from scratch)")
        return False
    return _load_whole(model.sr_model, strip_prefixes(load_torch_state_dict(path)), path, "SR",
                       log_fn)


@torch.no_grad()
def load_pretrained_dsrl(cfg, model, weights_dir: str = os.path.dirname(WEIGHTS_DIR),
                         log_fn=print) -> bool:
    """DSRL's released weights, when found; returns whether loaded."""
    if not hasattr(model, "parallel_model") or cfg.MODEL.SR_SCRATCH:
        return False
    if cfg.TPU.DSRL_BACKBONE != "resnet":
        log_fn(f"(DSRL backbone {cfg.TPU.DSRL_BACKBONE!r}: released weights not applicable)")
        return False
    path = os.path.join(weights_dir,
                        "DSRLx4.pth" if cfg.MODEL.DSRL_UPSAMPLE == "deconv" else "DSRL.pth")
    if not os.path.isfile(path):
        log_fn(f"(pretrained DSRL weights not found at {path}; training from scratch)")
        return False
    sd = strip_prefixes(load_torch_state_dict(path), ("module.", "parallel_model."))
    return _load_whole(model.parallel_model, sd, path, "DSRL", log_fn)
