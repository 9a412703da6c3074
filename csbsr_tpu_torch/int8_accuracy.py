"""How far int8 serving moves a model's outputs from its bf16 ones.

    python -m csbsr_tpu_torch.int8_accuracy [--config_file CFG] [--weights PTH]
        [--batch 32] [--scope all|narrow] [--device cuda]

Runs the model (the flagship recipe, or CFG) twice on the same seeded 56x56
LR patches: in its compute dtype, then with int8 convs calibrated on those
patches (engine/inference.calibrate_int8). Prints one JSON line: SR PSNR of
the bf16 output against the int8 one, the IoU of the two seg maps
thresholded at 0.5, the largest seg probability deviation, the kernel PSNR
and the count of int8 convs. Without --weights the weights are random (from
the config's seed): that bounds the numeric error of the int8 path, but a
statement about serving accuracy needs trained weights.
"""
from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

PATCH = 56  # LR patch side


def _psnr(a: torch.Tensor, b: torch.Tensor) -> float:
    mse = float(torch.mean((a.double() - b.double()) ** 2))
    return math.inf if mse == 0 else 10.0 * math.log10(1.0 / mse)


def compare(ref: dict, q: dict) -> dict:
    """How far outputs `q` are from `ref` (dicts with "sr", "seg" and
    optionally "kernel"): SR PSNR (both clipped to [0, 1]), IoU of the seg
    maps thresholded at 0.5, the largest seg deviation, kernel PSNR."""
    seg_ref, seg_q = ref["seg"].float() > 0.5, q["seg"].float() > 0.5
    union = int((seg_ref | seg_q).sum())
    out = {
        "sr_psnr_bf16_vs_int8": _psnr(ref["sr"].float().clamp(0, 1), q["sr"].float().clamp(0, 1)),
        "seg_agreement_iou@0.5": int((seg_ref & seg_q).sum()) / union if union else 1.0,
        "seg_max_prob_deviation": float((ref["seg"].float() - q["seg"].float()).abs().max()),
    }
    if "kernel" in ref:
        out["kernel_psnr"] = _psnr(ref["kernel"].float(), q["kernel"].float())
    return out


@torch.inference_mode()
def agreement(model, patches: torch.Tensor, scope: str = "all"):
    """bf16 (the model's compute dtype) against int8 on `patches`; leaves
    the model serving int8. Returns `compare`'s dict and the int8 conv count."""
    from .engine.inference import calibrate_int8
    from .models.blocks import int8_modules

    ref = model(patches, clip_sr=True)
    calibrate_int8(model, patches, scope)
    out = compare(ref, model(patches, clip_sr=True))
    return {**out, "int8_convs": len(int8_modules(model)), "scope": scope}


def run(config_file=None, weights=None, batch=32, scope="all", device=None):
    """Build the model (random weights from the config's seed, or the
    `weights` state dict), measure `agreement` on `batch` seeded patches."""
    from .config import get_cfg_defaults
    from .config.flagship import flagship_cfg
    from .models import model_from_cfg
    from .utils.convert import drop_unused_reference_keys
    from .utils.device import resolve_device

    dev = resolve_device(device)
    if config_file:
        cfg = get_cfg_defaults()
        cfg.merge_from_file(config_file)
    else:
        cfg = flagship_cfg()
    model = model_from_cfg(cfg, device=dev)
    if weights:
        sd = torch.load(weights, map_location="cpu", weights_only=True)
        model.load_state_dict(drop_unused_reference_keys(sd), strict=True)
    x = np.random.RandomState(0).rand(batch, 3, PATCH, PATCH).astype(np.float32)
    out = agreement(model, torch.from_numpy(x).to(dev), scope)
    out.update(weights="checkpoint" if weights else f"random-init (seed {cfg.SEED})",
               model=f"{cfg.MODEL.SR} + {cfg.MODEL.DETECTOR_TYPE}", dtype=str(model.dtype)[6:],
               device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config_file", default=None)
    ap.add_argument("--weights", default=None, help="a torch state dict (.pth) in reference names")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--scope", choices=("all", "narrow"), default="all")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.config_file, args.weights, args.batch, args.scope, args.device)
    print(json.dumps({k: (str(v) if isinstance(v, float) and not math.isfinite(v) else v)
                      for k, v in out.items()}))
    return out


if __name__ == "__main__":
    main()
