"""Carry JAX-package weights into the port's state dict.

Input: the nested dicts of numpy arrays that `jax.device_get` returns for a
`CSBSRModel`'s `params` and `batch_stats`. Output: a torch state dict in the
original CSBSR torch names, which the port's modules carry, so
`load_state_dict(strict=True)` reports nothing missing or unexpected and a
released reference `.pth` loads the same way.

The name translators are this package's own copies of
`csbsr_tpu/utils/translators.py:translate_kbpn/translate_pspnet`, for the
flagship modules; the layout rules are those of
`csbsr_tpu/utils/torch_convert.py:export_params_to_torch_names`:
conv HWIO -> OIHW, the same permutation for transposed convs
((kh, kw, O, I) -> (I, O, kh, kw)), Dense (I, O) -> (O, I), PReLU scalar
alpha -> shape (1,).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["translate_kbpn", "translate_pspnet", "convert_tree", "state_dict_from_jax"]

_KIND = {"kernel": "kernel", "bias": "bias", "scale": "scale", "alpha": "alpha",
         "mean": "mean", "var": "var"}


def _block_leaf(seg: str, kind: str) -> Optional[str]:
    """BlockBase family: conv in `.layer`, activation in `.act` (the flagship
    KBPN has no norm inside a block)."""
    if seg in ("conv", "deconv"):
        return {"kernel": "layer.weight", "bias": "layer.bias"}[kind]
    if seg.startswith("PReLU"):
        return "act.weight"
    return None


def translate_kbpn(path: Tuple, kind: str) -> Optional[str]:
    """KBPN flax path -> torch key; stages live in
    back_projection_stages.<s-1>.{up,kb,down,sft}."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None

    def leaf(i):
        return _block_leaf(p[i], kind) if len(p) > i else None

    head = p[0]
    if head == "feat":
        m = re.match(r"conv(\d)", p[1])
        suffix = "weight" if kind == "kernel" else "bias"
        return f"feat.{int(m.group(1)) * 2}.{suffix}" if m else None
    if head == "predictor":
        m = re.match(r"feat_ext(\d)", p[1])
        lf = leaf(2) if m else None
        return f"predictor.feat_ext.{m.group(1)}.{lf}" if lf else None
    if head == "output_conv":
        lf = leaf(1)
        return f"output_conv.{lf}" if lf else None
    m = re.match(r"stage(\d+)_(up|down|kb|sft)", head)
    if not m:
        return None
    part = m.group(2)
    base = f"back_projection_stages.{int(m.group(1)) - 1}.{part}"
    if part == "sft":
        return f"{base}.{p[1]}.{'weight' if kind == 'kernel' else 'bias'}"
    sub = p[1]
    if part in ("up", "down") or sub in ("sr_reconst", "up_conv1", "conv"):
        lf = leaf(2)
        return f"{base}.{sub}.{lf}" if lf else None
    if sub == "kernel_predictor":
        m2 = re.match(r"(fe_SR|fe_kernel|fe_cat)(\d)", p[2])
        lf = leaf(3) if m2 else None
        return f"{base}.kernel_predictor.{m2.group(1)}.{m2.group(2)}.{lf}" if lf else None
    return None


def translate_pspnet(path: Tuple, kind: str) -> Optional[str]:
    """PSPNet (resnet backends) flax path -> torch key."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None
    head = p[0]
    suffix = {"kernel": "weight", "bias": "bias", "scale": "weight",
              "mean": "running_mean", "var": "running_var", "alpha": "weight"}[kind]
    if head == "feats":
        sub = p[1]
        if sub in ("conv1", "bn1"):
            return f"feats.{sub}.{suffix}"
        m = re.match(r"layer(\d)_(\d+)", sub)
        if m:
            inner = {"downsample_conv": "downsample.0",
                     "downsample_bn": "downsample.1"}.get(p[2], p[2])
            return f"feats.layer{m.group(1)}.{m.group(2)}.{inner}.{suffix}"
        return None
    if head == "psp":
        m = re.match(r"stage(\d)", p[1])
        if m:
            return f"psp.stages.{m.group(1)}.1.{suffix}"
        return f"psp.bottleneck.{suffix}" if p[1] == "bottleneck" else None
    m = re.match(r"up_(\d)", head)
    if m:
        idx = {"conv": 0, "bn": 1, "prelu": 2, "PReLU_0": 2}.get(p[1])
        return f"up_{m.group(1)}.conv.{idx}.{suffix}"
    if head == "final":
        return f"final.0.{suffix}"
    if head == "aux":
        return f"aux.{ {'conv0': 0, 'bn': 1, 'conv1': 4}[p[1]] }.{suffix}"
    return None


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(w: np.ndarray, kind: str) -> np.ndarray:
    if kind == "kernel" and w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if kind == "kernel" and w.ndim == 2:
        return np.transpose(w, (1, 0))
    if kind == "alpha":
        return w.reshape(1)
    return w


_TRANSLATORS = {"sr_model": translate_kbpn, "segmentation_model": translate_pspnet}


def convert_tree(params: Dict, batch_stats: Optional[Dict],
                 translate) -> Dict[str, torch.Tensor]:
    """One module's JAX variables -> its torch state dict, through
    `translate(path, kind)`. Every leaf must translate; BatchNorm layers also
    get the `num_batches_tracked` counter torch keeps (0: eval reads the
    running statistics only)."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, leaf in _flatten(tree):
            kind = _KIND[path[-1]]
            key = translate(path, kind)
            if key is None:
                raise KeyError(f"no torch name for JAX leaf {'/'.join(map(str, path))}")
            w = _to_torch_layout(np.asarray(leaf, dtype=np.float32), kind)
            sd[key] = torch.from_numpy(np.ascontiguousarray(w))
    for key in [k for k in sd if k.endswith(".running_mean")]:
        sd[key[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return sd


def state_dict_from_jax(params: Dict, batch_stats: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """JAX `CSBSRModel` variables -> the port's `CSBSRModel` state dict."""
    batch_stats = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}
    for top, tree in params.items():
        if top not in _TRANSLATORS:
            raise KeyError(f"no torch module for JAX submodule {top!r}")
        sub = convert_tree(tree, batch_stats.get(top), _TRANSLATORS[top])
        sd.update({f"{top}.{k}": v for k, v in sub.items()})
    return sd
