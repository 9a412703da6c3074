"""Carry JAX-package weights into the port's state dict.

Input: the nested dicts of numpy arrays that `jax.device_get` returns for a
`CSBSRModel`'s `params` and `batch_stats`. Output: a torch state dict in the
original CSBSR torch names, which the port's modules carry, so
`load_state_dict(strict=True)` reports nothing missing or unexpected and a
released reference `.pth` loads the same way.

The name translators are this package's own copies of
`csbsr_tpu/utils/translators.py`: translate_kbpn, translate_dbpn,
translate_unet16, translate_pspnet (with the BlurSkip ladder),
translate_hrnet_ocr (the HRNetW48OCR head) and translate_crackformer; which
one a submodule takes is read off its tree (`_translator_for`). The layout
rules are those of
`csbsr_tpu/utils/torch_convert.py:export_params_to_torch_names`:
conv HWIO -> OIHW, the same permutation for transposed convs
((kh, kw, O, I) -> (I, O, kh, kw)), Dense (I, O) -> (O, I), PReLU scalar
alpha -> shape (1,), CrackFormer's positional embedding (m, m, 1, kk) ->
(kk, 1, 1, m, m).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["translate_kbpn", "translate_dbpn", "translate_unet16", "translate_pspnet",
           "translate_hrnet_ocr", "translate_crackformer", "convert_tree",
           "state_dict_from_jax", "drop_unused_reference_keys"]

_KIND = {"kernel": "kernel", "bias": "bias", "scale": "scale", "alpha": "alpha",
         "mean": "mean", "var": "var", "embedding": "embedding"}
_SFX = {"kernel": "weight", "embedding": "weight", "bias": "bias", "scale": "weight",
        "mean": "running_mean", "var": "running_var", "alpha": "weight"}


def _block_leaf(seg: str, kind: str) -> Optional[str]:
    """BlockBase family: conv in `.layer`, BatchNorm in `.norm`, activation
    in `.act`."""
    if seg in ("conv", "deconv"):
        return {"kernel": "layer.weight", "bias": "layer.bias"}[kind]
    if seg.startswith("PReLU"):
        return "act.weight"
    if seg.startswith("BatchNorm"):
        return {"scale": "norm.weight", "bias": "norm.bias", "mean": "norm.running_mean",
                "var": "norm.running_var"}[kind]
    return None


def _base_networks_leaf(seg: str, kind: str) -> Optional[str]:
    """base_networks family (DBPN): conv in `.conv`, deconv in `.deconv`,
    activation in `.act`."""
    if seg in ("conv", "deconv"):
        return f"{seg}.{_SFX[kind]}"
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
    suffix = _SFX[kind]
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
    # the BlurSkip ladder: SFT blocks at even, ConvBlocks at odd indices
    m = re.match(r"blur_skip_sft(\d+)", head)
    if m:
        mb = re.match(r"(conv_scale|conv_shift)(\d)", p[1])
        lf = _block_leaf(p[2], kind) if mb else None
        return f"blur_skip.{2 * int(m.group(1))}.{mb.group(1)}.{mb.group(2)}.{lf}" if lf else None
    m = re.match(r"blur_skip_conv(\d+)", head)
    if m:
        lf = _block_leaf(p[1], kind)
        return f"blur_skip.{2 * int(m.group(1)) + 1}.{lf}" if lf else None
    return None


def translate_dbpn(path: Tuple, kind: str) -> Optional[str]:
    """DBPN flax path -> torch key (feat0/feat1/output_conv, up<t>, down<t>)."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None
    if p[0] in ("feat0", "feat1", "output_conv"):
        lf = _base_networks_leaf(p[1], kind)
        return f"{p[0]}.{lf}" if lf else None
    if re.match(r"(up|down)\d+$", p[0]) and len(p) > 2:
        lf = _base_networks_leaf(p[2], kind)
        return f"{p[0]}.{p[1]}.{lf}" if lf else None
    return None


_UNET_ENC = ([("conv1", 0), ("conv1", 2), ("conv2", 0), ("conv2", 2)]
             + [(f"conv{b}", j) for b in (3, 4, 5) for j in (0, 2, 4)])


def translate_unet16(path: Tuple, kind: str) -> Optional[str]:
    """UNet16 flax path -> torch key: enc<i> -> conv<b>.<seq index>, the
    decoders' `block` Sequentials, dec1.conv, final."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None
    head, suffix = p[0], _SFX[kind]
    m = re.match(r"enc(\d+)$", head)
    if m:
        blk, idx = _UNET_ENC[int(m.group(1))]
        return f"{blk}.{idx}.{suffix}"
    if head in ("center", "dec4", "dec3", "dec2") and len(p) > 1:
        inner = {"conv": "0.conv", "deconv": "1", "conv1": "1.conv", "conv2": "2.conv"}.get(p[1])
        return f"{head}.block.{inner}.{suffix}" if inner else None
    if head == "dec1":
        return f"dec1.conv.{suffix}"
    if head == "final":
        return f"final.{suffix}"
    return None


def _oab_leaf(seg: str, sfx: str) -> Optional[str]:
    """ObjectAttention leaf: each f_{pixel,object,down,up} interleaves Conv2d
    and BNReLU = Sequential(BN, ReLU): conv i at slot 2i, bn i at 2i+1 (.0)."""
    m = re.match(r"(f_pixel|f_object|f_down|f_up)_(conv|bn)(\d)$", seg)
    if not m:
        return None
    name, kindc, i = m.groups()
    slot = 2 * int(i) + (0 if kindc == "conv" else 1)
    return f"{name}.{slot}.{sfx}" if kindc == "conv" else f"{name}.{slot}.0.{sfx}"


def translate_hrnet_ocr(path: Tuple, kind: str) -> Optional[str]:
    """HRNetW48OCR flax path -> torch key: backbone (conv1/bn1/conv2/bn2,
    layer1.<b>, transition<t>.<i>[.<j>], stage<s>.<m>.branches.<i>.<b> and
    .fuse_layers.<i>.<j>[.<k>]) and the OCR head (aux_head, conv3x3,
    ocr_distri_head, cls_head)."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None
    sfx, head = _SFX[kind], p[0]
    ds = {"ds_conv": "downsample.0", "ds_bn": "downsample.1"}
    if head == "backbone":
        sub = p[1]
        if sub in ("conv1", "bn1", "conv2", "bn2"):
            return f"backbone.{sub}.{sfx}"
        m = re.match(r"layer1_(\d+)$", sub)
        if m:
            return f"backbone.layer1.{m.group(1)}.{ds.get(p[2], p[2])}.{sfx}"
        m = re.match(r"transition(\d)_(\d+)_(conv|bn)(\d*)$", sub)
        if m:
            t, i, kindc, j = m.groups()
            slot = "0" if kindc == "conv" else "1"
            return f"backbone.transition{t}.{i}.{j + '.' if j else ''}{slot}.{sfx}"
        m = re.match(r"stage(\d)_m(\d+)$", sub)
        if m:
            base = f"backbone.stage{m.group(1)}.{m.group(2)}"
            mb = re.match(r"branch(\d+)_block(\d+)$", p[2])
            if mb:
                return f"{base}.branches.{mb.group(1)}.{mb.group(2)}.{ds.get(p[3], p[3])}.{sfx}"
            mf = re.match(r"fuse(\d+)_(\d+)_(conv|bn)(\d*)$", p[2])
            if mf:
                i, j, kindc, k = mf.groups()
                slot = "0" if kindc == "conv" else "1"
                return f"{base}.fuse_layers.{i}.{j}.{k + '.' if k else ''}{slot}.{sfx}"
        return None
    table = {"aux_conv0": "aux_head.0", "aux_bn": "aux_head.1.0", "aux_conv1": "aux_head.2",
             "conv3x3": "conv3x3.0", "conv3x3_bn": "conv3x3.1.0", "cls_head": "cls_head"}
    if head in table:
        return f"{table[head]}.{sfx}"
    if head == "ocr_distri_head":
        if p[1] == "conv":
            return f"ocr_distri_head.conv_bn_dropout.0.{sfx}"
        if p[1] == "bn":
            return f"ocr_distri_head.conv_bn_dropout.1.0.{sfx}"
        t = _oab_leaf(p[2], sfx) if p[1] == "oab" else None
        return f"ocr_distri_head.object_context_block.{t}" if t else None
    return None


def translate_crackformer(path: Tuple, kind: str) -> Optional[str]:
    """CrackFormer flax path -> torch key: TransEB <stage>_nn<i> ->
    <stage>.nn<i>.conv (the Bottleneck), its TFBlock at conv2.0, the
    LocalSABlock q/k/v as Sequential(conv, GroupNorm) and the 5-D
    positional embedding; LABlock_<i>, fuse<i>, final."""
    p = [str(x) for x in path[:-1]]
    if not p:
        return None
    sfx, head = _SFX[kind], p[0]
    if head == "final":
        return f"final.{sfx}"
    if head == "down1_nn1":
        return f"down1.nn1.conv.{sfx}"
    m = re.match(r"(down|up)(\d)_nn(\d)$", head)
    if m and len(p) >= 3 and p[1] == "conv":
        base = f"{m.group(1)}{m.group(2)}.nn{m.group(3)}.conv"
        sub = p[2]
        if sub in ("conv1", "bn1", "conv3", "bn3"):
            return f"{base}.{sub}.{sfx}"
        if sub in ("shortcut_conv", "shortcut_gn"):
            return f"{base}.shortcut.{0 if sub == 'shortcut_conv' else 1}.{sfx}"
        if sub == "tf" and len(p) > 3:
            tf = f"{base}.conv2.0"
            if p[3] == "attn":
                if kind == "embedding":
                    return f"{tf}.attn.embedding"
                ma = re.match(r"(queries|keys|values)_(conv|gn)$", p[4])
                return f"{tf}.attn.{ma.group(1)}.{0 if ma.group(2) == 'conv' else 1}.{sfx}" \
                    if ma else None
            if p[3] == "mlp":
                if p[4] == "dwconv":
                    return f"{tf}.mlp.dwconv.dwconv.{sfx}"
                if p[4] in ("fc1", "fc2", "gn1", "gn2", "gn3"):
                    return f"{tf}.mlp.{p[4]}.{sfx}"
        return None
    m = re.match(r"LABlock_(\d)$", head)
    if m:
        sub = {"W1_conv": "W_1.0", "W1_gn": "W_1.1", "psi_conv": "psi.0",
               "psi_gn": "psi.1"}.get(p[1])
        return f"LABlock_{m.group(1)}.{sub}.{sfx}" if sub else None
    m = re.match(r"fuse(\d)$", head)
    if m:
        sub = {"nn_conv": "nn.conv", "conv": "conv"}.get(p[1])
        return f"fuse{m.group(1)}.{sub}.{sfx}" if sub else None
    return None


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(w: np.ndarray, kind: str) -> np.ndarray:
    if kind == "embedding":  # (m, m, 1, kk) -> (kk, 1, 1, m, m)
        return np.transpose(w, (3, 2, 0, 1))[:, :, None]
    if kind == "kernel" and w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if kind == "kernel" and w.ndim == 2:
        return np.transpose(w, (1, 0))
    if kind == "alpha":
        return w.reshape(1)
    return w


def _translator_for(top: str, tree: Dict):
    """The translator of submodule `top`, read off the names in its tree."""
    if top == "sr_model":
        return translate_dbpn if "feat0" in tree else translate_kbpn
    if top == "segmentation_model":
        if "backbone" in tree:
            return translate_hrnet_ocr
        if "enc0" in tree:
            return translate_unet16
        if "down1_nn1" in tree:
            return translate_crackformer
        return translate_pspnet
    raise KeyError(f"no torch module for JAX submodule {top!r}")


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
        sub = convert_tree(tree, batch_stats.get(top), _translator_for(top, tree))
        sd.update({f"{top}.{k}": v for k, v in sub.items()})
    return sd


# parameters a released reference checkpoint holds that its forward never
# uses: CrackFormer's Down3/4/5 declare a third block and call the second twice
_UNUSED_REFERENCE_KEYS = re.compile(r"^(segmentation_model\.)?down[345]\.nn3\.")


def drop_unused_reference_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference state dict without the parameters the port does not
    declare because the reference never uses them (CrackFormer's
    `down{3,4,5}.nn3`), so that a strict load reports nothing unexpected."""
    return {k: v for k, v in sd.items() if not _UNUSED_REFERENCE_KEYS.match(k)}
