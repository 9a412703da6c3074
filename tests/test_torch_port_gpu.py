"""Port: the CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA GPU. The file imports neither JAX nor the JAX package,
so on the card's machine it runs without them:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -q

Tolerance: exact (`torch.equal`); see csbsr_tpu_torch/ops/minplus.py. The
recipes of configs/ other than the flagship (one forward each, full width,
2 KBPN stages, LR 16 x 16) are held against the same weights on the CPU with
TF32 off, in float32 to 1e-3 of each output's largest |value| (the bound
`chip_smoke.py` holds the flagship to) and in float64 to 1e-6.
The shapes are the main paths' ((99, 449, 449) the HD bank, (1, 449, 449)
its GT border, (6, 1, 224, 224) the training SDF) and the edges of the
kernel's launch plan: one row, ragged row and column groups, k split over
the block's warps, the widest row (2896), all-empty slices (the 1e9 cap).
"""
import pytest
import torch

from csbsr_tpu_torch.ops import cuda_build
from csbsr_tpu_torch.ops.edt import _column_distance
from csbsr_tpu_torch.ops.minplus import MAX_W, minplus_rows, minplus_rows_reference


def _column_pass(shape, density, seed=5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _column_distance(torch.rand(shape, generator=gen, device="cuda") < density).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("shape,empty", [
    ((2, 1, 33, 47), False), ((3, 128, 128), False), ((2, 33, 2100), False),
    ((1, 40, 50), True), ((99, 449, 449), False), ((1, 449, 449), False),
    ((6, 1, 224, 224), False), ((6, 1, 224, 224), True), ((1, 1, 1), False), ((7, 31), False),
    ((9, 33), False), ((3, 2896), False), ((64, 2896), False), ((2, 5, 2896), True),
])
def test_minplus_kernel_equals_plain_version_on_cuda(shape, empty):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the min-plus kernel runs only on the card")
    g = _column_pass(shape, 0.0 if empty else 0.03)
    n = cuda_build.LAUNCHES["minplus_rows"]
    out = minplus_rows(g)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["minplus_rows"] == n + 1
    assert torch.equal(out, minplus_rows_reference(g))


@pytest.mark.gpu
def test_minplus_wrapper_rejects_what_the_kernel_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the checks guard the kernel launch")
    g = torch.rand(4, 8, 9, device="cuda")
    with pytest.raises(TypeError):
        minplus_rows(g.double())
    with pytest.raises(ValueError):
        minplus_rows(g.transpose(-1, -2))
    with pytest.raises(ValueError):
        minplus_rows(g[0, 0])
    with pytest.raises(ValueError):
        minplus_rows(torch.rand(2, MAX_W + 1, device="cuda"))



ZOO = [("config_cssr_pspnet", None), ("config_csbsr_unet", None),
       ("config_csbsr_pspnet_blurskip", None),
       ("config_csbsr_pspnet_blurskip", "PSPNet_BlurSkip_origin"),
       ("config_csbsr_pspnet_blurskip", "PSPNet_BlurSkipReduct"),
       ("config_csbsr_crackformer", None), ("config_csbsr_hrnet", None)]
# CrackFormer is held in float64 only: its max-unpool puts each value at its
# window's argmax, and float32 rounding flips near ties between the card and
# the CPU (15% on the seg map in `chip_smoke.py`, where float64 agrees)
ZOO_CASES = [(r, d, t) for r, d in ZOO for t in ("float32", "float64")
             if not (r == "config_csbsr_crackformer" and t == "float32")]
TOLS = {"float32": 1e-3, "float64": 1e-6}


@pytest.mark.gpu
@pytest.mark.parametrize("recipe,detector,dtype", ZOO_CASES)
def test_recipe_forward_on_cuda_equals_cpu(recipe, detector, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the forward runs on the card")
    from pathlib import Path

    from csbsr_tpu_torch.config import get_cfg_defaults
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils.device import full_fp32

    cfg = get_cfg_defaults()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" / f"{recipe}.yaml"))
    cfg.merge_from_list(["MODEL.NUM_STAGES", 2])
    if detector:
        cfg.MODEL.DETECTOR_TYPE = detector
    dt = getattr(torch, dtype)
    outs = {}
    x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(4), dtype=dt)
    for device in ("cpu", "cuda"):
        model = model_from_cfg(cfg, device=device, dtype=dt, seed=3).to(dt)
        logits = {}
        for head in ("cls_head", "aux_head"):  # HRNet-OCR: its sigmoids saturate
            if hasattr(model.segmentation_model, head):
                getattr(model.segmentation_model, head).register_forward_hook(
                    lambda mod, inp, o, k=head: logits.__setitem__(k, o))
        with torch.inference_mode(), full_fp32():
            outs[device] = {**model(x.to(device), clip_sr=True), **logits}
    for key, ref in outs["cpu"].items():
        if ref is None:
            assert outs["cuda"][key] is None
            continue
        scale = float(ref.abs().max())
        err = float((outs["cuda"][key].cpu() - ref).abs().max())
        assert (err / scale if scale else err) <= TOLS[dtype], (key, err, scale)
