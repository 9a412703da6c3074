"""Port: the CUDA kernels against their plain PyTorch versions, on the card.

Skips without a CUDA GPU. The file imports neither JAX nor the JAX package,
so on the card's machine it runs without them:

    python -m pytest tests/test_torch_port_gpu.py --noconftest -q

Tolerance: exact (`torch.equal`); see csbsr_tpu_torch/ops/minplus.py. The
recipes of configs/ other than the flagship (one forward each, full width,
2 KBPN stages, LR 16 x 16) are held against the same weights on the CPU with
TF32 off, in float32 to 1e-3 of each output's largest |value| (the bound
`chip_smoke.py` holds the flagship to) and in float64 to 1e-6, and so are
the paper's other joint baselines (DSRL with each backbone, SegNet,
SrcNetSR; SegNet in float64 only). The int8
convolution's `_int_mm` route (ops/quant.py) equals its float64 plain
version exactly (`torch.equal` on the int32 accumulators) at the serving
configurations: 3x3, 1x1, 7x7 s2, dilated, k8 s4, grouped, and the k8 s4 p2
and k4 s2 p1 transposed convs. The int8 quantizers give the CPU's int8
values and float32 scales exactly.
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


_DSRL = ["MODEL.SR", "DSRL", "MODEL.DETECTOR_TYPE", "DSRL"]
# the paper's other joint baselines: overrides of the flagship recipe
BASELINES = {"dsrl_resnet": _DSRL, "dsrl_resnet_deconv": _DSRL + ["MODEL.DSRL_UPSAMPLE", "deconv"],
             "dsrl_drn": _DSRL + ["TPU.DSRL_BACKBONE", "drn"],
             "dsrl_mobilenet": _DSRL + ["TPU.DSRL_BACKBONE", "mobilenet"],
             "dsrl_xception": _DSRL + ["TPU.DSRL_BACKBONE", "xception"],
             "segnet": ["MODEL.DETECTOR_TYPE", "SegNet"], "srcnet": ["MODEL.SR", "SrcNetSR"]}
# SegNet is held in float64 only, for CrackFormer's reason (its max-unpool)
BASELINE_CASES = [(n, t) for n in BASELINES for t in ("float32", "float64")
                  if not (n == "segnet" and t == "float32")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", BASELINE_CASES)
def test_baseline_forward_on_cuda_equals_cpu(name, dtype):
    """DSRL (each backbone), KBPN + SegNet and SrcNetSR + PSPNet at full
    width, LR 16 x 16, eval: the card against the same weights on the CPU,
    TF32 off, to 1e-3 (float32) and 1e-6 (float64) of each output's largest
    |value|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the forward runs on the card")
    from pathlib import Path

    from csbsr_tpu_torch.config import get_cfg_defaults
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils.device import full_fp32

    cfg = get_cfg_defaults()
    cfg.merge_from_file(str(Path(__file__).resolve().parents[1] / "configs" /
                            "config_csbsr_pspnet.yaml"))
    cfg.merge_from_list(BASELINES[name])
    dt = getattr(torch, dtype)
    x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(4), dtype=dt)
    outs = {}
    for device in ("cpu", "cuda"):
        model = model_from_cfg(cfg, device=device, dtype=dt, seed=3).to(dt)
        with torch.inference_mode(), full_fp32():
            outs[device] = model(x.to(device), clip_sr=True)
    assert set(outs["cpu"]) == set(outs["cuda"])
    for key, ref in outs["cpu"].items():
        if ref is None:
            assert outs["cuda"][key] is None
            continue
        scale = float(ref.abs().max())
        err = float((outs["cuda"][key].cpu() - ref).abs().max())
        assert (err / scale if scale else err) <= TOLS[dtype], (key, err, scale)


# (kind, Cin, Cout, k, stride, padding, dilation, groups, N, H): the int8
# conv configurations of the six recipes' serving paths, at small sizes
INT8_CASES = [("conv", 128, 128, 3, 1, 1, 1, 1, 3, 14), ("conv", 3, 64, 3, 1, 1, 1, 1, 2, 16),
              ("conv", 64, 1, 1, 1, 0, 1, 1, 2, 16), ("conv", 3, 64, 7, 2, 3, 1, 1, 2, 32),
              ("conv", 128, 128, 3, 1, 2, 2, 1, 2, 8), ("conv", 128, 128, 8, 4, 2, 1, 1, 2, 32),
              ("conv", 64, 64, 3, 1, 1, 1, 16, 2, 8), ("conv", 3, 32, 3, 2, 1, 1, 1, 1, 4),
              ("deconv", 128, 128, 8, 4, 2, 1, 1, 2, 8), ("deconv", 3, 128, 8, 4, 2, 1, 1, 2, 8),
              ("deconv", 64, 32, 4, 2, 1, 1, 1, 2, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", INT8_CASES, ids=[str(c) for c in INT8_CASES])
def test_int8_conv_equals_plain_version_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the int8 product's CUDA route runs only on the card")
    from csbsr_tpu_torch.ops import quant

    kind, cin, cout, k, s, p, d, g, n, h = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case[1:]))
    xq = torch.randint(-127, 128, (n, cin, h, h + 3), generator=gen, device="cuda",
                       dtype=torch.int8)
    wshape = (cin, cout, k, k) if kind == "deconv" else (cout, cin // g, k, k)
    wq = torch.randint(-127, 128, wshape, generator=gen, device="cuda", dtype=torch.int8)
    before = dict(quant.PRODUCTS)
    if kind == "deconv":
        got, ref = (quant.conv_transpose_acc(xq, wq, s, p, route=r) for r in (None, "plain"))
    else:
        got, ref = (quant.conv_acc(xq, wq, s, p, d, g, route=r) for r in (None, "plain"))
    torch.cuda.synchronize()
    assert sum(quant.PRODUCTS.values()) > sum(before.values())  # the CUDA default: _int_mm
    assert got.dtype == torch.int32 and torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64],
                         ids=["float32", "bfloat16", "float64"])
def test_int8_quantizers_on_cuda_equal_cpu(dtype):
    """The int8 values and float32 scales of quantize_weight and quantize_act
    are the CPU's exactly (the CPU tests hold those to the JAX package's): a
    scale one ulp off on the card moves int8 levels, and with them outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: compares the quantizers on the card with the CPU")
    from csbsr_tpu_torch.ops import quant

    gen = torch.Generator().manual_seed(3)
    w = torch.randn(4096, 16, 3, 3, generator=gen) * torch.rand(4096, 1, 1, 1, generator=gen)
    w[7] = 0.0  # an all-zero output channel: scale 1/127
    for axis, wt in ((0, w), (1, w.transpose(0, 1))):
        q_c, s_c = quant.quantize_weight(wt.cuda().to(dtype), axis)
        q_p, s_p = quant.quantize_weight(wt.to(dtype), axis)
        assert torch.equal(q_c.cpu(), q_p) and torch.equal(s_c.cpu(), s_p)
    x = (torch.randn(2, 32, 16, 16, generator=gen) * 3).to(dtype)
    for amax in [None, 0.0, *(torch.rand(512, generator=gen) * 10).tolist()]:
        a = None if amax is None else torch.tensor(amax)
        q_c, s_c = quant.quantize_act(x.cuda(), a)
        q_p, s_p = quant.quantize_act(x, a)
        assert torch.equal(q_c.cpu(), q_p) and torch.equal(s_c.cpu(), s_p), amax
