"""Port: the other recipes of configs/ (DBPN, U-Net16, PSPNet-BlurSkip in its
three variants, CrackFormer, HRNet-OCR) in eval against the JAX package, on
the CPU, with weights carried across by csbsr_tpu_torch.utils.convert; and
the pieces they need, held alone.

Each recipe is cut to LR 8 x 8 (SR 32 x 32, which CrackFormer's five pools
allow) and 2 KBPN stages; HRNet runs at width 8 (both packages' HRNetW48OCR
given width 8 for the test). The JAX variables are random values (numpy
seed) in the tree `jax.eval_shape(model.init)` reports, with random biases,
PReLU slopes, GroupNorm and BatchNorm parameters and statistics, so that a
misrouted leaf shows. Float32 on both sides.

Tolerances: model outputs atol = rtol = 2e-5, the flagship parity tests'
bound (float32 summation order), but CrackFormer's, which float32 rounding
moves further (see `_crackformer_float32_and_float64`); max_pool_with_indices / max_unpool and the
pixel shuffle exactly (they only move and compare values), their gradients
to 1e-6; the Reduct resize of the kernel 1e-6.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from csbsr_tpu.config import get_cfg_defaults as jax_cfg_defaults
from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
from csbsr_tpu_torch.config import get_cfg_defaults
from csbsr_tpu_torch.models import model_from_cfg
from csbsr_tpu_torch.utils.convert import drop_unused_reference_keys, state_dict_from_jax
from tests.test_torch_port_models import nchw, nhwc, random_variables

TOL = 2e-5
NARROW_HRNET = 8


def nhwc64(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))

# HRNet in eval with random running statistics: its sum fusions grow the
# activations until both sigmoid outputs saturate (the seg map at most
# 1e-17 here), so its heads' logits, before the resize and the sigmoid, are
# compared too (JAX module name -> port module name), relative to their
# largest |value|
HEAD_LOGITS = {"hrnet": {"cls_head": "cls_head", "aux_conv1": "aux_head"}}
# (recipe file, detector override or None)
RECIPES = {
    "dbpn": ("config_cssr_pspnet", None),
    "unet16": ("config_csbsr_unet", None),
    "blurskip": ("config_csbsr_pspnet_blurskip", None),
    "blurskip_origin": ("config_csbsr_pspnet_blurskip", "PSPNet_BlurSkip_origin"),
    "blurskip_reduct": ("config_csbsr_pspnet_blurskip", "PSPNet_BlurSkipReduct"),
    "crackformer": ("config_csbsr_crackformer", None),
    "hrnet": ("config_csbsr_hrnet", None),
}
# recipes held in a train step only (tests/test_torch_port_zoo_train.py)
TRAIN_ONLY_RECIPES = {"wf": ("config_csbsr_pspnet_wf", None)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def zoo_cfgs(name, image_size=32, stages=2, extra=()):
    """(JAX cfg, port cfg) of a recipe cut to size, float32 compute."""
    recipe, detector = {**RECIPES, **TRAIN_ONLY_RECIPES}[name]
    out = []
    for cfg in (jax_cfg_defaults(), get_cfg_defaults()):
        cfg.merge_from_file(f"configs/{recipe}.yaml")
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", [image_size, image_size],
                             "MODEL.NUM_STAGES", stages, "TPU.COMPUTE_DTYPE", "float32",
                             *extra])
        if detector:
            cfg.MODEL.DETECTOR_TYPE = detector
        out.append(cfg)
    return out


@pytest.fixture
def narrow_hrnet(monkeypatch):
    """Both packages' HRNetW48OCR at width NARROW_HRNET."""
    import csbsr_tpu.models.hrnet_ocr as jax_hrnet
    import csbsr_tpu_torch.models.build as port_build

    class Narrow(jax_hrnet.HRNetW48OCR):
        width: int = NARROW_HRNET

    monkeypatch.setattr(jax_hrnet, "HRNetW48OCR", Narrow)
    monkeypatch.setattr(port_build, "HRNetW48OCR",
                        functools.partial(port_build.HRNetW48OCR, width=NARROW_HRNET))


def zoo_models(name, image_size=32, stages=2, seed=0, extra=()):
    """(jax_cfg, port_cfg, jax_model, jax_variables, port_model) of a
    recipe, the JAX weights carried into the port (strict load)."""
    jcfg, cfg = zoo_cfgs(name, image_size, stages, extra)
    jm = jax_model_from_cfg(jcfg)
    lr = image_size // jcfg.MODEL.SCALE_FACTOR
    variables = random_variables(jm, jnp.zeros((1, lr, lr, 3)), None, False, train=False,
                                 seed=seed)
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats")), strict=True)
    return jcfg, cfg, jm, variables, model


@pytest.mark.parametrize("name", list(RECIPES))
def test_recipe_forward_equals_jax(name, narrow_hrnet):
    jcfg, cfg, jm, variables, model = zoo_models(name, seed=11)
    x = np.random.RandomState(4).rand(2, 8, 8, 3).astype(np.float32)
    heads = HEAD_LOGITS.get(name, {})
    out_j, inter = jax.jit(lambda v, a: jm.apply(
        v, a, None, False, train=False, clip_sr=True,
        capture_intermediates=lambda mdl, _: mdl.name in heads))(variables, jnp.asarray(x))
    logits = {}
    hooks = [getattr(model.segmentation_model, port_name).register_forward_hook(
        lambda mod, inp, o, k=port_name: logits.__setitem__(k, o)) for port_name in heads.values()]
    with torch.no_grad():
        out = model(nchw(x), clip_sr=True)
    for h in hooks:
        h.remove()
    for jax_name, port_name in heads.items():
        ref = np.asarray(inter["intermediates"]["segmentation_model"][jax_name]["__call__"][0])
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(nhwc(logits[port_name]) / scale, ref / scale, rtol=TOL,
                                   atol=TOL, err_msg=port_name)
    keys = ("sr", "seg") + (("aux",) if out_j["aux"] is not None else ())
    assert (out["aux"] is None) == (out_j["aux"] is None)
    if name == "crackformer":
        _crackformer_float32_and_float64(jcfg, model, variables, x, out_j, out)
    for key in keys if name != "crackformer" else ("sr",):
        np.testing.assert_allclose(nhwc(out[key]), np.asarray(out_j[key]), rtol=TOL, atol=TOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["kernel"].numpy(), np.asarray(out_j["kernel"]),
                               rtol=TOL, atol=TOL)
    assert out["sr"].shape == (2, 3, 32, 32) and out["seg"].shape == (2, 1, 32, 32)
    if name == "crackformer":
        assert out["aux"].shape == (2, 5, 32, 32)
    if name != "hrnet":  # its sigmoids saturate: see HEAD_LOGITS
        for key in ("seg",) + (("aux",) if out["aux"] is not None else ()):
            live = ((out[key] > 0.01) & (out[key] < 0.99)).float().mean()
            assert live > 0.5, (key, float(live))
    if name == "dbpn":
        assert not out["kernel"].any()


def _crackformer_float32_and_float64(jcfg, model, variables, x, out_j32, out32):
    """CrackFormer's float32 outputs carry the rounding of GroupNorms over
    four values (the 1 x 1 maps of its deepest level at SR 32), which the
    JAX package's float32 run amplifies most: 7.4e-4 on the seg map against
    its own float64 run, the port's float32 run 1.0e-4. So both packages also
    run in float64 (scoped x64), where the port must equal the package to
    1e-12, and the port's float32 outputs must be no further
    from the package's float64 ones than the package's own float32 outputs
    are, or within TOL."""
    with jax.enable_x64(True):
        jm64 = jax_model_from_cfg(jcfg, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        ref64 = jax.device_get(jax.jit(
            lambda v, a: jm64.apply(v, a, None, False, train=False, clip_sr=True))(
                v64, jnp.asarray(x, jnp.float64)))
    model.double()
    model.dtype = torch.float64
    try:
        with torch.no_grad():
            out64 = model(nchw(x).double(), clip_sr=True)
    finally:
        model.float()
        model.dtype = torch.float32
    for key in ("sr", "seg", "aux"):
        np.testing.assert_allclose(nhwc64(out64[key]), ref64[key], rtol=1e-12, atol=1e-12,
                                   err_msg=f"float64 {key}")
        jax_err = np.abs(np.asarray(out_j32[key], np.float64) - ref64[key]).max()
        port_err = np.abs(nhwc(out32[key]).astype(np.float64) - ref64[key]).max()
        assert port_err <= max(jax_err, TOL), (key, port_err, jax_err)


@pytest.mark.parametrize("name", list(RECIPES))
def test_state_dict_loads_strict_for_every_family(name):
    """Full depth and width (4 stages, HRNet W48, CrackFormer 64-512): every
    key the converter emits is a port key and vice versa, same shapes."""
    jcfg, cfg = zoo_cfgs(name, stages=4)
    jm = jax_model_from_cfg(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)),
                                            None, False, train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros["params"], zeros.get("batch_stats"))
    port = model_from_cfg(cfg, device="cpu")
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    ref = port.state_dict()
    assert all(tuple(sd[k].shape) == tuple(ref[k].shape) for k in sd)
    if name == "crackformer":
        # a released checkpoint's unused down{3,4,5}.nn3 blocks are dropped
        extra = {"segmentation_model.down4.nn3.conv.conv1.weight": torch.zeros(1)}
        assert set(drop_unused_reference_keys({**sd, **extra})) == set(sd)
        assert "segmentation_model.up4.nn3.conv.conv1.weight" in sd


def test_unused_reference_keys_are_only_crackformer_down_nn3():
    keep = ["segmentation_model.up5.nn3.conv.bn1.weight", "sr_model.down3.down_conv1.conv.weight",
            "segmentation_model.down3.nn2.conv.conv1.weight"]
    drop = ["segmentation_model.down3.nn3.conv.conv1.weight", "down5.nn3.conv.bn3.bias"]
    assert list(drop_unused_reference_keys(dict.fromkeys(keep + drop, 0))) == keep


@pytest.mark.parametrize("dtype", ["relu", "quantised"])
def test_max_pool_with_indices_and_unpool_equal_jax_with_ties(dtype):
    """Window-local argmax with ties (post-ReLU zeros, values on a 0.5 grid):
    the indices, the pooled and unpooled values and the gradients through
    both, against the JAX package's pair."""
    from csbsr_tpu.models.blocks import max_pool_with_indices as jpool, max_unpool as junpool
    from csbsr_tpu_torch.models.blocks import max_pool_with_indices, max_unpool

    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 12, 5).astype(np.float32)
    x = np.maximum(x, 0.0) if dtype == "relu" else np.round(x * 2.0) / 2.0
    w_pool = rng.randn(2, 4, 6, 5).astype(np.float32)
    w_un = rng.randn(2, 8, 12, 5).astype(np.float32)

    def jloss(a):
        pooled, idx = jpool(a)
        return jnp.sum(pooled * w_pool) + jnp.sum(junpool(pooled, idx) * w_un)

    pooled_j, idx_j = jpool(jnp.asarray(x))
    grad_j = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    xt = nchw(x).requires_grad_(True)
    pooled, idx = max_pool_with_indices(xt)
    un = max_unpool(pooled, idx)
    (torch.sum(pooled * nchw(w_pool)) + torch.sum(un * nchw(w_un))).backward()

    ties = (x.reshape(2, 4, 2, 6, 2, 5) == np.asarray(pooled_j)[:, :, None, :, None]).sum((2, 4))
    assert (ties > 1).any()  # the inputs do have ties
    np.testing.assert_array_equal(np.transpose(idx.numpy(), (0, 2, 3, 1)), np.asarray(idx_j))
    np.testing.assert_array_equal(nhwc(pooled.detach()), np.asarray(pooled_j))
    np.testing.assert_array_equal(nhwc(un.detach()), np.asarray(junpool(pooled_j, idx_j)))
    np.testing.assert_allclose(nhwc(xt.grad), grad_j, rtol=1e-6, atol=1e-6)


def test_pixel_shuffle_nhwc_equals_torch_nchw():
    """The JAX package's NHWC pixel_shuffle and F.pixel_shuffle on NCHW put
    every element in the same place (channels laid out as (C_out, r, r))."""
    from csbsr_tpu.ops.resize import pixel_shuffle

    x = np.arange(2 * 3 * 5 * 36, dtype=np.float32).reshape(2, 3, 5, 36)
    ref = np.asarray(pixel_shuffle(jnp.asarray(x), 3))
    ours = nhwc(torch.nn.functional.pixel_shuffle(nchw(x), 3))
    assert ours.shape == ref.shape == (2, 9, 15, 4)
    np.testing.assert_array_equal(ours, ref)


def test_reduct_kernel_resize_equals_jax():
    """PSPNet_BlurSkipReduct's condition: the 21 x 21 kernel resized to 7 x 7,
    bicubic with align_corners=True."""
    from csbsr_tpu.ops.resize import resize as jresize
    from csbsr_tpu_torch.ops.resize import resize

    k = np.random.RandomState(2).rand(3, 21, 21).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(k[..., None]), (7, 7), method="bicubic",
                             align_corners=True))[..., 0]
    ours = resize(torch.from_numpy(k)[:, None], (7, 7), method="bicubic",
                  align_corners=True)[:, 0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cls,args", [("SFTLikeBlock", (6,)), ("SFTBlock", (6,)),
                                      ("SFTLayer", ())])
def test_sft_blocks_equal_jax(cls, args):
    import csbsr_tpu.models.blocks as jb
    import csbsr_tpu_torch.models.blocks as tb
    from csbsr_tpu_torch.utils.convert import _block_leaf, convert_tree

    rng = np.random.RandomState(5)
    x, cond = rng.rand(2, 6, 6, 4).astype(np.float32), rng.rand(2, 6, 6, 3).astype(np.float32)
    jm = getattr(jb, cls)(4) if cls != "SFTLayer" else jb.SFTLayer(4)
    v = random_variables(jm, jnp.asarray(x), jnp.asarray(cond), seed=6)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), jnp.asarray(cond)))
    if cls == "SFTLayer":
        port, translate = tb.SFTLayer(4, 3), lambda p, k: f"{p[0]}.{'weight' if k == 'kernel' else 'bias'}"
    else:
        port = tb.SFTLikeBlock(4, 3, 4) if cls == "SFTLikeBlock" else tb.SFTBlock(3, 4)

        def translate(p, k):
            return f"{p[0][:-1]}.{p[0][-1]}.{_block_leaf(str(p[1]), k)}"

    port.load_state_dict(convert_tree(v["params"], None, translate), strict=True)
    with torch.no_grad():
        ours = nhwc(port(nchw(x), nchw(cond)))
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


def test_convblock_with_batchnorm_equals_jax_in_train_mode():
    """The BlockBase ConvBlock with norm='batch' (the BlurSkip ladder's):
    train-mode output and the running statistics it leaves."""
    from csbsr_tpu.models.blocks import ConvBlock as JConvBlock
    from csbsr_tpu_torch.models.blocks import ConvBlock
    from csbsr_tpu_torch.utils.convert import _block_leaf, convert_tree

    x = np.random.RandomState(7).randn(3, 6, 6, 4).astype(np.float32)
    jm = JConvBlock(5, 3, 1, 1, activation="relu", norm="batch")
    v = random_variables(jm, jnp.asarray(x), seed=8)
    ref, mutated = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    port = ConvBlock(4, 5, 3, 1, 1, activation="relu", norm="batch").train()
    port.load_state_dict(convert_tree(v["params"], v["batch_stats"],
                                      lambda p, k: _block_leaf(str(p[0]), k)), strict=True)
    with torch.no_grad():
        ours = nhwc(port(nchw(x)))
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.norm.running_mean.numpy(), stats["mean"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port.norm.running_var.numpy(), stats["var"], rtol=1e-5,
                               atol=1e-6)


def test_dbpn_kernel_psnr_is_nan_as_in_the_jax_package(tmp_path):
    """DBPN predicts no kernel: the JAX harness renormalises its zero kernel
    by its zero sum, so PSNR_kernel is 0/0, NaN (a fault of the JAX package,
    ROADMAP.md section 3); the port's harness matches it, its other metrics
    equal the package's, and it dumps no kernel image for a model without
    one. The port's train-time eval step reports no kernel PSNR for it, as
    the JAX package's does not."""
    from PIL import Image

    from csbsr_tpu.data import CrackDataSetTest as JaxSet
    from csbsr_tpu.data.make_test_blur import make_test_blur_dir
    from csbsr_tpu.engine.inference import inference_for_ss as jax_inference
    from csbsr_tpu_torch.data import CrackDataSetTest
    from csbsr_tpu_torch.engine.inference import inference_for_ss
    from csbsr_tpu_torch.engine.trainer import build_eval_step

    img_dir, mask_dir = tmp_path / "images", tmp_path / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(7)
    Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(img_dir / "im0.jpg")
    Image.fromarray(((rng.rand(32, 32) > 0.8) * 255).astype(np.uint8), "L").save(
        mask_dir / "im0.jpg")
    make_test_blur_dir(str(img_dir), str(tmp_path / "blur" / "02_40"), kernel_size=21)
    dirs = ["DATASET.TEST_IMAGE_DIR", str(img_dir), "DATASET.TEST_MASK_DIR", str(mask_dir),
            "DATASET.TEST_BLURED_DIR", str(tmp_path / "blur")]
    jcfg, cfg, jm, variables, model = zoo_models("dbpn", seed=2, extra=dirs)
    args = (str(img_dir), str(mask_dir), str(tmp_path / "blur"), "02_40")
    ref = jax_inference(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables),
                        JaxSet(jcfg, *args), output_dir=str(tmp_path / "jax"), test_aiu=True,
                        log_fn=lambda *a: None)
    out_dir = tmp_path / "port"
    ours = inference_for_ss(cfg, model, CrackDataSetTest(cfg, *args), output_dir=str(out_dir),
                            device="cpu", test_aiu=True, save_images=True,
                            log_fn=lambda *a: None)
    assert np.isnan(ref["PSNR_kernel"]) and np.isnan(ours["PSNR_kernel"])
    for key in ("PSNR", "SSIM"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(ours["AIU"], ref["AIU"], atol=1e-3)
    assert (out_dir / "images" / "im0.jpg").is_file()
    assert not (out_dir / "kernels_max").exists()

    lr = torch.rand(2, 3, 8, 8)
    m, _ = build_eval_step(cfg, model)({"lr": lr, "hr": torch.rand(2, 3, 32, 32),
                                        "seg": torch.rand(2, 1, 32, 32),
                                        "kernel": torch.rand(2, 21, 21)})
    assert set(m) == {"psnr", "ssim", "iou@0.5"}
