"""Port: the paper's other joint baselines (DSRL with its four backbones,
SrcNetSR, SegNet) against the JAX package on the CPU, with weights carried
across by csbsr_tpu_torch.utils.convert, and the pieces they bring: the FA
loss, DSRL's loss branch, its gradient grouping, its pretrained loads, the
train and test CLIs.

Each baseline is the flagship recipe with overrides (BASELINES), cut to LR
16 x 16 (image 64), batch 2, 2 KBPN stages; SrcNetSR at its width (64
channels) but 2 groups of 3 blocks (both packages' class patched; the card
runs the 10 x 20 of the reference). DSRL and SrcNetSR
predict no kernel, so the KBPN SR loss (which divides the predicted kernel
by its sum) is 0/0 for them in both packages: their rows train with L1, as
the DBPN recipe does. The JAX variables are random values (numpy seed) in
the tree `jax.eval_shape(model.init)` reports.

DSRL-ResNet trains at LR 32 x 32 (image 128) here: at LR 16 its layers 3
and 4 run at 1 x 1, so 78 train-mode BatchNorms normalise over the batch's
2 values; each has a gain up to 1 / (2 sqrt(eps)) = 158 where the two
nearly agree, so the float32 gradients overflow to inf (NaN weights after
one step) and the float64 step depends on the summation order (the port's
own loss moves 50% between 1 and 4 threads). At LR 32 they run at 2 x 2.

Tolerances: eval forwards in float32 atol = rtol = 2e-5 (the zoo's bound);
the FA loss (float64, where its Gram difference does not cancel to float32
noise) 1e-12 relative and the DSRL loss branch on the same float64 outputs
1e-6; the float64 train steps losses 1e-12 relative and every gradient
tensor elementwise to 1e-10 of its largest |value| (floored at 1e-3 of the
model's largest |grad|), but DSRL's, see DSRL_STEP_TOLS; the pretrained
loads exactly (they only move values).
"""
import functools
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from csbsr_tpu.config import get_cfg_defaults as jax_cfg_defaults
from csbsr_tpu.engine.losses_glue import build_loss_fn as jax_build_loss_fn
from csbsr_tpu.engine.phase import compute_phase as jax_compute_phase
from csbsr_tpu.engine.phase import phase_config_from_cfg as jax_phase_config
from csbsr_tpu.engine.train_state import grad_group_ids as jax_grad_group_ids
from csbsr_tpu.engine.train_state import group_multipliers as jax_group_multipliers
from csbsr_tpu.losses.fa_loss import fa_loss as jax_fa_loss
from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
from csbsr_tpu_torch.config import get_cfg_defaults
from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
from csbsr_tpu_torch.engine.train_state import grad_group_ids, group_multipliers
from csbsr_tpu_torch.losses import fa_loss
from csbsr_tpu_torch.models import model_from_cfg
from csbsr_tpu_torch.utils.convert import drop_unused_reference_keys, state_dict_from_jax
from tests.test_torch_port_inference import fixture_dirs  # noqa: F401  (a fixture)
from tests.test_torch_port_models import nchw, nhwc, random_variables
from tests.test_torch_port_train import NUM_TRAIN, TINY, WINDOWS, _batch
from tests.test_torch_port_zoo_train import assert_float64_steps_equal, float64_steps

REPO = Path(__file__).resolve().parents[1]
FLAGSHIP = str(REPO / "configs" / "config_csbsr_pspnet.yaml")
TOL = 2e-5
IMAGE = 64  # LR 16 x 16
SHALLOW_SRCNET = {"n_groups": 2, "n_blocks": 3}
_DSRL = ["MODEL.SR", "DSRL", "MODEL.DETECTOR_TYPE", "DSRL", "SOLVER.SR_LOSS_FUNC", "L1"]
# name -> overrides of the flagship recipe
BASELINES = {
    "dsrl_resnet": _DSRL,
    "dsrl_resnet_deconv": _DSRL + ["MODEL.DSRL_UPSAMPLE", "deconv"],
    "dsrl_drn": _DSRL + ["TPU.DSRL_BACKBONE", "drn"],
    "dsrl_mobilenet": _DSRL + ["TPU.DSRL_BACKBONE", "mobilenet"],
    "dsrl_xception": _DSRL + ["TPU.DSRL_BACKBONE", "xception"],
    "segnet": ["MODEL.DETECTOR_TYPE", "SegNet"],
    "srcnet": ["MODEL.SR", "SrcNetSR", "SOLVER.SR_LOSS_FUNC", "L1"],
}
# DSRL's loss windows: 1-2 SR pretrain with the GT kernel, 3 SR pretrain in
# the kernel window, 4 both pretrain windows, 5-7 seg pretrain, 8 joint
DSRL_WINDOWS = WINDOWS + ["SOLVER.SEG_PRETRAIN_ITER", [4, 8]]
DSRL_ITERATIONS = (1, 3, 4, 6, 8)
DSRL_STEP_IMAGE = 128  # LR 32: see the module docstring
# (loss, gradient) tolerances of DSRL's float64 step: its FA loss sums
# |G_sr - G_seg| of two Gram matrices whose entries nearly cancel, and
# fea_seg is a train-mode BatchNorm of the seg map, which random weights
# make nearly constant (a small variance to divide by): float64 rounding of
# another summation order grows to 1.8e-10 of the FA loss and 8.2e-9 of the
# worst gradient tensor (layer1.1.bn2.weight), as the HRNet step's does in
# tests/test_torch_port_zoo_train.py (TOLS)
DSRL_STEP_TOLS = (1e-9, 2e-8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def baseline_cfgs(name, image_size=IMAGE, stages=2, extra=()):
    """(JAX cfg, port cfg) of a baseline cut to size, float32 compute."""
    out = []
    for cfg in (jax_cfg_defaults(), get_cfg_defaults()):
        cfg.merge_from_file(FLAGSHIP)
        cfg.merge_from_list(["INPUT.IMAGE_SIZE", [image_size, image_size],
                             "MODEL.NUM_STAGES", stages, "TPU.COMPUTE_DTYPE", "float32",
                             *BASELINES[name], *extra])
        out.append(cfg)
    return out


@pytest.fixture
def shallow_srcnet(monkeypatch):
    """Both packages' SrcNetSR at SHALLOW_SRCNET depth, its width kept."""
    import csbsr_tpu.models.build as jax_build
    import csbsr_tpu_torch.models.build as port_build

    class Shallow(jax_build.SrcNetSR):
        n_groups: int = SHALLOW_SRCNET["n_groups"]
        n_blocks: int = SHALLOW_SRCNET["n_blocks"]

    monkeypatch.setattr(jax_build, "SrcNetSR", Shallow)
    monkeypatch.setattr(port_build, "SrcNetSR",
                        functools.partial(port_build.SrcNetSR, **SHALLOW_SRCNET))


def baseline_models(name, image_size=IMAGE, stages=2, seed=0, extra=()):
    """(jax_cfg, port_cfg, jax_model, jax_variables, port_model), the JAX
    weights carried into the port (strict load)."""
    jcfg, cfg = baseline_cfgs(name, image_size, stages, extra)
    jm = jax_model_from_cfg(jcfg)
    lr = image_size // jcfg.MODEL.SCALE_FACTOR
    variables = random_variables(jm, jnp.zeros((1, lr, lr, 3)), None, False, train=False,
                                 seed=seed)
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"],
                                              variables.get("batch_stats")), strict=True)
    return jcfg, cfg, jm, variables, model


@pytest.mark.parametrize("name", list(BASELINES))
def test_baseline_forward_equals_jax(name, shallow_srcnet):
    jcfg, cfg, jm, variables, model = baseline_models(name, seed=11)
    x = np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32)
    out_j = jax.jit(lambda v, a: jm.apply(v, a, None, False, train=False, clip_sr=True))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(nchw(x), clip_sr=True)
    dsrl = name.startswith("dsrl")
    keys = ("sr", "seg") + (("fea_seg", "fea_sr") if dsrl else ())
    if name == "srcnet":  # PSPNet's aux map
        keys += ("aux",)
    else:
        assert out["aux"] is None and out_j["aux"] is None
    assert set(out) == set(out_j)
    for key in keys + ("kernel",):
        got = out[key].numpy() if key == "kernel" else nhwc(out[key])
        np.testing.assert_allclose(got, np.asarray(out_j[key]), rtol=TOL, atol=TOL, err_msg=key)
    assert out["sr"].shape == (2, 3, 64, 64) and out["seg"].shape == (2, 1, 64, 64)
    if dsrl:  # the FA pair at the chain's scale: x4 (deconv) or x2
        side = 64 if name.endswith("deconv") else 32
        assert out["fea_seg"].shape == out["fea_sr"].shape == (2, 3, side, side)
    assert (not out["kernel"].any()) == (name != "segnet")
    live = ((out["seg"] > 0.01) & (out["seg"] < 0.99)).float().mean()
    assert live > 0.5, float(live)


@pytest.mark.parametrize("side", [32, 64])
def test_fa_loss_equals_jax(side):
    """Pooled by 16 to 2 x 2 or 4 x 4 positions, both packages in float64
    (in float32 the difference of the two Gram matrices cancels to a few
    1e-6 of the loss in either package)."""
    rng = np.random.RandomState(side)
    f1, f2 = (rng.rand(2, side, side, 3) for _ in range(2))
    with jax.enable_x64(True):
        ref = float(jax_fa_loss(jnp.asarray(f1), jnp.asarray(f2)))
    got = float(fa_loss(nchw(f1), nchw(f2)))
    assert ref > 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("it", DSRL_ITERATIONS)
def test_dsrl_loss_branch_equals_jax_in_every_window(it):
    """The same float64 outputs through both packages' loss glue (the JAX
    package in scoped x64): total, seg, SR and FA losses; the total is the
    SR loss in the SR-pretrain window, the seg loss in the seg-pretrain one
    (which wins where both hold), else the DSRL_* weighted sum."""
    from csbsr_tpu.losses import seg_losses as jax_seg_losses

    jcfg, cfg = baseline_cfgs("dsrl_resnet", extra=DSRL_WINDOWS)
    batch = {k: np.asarray(v, np.float64) for k, v in _batch(hw=IMAGE).items()}
    b, rng = batch["hr"].shape[0], np.random.RandomState(it)
    outs = {"sr": rng.rand(b, IMAGE, IMAGE, 3), "kernel": np.zeros((b, 441)),
            "seg": rng.uniform(0.01, 0.99, (b, IMAGE, IMAGE, 1)),
            "fea_seg": rng.rand(b, 32, 32, 3), "fea_sr": rng.rand(b, 32, 32, 3)}
    phase_j = jax_compute_phase(it, jax_phase_config(jcfg, NUM_TRAIN))
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        # the boundary loss's SDF in float32, as the package computes it
        # outside x64 and as the port always does
        sdf = jax_seg_losses.sdf_normalized
        mp.setattr(jax_seg_losses, "sdf_normalized", lambda m: sdf(m).astype(jnp.float32))
        ref = jax.device_get(jax_build_loss_fn(jcfg)(
            {**{k: jnp.asarray(v) for k, v in outs.items()}, "aux": None},
            {k: jnp.asarray(v) for k, v in batch.items()}, phase_j))
    to = lambda d: {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in d.items()}
    phase = compute_phase(it, phase_config_from_cfg(cfg, NUM_TRAIN))
    ours = build_loss_fn(cfg)({**to(outs), "aux": None}, to(batch), phase)
    assert set(ours) == set(ref) == {"total", "seg_loss", "sr_loss", "fa_loss"}
    for k in ours:
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    s = cfg.SOLVER
    expect = {"sr": ours["sr_loss"], "seg": ours["seg_loss"],
              "joint": s.DSRL_SR_WEIGHT * ours["sr_loss"] + s.DSRL_FA_WEIGHT * ours["fa_loss"]
              + s.DSRL_SEG_WEIGHT * ours["seg_loss"]}
    window = "seg" if phase["in_seg_pretrain"] else "sr" if phase["in_sr_pretrain"] else "joint"
    assert window == {1: "sr", 3: "sr", 4: "seg", 6: "seg", 8: "joint"}[it]
    assert float(ours["total"]) == pytest.approx(float(expect[window]), rel=1e-12)


# the flagship's window edges: GT kernel [1, 10001), kernel [10001, 20001),
# SR pretrain [1, 30001)
EDGES = (1, 2, 10000, 10001, 20000, 20001, 30000, 30001, 30002)


@pytest.mark.parametrize("name", ["dsrl_resnet", "segnet", "srcnet"])
def test_grad_groups_and_multipliers_equal_jax_at_the_window_edges(name, shallow_srcnet):
    """Each parameter's phase multiplier equals the JAX package's at every
    edge of the flagship's windows. The JAX package puts every DSRL leaf in
    SR_CORE (the `else` of its grouping), so DSRL trains and freezes as an
    SR core: frozen in the kernel window, like the flagship's SR core."""
    jcfg, cfg = baseline_cfgs(name)
    jm = jax_model_from_cfg(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                            None, False, train=False))
    jax_ids = {k: int(v) for k, v in state_dict_from_jax(
        jax_grad_group_ids(jax.tree_util.tree_map(lambda s: 0, shapes["params"]))).items()}
    model = model_from_cfg(cfg, device="cpu")
    ids = grad_group_ids(model.named_parameters())
    assert ids == jax_ids
    pc, pc_j = phase_config_from_cfg(cfg, NUM_TRAIN), jax_phase_config(jcfg, NUM_TRAIN)
    frozen_in_kernel_window = set()
    for it in EDGES:
        mult = group_multipliers(compute_phase(it, pc), pc)
        ref = np.asarray(jax_group_multipliers(jax_compute_phase(it, pc_j), pc_j,
                                               blurskip_only=False, sr_seg_inv=False)).tolist()
        assert mult == ref, it
        if compute_phase(it, pc)["in_kernel_window"]:
            frozen_in_kernel_window |= {n for n, g in ids.items() if mult[g] == 0.0}
    if name == "dsrl_resnet":
        assert set(ids.values()) == {0} and frozen_in_kernel_window == set(ids)


@pytest.mark.parametrize("name", ["dsrl_resnet", "segnet"])
def test_float64_train_step_equals_jax_float64(name):
    """One train-mode forward + loss + backward in the joint phase
    (iteration 6, alpha 0.4), dropout off, both packages in float64. SegNet's
    subject is the head, so its KBPN has one stage; its max-unpool places a
    value at the argmax of its window, which float32 rounding may flip at
    near ties, so the step is held in float64."""
    dsrl = name == "dsrl_resnet"
    hw = DSRL_STEP_IMAGE if dsrl else IMAGE
    jcfg, cfg, _, variables, model = baseline_models(name, image_size=hw,
                                                     stages=2 if dsrl else 1, seed=9,
                                                     extra=WINDOWS)
    jax_side, port_side = float64_steps(jcfg, cfg, variables, model, 6, _batch(hw=hw))
    loss_tol, grad_tol = DSRL_STEP_TOLS if dsrl else (1e-12, 1e-10)
    assert_float64_steps_equal(jax_side, port_side, model, variables, loss_tol, grad_tol)
    assert float(port_side["losses"]["seg_loss"].detach()) > 0.0
    if dsrl:
        np.testing.assert_allclose(float(port_side["losses"]["fa_loss"].detach()),
                                   float(jax_side["losses"]["fa_loss"]), rtol=loss_tol)


@pytest.mark.parametrize("name", list(BASELINES))
def test_state_dict_loads_strict_for_every_baseline(name, shallow_srcnet):
    """Every key the converter emits is a port key and vice versa, with the
    same shapes (SrcNetSR at SHALLOW_SRCNET depth: its groups and blocks are
    named by index)."""
    jcfg, cfg = baseline_cfgs(name)
    jm = jax_model_from_cfg(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                                            None, False, train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros["params"], zeros.get("batch_stats"))
    port = model_from_cfg(cfg, device="cpu")
    result = port.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    ref = port.state_dict()
    assert all(tuple(sd[k].shape) == tuple(ref[k].shape) for k in sd)
    if name == "dsrl_resnet":
        assert {k for k in sd if k.startswith("parallel_model.up_sr_")} == {
            f"parallel_model.up_sr_{i}.{w}" for i in (1, 2, 3) for w in ("weight", "bias")}
    if name == "segnet":  # a released checkpoint's unused BNDe11 goes before a strict load
        released = {**sd, **{f"segmentation_model.BNDe11.{k}": torch.zeros(64) for k in
                             ("weight", "bias", "running_mean", "running_var")}}
        assert drop_unused_reference_keys(released).keys() == sd.keys()
    if name == "srcnet":
        assert sum(k.endswith("fe1.0.weight") for k in sd) == \
            SHALLOW_SRCNET["n_groups"] * SHALLOW_SRCNET["n_blocks"]


def _write_pth(path, sd):
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.clone() for k, v in sd.items()}, path)


@pytest.mark.parametrize("upsample", ["deconv", "bilinear"])
def test_dsrl_pretrained_loads(upsample, tmp_path, monkeypatch):
    """weights/DSRLx4.pth (deconv) or weights/DSRL.pth, written from seeded
    random weights in the reference's names and `module.parallel_model.`
    prefixes: the port loads the file into `parallel_model` as the JAX
    package does (the deconv file). With the deconv file, also a
    torchvision-named resnet101 under weights/pretrain: the port loads it
    into the backbone alone, as the JAX package does, and skips DSRL's file
    for another backbone and under SR_SCRATCH. The x2 file holds the
    reference's chain names up_sr_1..3:
    the port loads it; the JAX package looks for up_sr_0..2 there (its
    translator is keyed on SCALE_FACTOR 4) and trains from scratch
    (ROADMAP.md, section 3)."""
    from csbsr_tpu.utils.pretrained import load_imagenet_backbones as jax_load_imagenet
    from csbsr_tpu.utils.pretrained import load_pretrained_dsrl as jax_load_dsrl
    from csbsr_tpu_torch.utils.pretrained import load_imagenet_backbones, load_pretrained_dsrl

    extra = ["MODEL.DSRL_UPSAMPLE", upsample]
    jcfg, cfg, _, variables, source = baseline_models("dsrl_resnet", seed=3, extra=extra)
    released = {f"module.{k}": v for k, v in source.state_dict().items()}
    fname = "DSRLx4.pth" if upsample == "deconv" else "DSRL.pth"
    _write_pth(tmp_path / "weights" / fname, released)
    if upsample == "deconv":
        resnet = {k[len("module.parallel_model.backbone."):]: v for k, v in released.items()
                  if k.startswith("module.parallel_model.backbone.")}
        resnet["fc.weight"] = torch.zeros(1000, 2048)
        _write_pth(tmp_path / "weights" / "pretrain" / "resnet101-test.pth", resnet)
    monkeypatch.chdir(tmp_path)
    logs = []

    def fresh(c):
        return model_from_cfg(c, device="cpu", seed=8)

    model = fresh(cfg)
    assert load_pretrained_dsrl(cfg, model, log_fn=logs.append) is True
    assert all(torch.equal(v, source.state_dict()[k]) for k, v in model.state_dict().items())
    shapes = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), variables)
    j_rand = random_variables(None, seed=8, shapes=shapes)
    j_params, j_stats = jax_load_dsrl(jcfg, j_rand["params"], j_rand["batch_stats"],
                                      log_fn=logs.append)
    loaded_j = state_dict_from_jax(j_params, j_stats)
    if upsample == "deconv":
        assert all(torch.equal(v, model.state_dict()[k]) for k, v in loaded_j.items())
    else:
        assert any("pretrained DSRL conversion incomplete" in m for m in logs), logs
        unchanged = state_dict_from_jax(j_rand["params"], j_rand["batch_stats"])
        assert all(torch.equal(v, unchanged[k]) for k, v in loaded_j.items())
    assert f"DSRL pretrained model was loaded from weights/{fname}" in logs
    if upsample != "deconv":
        return

    # ImageNet ResNet-101: the backbone alone, as the JAX package loads it
    model = fresh(cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    n = load_imagenet_backbones(cfg, model, log_fn=logs.append)
    j_params, j_stats = jax_load_imagenet(jcfg, j_rand["params"], j_rand["batch_stats"],
                                          log_fn=logs.append)
    loaded_j = state_dict_from_jax(j_params, j_stats)
    sd = model.state_dict()
    moved = {k for k in sd if not torch.equal(sd[k], before[k])}
    assert n > 0 and moved and all(k.startswith("parallel_model.backbone.") for k in moved)
    assert all(torch.equal(sd[k], loaded_j[k]) for k in moved)

    for other in (["TPU.DSRL_BACKBONE", "drn"], ["MODEL.SR_SCRATCH", True]):
        c = baseline_cfgs("dsrl_resnet", extra=extra + other)[1]
        model = fresh(c)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        assert load_pretrained_dsrl(c, model, log_fn=logs.append) is False
        assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert any("released weights not applicable" in m for m in logs)


def test_dsrl_kernel_psnr_is_nan_as_in_the_jax_package(tmp_path):
    """DSRL predicts no kernel: PSNR_kernel is 0/0, NaN, in both harnesses
    (as DBPN's, ROADMAP.md section 3); the other metrics agree."""
    from PIL import Image

    from csbsr_tpu.data import CrackDataSetTest as JaxSet
    from csbsr_tpu.data.make_test_blur import make_test_blur_dir
    from csbsr_tpu.engine.inference import inference_for_ss as jax_inference
    from csbsr_tpu_torch.data import CrackDataSetTest
    from csbsr_tpu_torch.engine.inference import inference_for_ss

    img_dir, mask_dir = tmp_path / "images", tmp_path / "masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    rng = np.random.RandomState(7)
    Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(img_dir / "im0.jpg")
    Image.fromarray(((rng.rand(64, 64) > 0.8) * 255).astype(np.uint8), "L").save(
        mask_dir / "im0.jpg")
    make_test_blur_dir(str(img_dir), str(tmp_path / "blur" / "02_40"), kernel_size=21)
    jcfg, cfg, jm, variables, model = baseline_models("dsrl_resnet", seed=2)
    args = (str(img_dir), str(mask_dir), str(tmp_path / "blur"), "02_40")
    ref = jax_inference(jcfg, jm, jax.tree_util.tree_map(np.asarray, variables),
                        JaxSet(jcfg, *args), output_dir=str(tmp_path / "jax"), test_aiu=True,
                        log_fn=lambda *a: None)
    ours = inference_for_ss(cfg, model, CrackDataSetTest(cfg, *args),
                            output_dir=str(tmp_path / "port"), device="cpu", test_aiu=True,
                            log_fn=lambda *a: None)
    assert np.isnan(ref["PSNR_kernel"]) and np.isnan(ours["PSNR_kernel"])
    for key in ("PSNR", "SSIM"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(ours["AIU"], ref["AIU"], atol=1e-3)


# the CLI runs' windows: iteration 1 in the SR pretrain, 2 in the joint phase
WINDOWS_CLI = ["SOLVER.SR_PRETRAIN_ITER", "[1, 2]", "SOLVER.SR_SR_MODULE_PRETRAIN_ITER", "[1, 2]",
               "SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER", "[2, 2]"]
CLI_CASES = ["dsrl_resnet", "dsrl_drn", "dsrl_mobilenet", "dsrl_xception", "segnet", "srcnet"]


@pytest.mark.parametrize("name", CLI_CASES)
def test_train_and_test_cli_on_each_baseline(name, tmp_path, fixture_dirs, capsys,  # noqa: F811
                                             monkeypatch):
    """Two steps and an eval through csbsr_tpu_torch.train's main on the CPU
    at image 32 (DSRL-ResNet 128): a checkpoint, finite losses; then the test
    CLI scores the
    checkpoint: finite PSNR/SSIM/AIU; the kernel PSNR NaN for the
    models without a kernel, as in the JAX harness."""
    from csbsr_tpu_torch.test import main as test_main
    from csbsr_tpu_torch.train import main as train_main

    monkeypatch.chdir(tmp_path)  # weights/ is looked up under the working directory
    out = tmp_path / "run"
    extra = [str(v) for v in BASELINES[name]]
    # DSRL-ResNet trains at LR 32, where its layers 3-4 are 2 x 2 (see above)
    size = ["INPUT.IMAGE_SIZE", f"[{DSRL_STEP_IMAGE}, {DSRL_STEP_IMAGE}]"] \
        if name == "dsrl_resnet" else []
    argv = (["--config_file", FLAGSHIP, "--device", "cpu", "--synthetic", "--log_step", "1",
             "--save_step", "2", "--eval_step", "2", "--max_eval_batches", "1",
             "--num_workers", "0"] + TINY + size + WINDOWS_CLI
            + ["SOLVER.BATCH_SIZE", "2", "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(out)] + extra)
    state = train_main(argv)
    logs = capsys.readouterr().out.splitlines()
    assert state.step == 2 and (out / "checkpoints" / "2.pth").is_file()
    iters = [m for m in logs if m.startswith("===> Iter")]
    evals = [m for m in logs if m.startswith("=====> Eval @ 2")]
    assert len(iters) == 2 and len(evals) == 1, logs
    assert all("nan" not in m.lower() for m in iters + evals), logs
    assert ("kernel_psnr" in evals[0]) == (name == "segnet")
    if name.startswith("dsrl"):
        assert any("DSRL" in m for m in logs), logs
    img_dir, mask_dir, blur_dir = fixture_dirs
    summary = test_main(["--device", "cpu", str(out), "2"] + TINY + extra
                        + ["DATASET.TEST_IMAGE_DIR", img_dir, "DATASET.TEST_MASK_DIR",
                           mask_dir, "DATASET.TEST_BLURED_DIR", blur_dir])
    assert all(np.isfinite(summary[k]) for k in ("PSNR", "SSIM", "AIU")), summary
    assert np.isnan(summary["PSNR_kernel"]) == (name != "segnet"), summary
    shutil.rmtree(out)
    assert not os.path.exists(out)
