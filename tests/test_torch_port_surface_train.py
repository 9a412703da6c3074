"""Port: the new model compositions and the train CLI on each new option, on
the CPU.

- SR-only pretraining (KBPN) and the inverse model (DBPN + PSPNet) take one
  float64 train step against the JAX package's (two JAX train-step
  compiles, one module fixture each), as the other recipes do in
  tests/test_torch_port_zoo_train.py: losses to 1e-12, every gradient
  tensor to 1e-9; their forward outputs of that step to a relative L2 of
  2e-5. The SCALE_FACTOR 1 and bicubic compositions hold their eval
  forward in float32 against the JAX model run op by op (no compile), to a
  relative L2 of 2e-5.
- `python -m csbsr_tpu_torch.train` trains each option of the surface for
  two steps at image 32 with an eval (and the test CLI scores the inverse
  and the SR-less checkpoints).

Sizes: 2 KBPN stages, LR 16 x 16 (image 64) for the compositions, batch 2.
"""
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tests.test_torch_port_inference import fixture_dirs  # noqa: F401
from tests.test_torch_port_models import nchw, nhwc, random_variables
from tests.test_torch_port_train import NUM_TRAIN, TINY, WINDOWS, _batch
from tests.test_torch_port_zoo import zoo_cfgs, zoo_models
from tests.test_torch_port_zoo_train import assert_float64_steps_equal, float64_steps

REPO = Path(__file__).resolve().parents[1]
IMAGE = 64  # LR 16 x 16
REL_L2 = 2e-5
FLAGSHIP = str(REPO / "configs" / "config_csbsr_pspnet.yaml")
CSSR = str(REPO / "configs" / "config_cssr_pspnet.yaml")
# the CLI runs' windows: iteration 1 in the SR pretrain, 2 in the joint phase
WINDOWS_CLI = ["SOLVER.SR_PRETRAIN_ITER", "[1, 2]", "SOLVER.SR_SR_MODULE_PRETRAIN_ITER", "[1, 2]",
               "SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER", "[2, 2]"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rel_l2(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(a - ref) / np.linalg.norm(ref))


def _step(recipe, extra, it):
    jcfg, cfg, _, variables, model = zoo_models(recipe, image_size=IMAGE, seed=21,
                                                extra=WINDOWS + extra)
    jax_side, port_side = float64_steps(jcfg, cfg, variables, model, it, _batch(hw=IMAGE))
    return cfg, variables, model, jax_side, port_side


@pytest.fixture(scope="module")
def sr_only_step():
    """KBPN alone (DATASET.ONLY_IMAGES) at iteration 6, past the GT-kernel
    window: the KBPN SR loss."""
    return _step("dbpn", ["MODEL.SR", "KBPN", "SOLVER.SR_LOSS_FUNC", "KBPN",
                          "DATASET.ONLY_IMAGES", True], 6)


@pytest.fixture(scope="module")
def inverse_step():
    """PSPNet on the LR image, DBPN on its 1-channel map (MODEL.SR_SEG_INV)
    at iteration 6, the joint phase: seg loss on the LR map, L1 SR loss on
    the seg target."""
    return _step("dbpn", ["MODEL.SR_SEG_INV", True], 6)


@pytest.mark.parametrize("which", ["sr_only", "inverse"])
def test_float64_train_step_equals_jax(which, request):
    """Losses, gradients and statistics of the step, then its forward
    outputs: SR (the inverse model's SR'd seg map), kernel, and the inverse
    model's LR map and aux. One test per fixture: under xdist a module
    fixture runs once per worker that draws one of its tests."""
    cfg, variables, model, jax_side, port_side = request.getfixturevalue(f"{which}_step")
    assert_float64_steps_equal(jax_side, port_side, model, variables)
    losses = port_side["losses"]
    if which == "sr_only":
        assert not hasattr(model, "segmentation_model")
        assert float(losses["seg_loss"]) == 0.0 and float(losses["sr_loss"]) > 0.0
    else:
        assert model.sr_model.feat0.conv.weight.shape[1] == 1
        assert float(losses["seg_loss"]) > 0.0 and float(losses["sr_loss"]) > 0.0

    out, out_j = port_side["outputs"], jax_side["outputs"]
    keys = ["sr", "kernel"] + (["seg", "lr_seg", "aux"] if which == "inverse" else [])
    assert out.get("seg") is None if which == "sr_only" else out["seg"] is out["sr"]
    for k in keys:
        ours = out[k].detach()
        ours = nhwc(ours) if ours.ndim == 4 else ours.numpy()
        assert ours.shape == np.shape(out_j[k]), k
        if k == "kernel" and which == "inverse":  # DBPN's zero kernel
            assert not ours.any() and not np.asarray(out_j[k]).any()
            continue
        assert _rel_l2(ours, out_j[k]) <= REL_L2, k
    if which == "inverse":
        assert out["lr_seg"].shape[-1] == IMAGE // 4 and out["sr"].shape[1] == 1


@pytest.mark.parametrize("extra", [["MODEL.SCALE_FACTOR", 1], ["MODEL.SR", "bicubic"]],
                         ids=["x1", "bicubic"])
def test_sr_less_forward_equals_jax(extra):
    """No SR network: the seg head on the HR target (SCALE_FACTOR 1) or on
    the bicubic upscale of the LR, in eval; the kernel is zeros; the JAX
    model runs op by op."""
    from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils.convert import state_dict_from_jax

    jcfg, cfg = zoo_cfgs("dbpn", image_size=IMAGE, extra=extra)
    jm = jax_model_from_cfg(jcfg)
    lr = IMAGE // jcfg.MODEL.SCALE_FACTOR
    variables = random_variables(jm, jnp.zeros((1, lr, lr, 3)), None, False, train=False,
                                 sr_targets=jnp.zeros((1, IMAGE, IMAGE, 3)), seed=23)
    model = model_from_cfg(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables["params"], variables["batch_stats"]),
                          strict=True)
    assert not hasattr(model, "sr_model")
    rng = np.random.RandomState(2)
    hr = rng.rand(2, IMAGE, IMAGE, 3).astype(np.float32)
    x = hr if lr == IMAGE else rng.rand(2, lr, lr, 3).astype(np.float32)
    with jax.disable_jit():
        ref = jm.apply(variables, jnp.asarray(x), None, False, sr_targets=jnp.asarray(hr),
                       train=False, clip_sr=True)
    with torch.no_grad():
        out = model(nchw(x), clip_sr=True, sr_targets=nchw(hr))
    for k in ("sr", "seg", "aux"):
        assert _rel_l2(nhwc(out[k]), ref[k]) <= REL_L2, k
    assert out["kernel"].shape == (2, 441) and not out["kernel"].any()
    if lr == IMAGE:
        assert torch.equal(out["sr"], nchw(hr))
        with pytest.raises(ValueError, match="sr_targets"):
            model(nchw(x))


def test_sr_none_needs_scale_factor_one():
    from csbsr_tpu_torch.models import model_from_cfg

    cfg = zoo_cfgs("dbpn", extra=["MODEL.SR", "none"])[1]
    with pytest.raises(ValueError, match="SCALE_FACTOR 1"):
        model_from_cfg(cfg, device="cpu")
    cfg.MODEL.SCALE_FACTOR = 1
    assert not hasattr(model_from_cfg(cfg, device="cpu"), "sr_model")


def test_staged_inverse_training_warns():
    from csbsr_tpu_torch.engine.trainer import build_train_step
    from csbsr_tpu_torch.engine.phase import phase_config_from_cfg

    cfg = zoo_cfgs("dbpn", extra=["MODEL.SR_SEG_INV", True, "MODEL.JOINT_LEARNING", False])[1]
    with pytest.warns(UserWarning, match="both stages train"):
        build_train_step(cfg, phase_config_from_cfg(cfg, NUM_TRAIN))


# --------------------------------------------------------------------------
# the train CLI


@pytest.fixture(scope="module")
def png_sets(tmp_path_factory):
    """Image-only pngs (SR pretraining), RetinalSeg pairs (0/1 masks) and
    road pairs (0/255 masks), 40 x 40, forty each (the 95/5 split leaves
    an eval batch of 2; the retinal split trains on 12)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("surface_cli")
    rng = np.random.RandomState(9)
    out = {}
    for name, high in (("pretrain", None), ("RetinalSeg", 1), ("roads", 255)):
        img_dir, mask_dir = root / name / "images", root / name / "masks"
        img_dir.mkdir(parents=True)
        mask_dir.mkdir(parents=True)
        for i in range(40):
            Image.fromarray((rng.rand(40, 40, 3) * 255).astype(np.uint8)).save(
                img_dir / f"s{i}.png")
            if high:
                Image.fromarray(((rng.rand(40, 40) > 0.8) * high).astype(np.uint8), "L").save(
                    mask_dir / f"s{i}.png")
        out[name] = ["DATASET.TRAIN_IMAGE_DIR", str(img_dir), "DATASET.TRAIN_MASK_DIR",
                     str(mask_dir)]
    return out


PHOTOMETRIC = '[["ConvertFromInts", None], ["RandomResizedCrop", {"scale": [0.5, 1.0], ' \
              '"ratio": [0.75, 1.333]}], ["PhotometricDistort", None], ["RandomMirror", None]]'
# option -> (config file, overrides, png set or None)
CLI_CASES = {
    "sr_pretrain": (FLAGSHIP, ["DATASET.ONLY_IMAGES", "True"], "pretrain"),
    "seg_only_x1": (FLAGSHIP, ["MODEL.SCALE_FACTOR", "1"], None),
    "bicubic": (FLAGSHIP, ["MODEL.SR", "bicubic"], None),
    "inverse": (CSSR, ["MODEL.SR_SEG_INV", "True"], None),
    "inverse_kbpn_staged": (FLAGSHIP, ["MODEL.SR_SEG_INV", "True",
                                       "MODEL.JOINT_LEARNING", "False"], None),
    "sgd": (FLAGSHIP, ["MODEL.OPTIMIZER", "SGD"], None),
    "blur_disk": (FLAGSHIP, ["BLUR.MODE", "disk"], None),
    "blur_motion": (FLAGSHIP, ["BLUR.MODE", "motion"], None),
    "blur_photometric": (FLAGSHIP, ["BLUR.MODE", "all_rand",
                                    "DATASET.DATA_AUGMENTATION", PHOTOMETRIC], "roads"),
    "blur_compound": (FLAGSHIP, ["BLUR.MODE", "gaus-motion"], None),
    "crackformer_rcf": ("configs/config_csbsr_crackformer.yaml",
                        ["SOLVER.SEG_LOSS_FUNC", "CrackFormerLoss"], None),
    "retinal": (FLAGSHIP, [], "RetinalSeg"),
    "road": (CSSR, [], "roads"),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_train_cli_trains_each_option(case, png_sets, tmp_path, fixture_dirs,  # noqa: F811
                                      capsys):
    """Two steps and an eval through csbsr_tpu_torch.train's main on the
    CPU: finite losses, a checkpoint, the eval's metrics as the option has
    them; the test CLI scores the SR-less and inverse checkpoints
    (their PSNR, SSIM and kernel PSNR 0.0, as in the JAX harness)."""
    from csbsr_tpu_torch.test import main as test_main
    from csbsr_tpu_torch.train import main as train_main

    config, extra, pngs = CLI_CASES[case]
    out = tmp_path / "run"
    argv = (["--config_file", config, "--device", "cpu", "--log_step", "1", "--save_step", "2",
             "--eval_step", "2", "--max_eval_batches", "1", "--num_workers", "0"]
            + ([] if pngs else ["--synthetic"]) + TINY + WINDOWS_CLI
            + ["SOLVER.BATCH_SIZE", "2", "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(out)]
            + (png_sets[pngs] if pngs else []) + extra)
    state = train_main(argv)
    logs = capsys.readouterr().out.splitlines()
    assert state.step == 2 and (out / "checkpoints" / "2.pth").is_file()
    iters = [m for m in logs if m.startswith("===> Iter")]
    evals = [m for m in logs if m.startswith("=====> Eval @ 2")]
    assert len(iters) == 2 and len(evals) == 1, logs
    assert all("nan" not in m.lower() for m in iters + evals), logs
    sr_scored = case not in ("seg_only_x1", "inverse", "inverse_kbpn_staged")
    kbpn = case not in ("bicubic", "inverse", "road")
    assert ("psnr=" in evals[0]) == sr_scored
    assert ("iou@0.5" in evals[0]) == (case != "sr_pretrain")
    assert ("kernel_psnr" in evals[0]) == (sr_scored and kbpn)
    if case in ("seg_only_x1", "inverse"):
        img_dir, mask_dir, blur_dir = fixture_dirs
        summary = test_main(["--device", "cpu", str(out), "2"] + TINY + extra
                            + ["DATASET.TEST_IMAGE_DIR", img_dir, "DATASET.TEST_MASK_DIR",
                               mask_dir, "DATASET.TEST_BLURED_DIR", blur_dir])
        assert summary["PSNR"] == summary["SSIM"] == summary["PSNR_kernel"] == 0.0
        assert np.isfinite(summary["AIU"]) and summary["AIU"] >= 0.0
    shutil.rmtree(out)


def test_joint_training_starts_from_the_sr_pretraining_checkpoint(png_sets, tmp_path,
                                                                  monkeypatch, capsys):
    """The two-stage workflow: SR-only pretraining saves checkpoints/2.pth;
    copied to weights/pretrain/ under the name the joint recipe looks for
    (KERNEL_SIZE 7 != KERNEL_SIZE_OUTPUT 21: the _bicubic7 name), the joint
    run logs the load and its SR net is that checkpoint's before step 1."""
    from csbsr_tpu_torch.train import main as train_main
    from csbsr_tpu_torch.utils import pretrained

    flags = ["--config_file", FLAGSHIP, "--device", "cpu", "--log_step", "1", "--eval_step",
             "0", "--num_workers", "0"]
    opts = TINY + ["SOLVER.BATCH_SIZE", "2"]
    pre = tmp_path / "pre"
    train_main(flags + ["--save_step", "2"] + opts + png_sets["pretrain"]
               + ["DATASET.ONLY_IMAGES", "True", "SOLVER.MAX_ITER", "2", "OUTPUT_DIR", str(pre)])
    saved = torch.load(pre / "checkpoints" / "2.pth", weights_only=True)
    assert saved and all(k.startswith("sr_model.") for k in saved)
    name = "KBPN_pretrain_x4_stage2_bicubic7.pth"
    (tmp_path / "weights" / "pretrain").mkdir(parents=True)
    shutil.copy(pre / "checkpoints" / "2.pth", tmp_path / "weights" / "pretrain" / name)

    seen = {}
    load = pretrained.load_pretrained_sr

    def spy(cfg, model, *a, **k):
        seen["ok"] = load(cfg, model, *a, **k)
        seen["sd"] = {n: v.clone() for n, v in model.sr_model.state_dict().items()}
        return seen["ok"]

    monkeypatch.setattr("csbsr_tpu_torch.engine.trainer.load_pretrained_sr", spy)
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    state = train_main(flags + ["--synthetic", "--save_step", "0"] + opts
                       + ["SOLVER.MAX_ITER", "1", "OUTPUT_DIR", str(tmp_path / "joint")])
    assert seen["ok"] and state.step == 1
    assert f"SR pretrained model was loaded from weights/pretrain/{name}" in \
        capsys.readouterr().out
    assert set(seen["sd"]) == {k[len("sr_model."):] for k in saved}
    for n, v in seen["sd"].items():
        assert torch.equal(v, saved[f"sr_model.{n}"]), n
