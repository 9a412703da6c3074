"""Port: one train step of each of the other recipes of configs/ against the
JAX package, on the CPU; the BlurSkip fine-tune's freeze and CrackFormer's
side-map loss.

Each recipe is cut to image 32, batch 2 (HRNet at width 8); the float64
train step, whose subject is the head, runs 1 KBPN stage, HRNet with one
module in each of its stages 3 and 4 (depth, not width), and the BlurSkip
ladder conditioned on 7 x 7 kernels (KERNEL_SIZE_OUTPUT 7: 49 condition
channels instead of 441, its float64 convs the step's cost); the flagship
train tests' windows (iteration 6: the joint phase, SR and seg losses live,
alpha 0.4) and dropout off on both sides. The wf recipe
(the flagship with the failure-oriented SR weight, m^f = 1) steps at
WF_ITERATION, past its ORIENTED_WEIGHT_ITER of 30001, where the weight is
live. The port runs
the step in float64 and the JAX package in float64 (scoped `enable_x64`,
the boundary loss's SDF rounded to float32 as outside x64), as
`test_float64_train_step_equals_jax_float64` does for the flagship: float32
gradients of the joint phase are ill-conditioned (PERF.md), float64 ones
are not, so every tensor is held elementwise.

Tolerances: losses 1e-12 relative; every gradient tensor elementwise to
1e-9 of its largest |value| (floored at 1e-3 of the model's largest |grad|:
the biases of convs that feed a train-mode BatchNorm or GroupNorm have a
zero gradient in exact arithmetic), each gradient group's L2 norm to 1e-9;
BatchNorm running statistics to 1e-9 of each tensor's largest |value|
(float64 rounding); HRNet's
looser, for the reason at TOLS. The side-map loss equals the JAX package's
to 1e-6 in float32.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from csbsr_tpu.engine.losses_glue import build_loss_fn as jax_build_loss_fn
from csbsr_tpu.engine.phase import compute_phase as jax_compute_phase
from csbsr_tpu.engine.phase import phase_config_from_cfg as jax_phase_config
from csbsr_tpu.losses import seg_losses as jax_seg_losses
from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
from csbsr_tpu_torch.engine.train_state import (BLURSKIP, create_train_state, grad_group_ids,
                                                group_multipliers)
from csbsr_tpu_torch.engine.trainer import build_train_step
from csbsr_tpu_torch.models import model_from_cfg
from csbsr_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_models import nchw
from tests.test_torch_port_train import ITERATIONS, NUM_TRAIN, WINDOWS, _batch, _dropout_off
from tests.test_torch_port_zoo import narrow_hrnet, zoo_cfgs, zoo_models  # noqa: F401

TRAIN_RECIPES = ("dbpn", "unet16", "blurskip", "crackformer", "hrnet", "wf")
STEP_STAGES = 1  # KBPN stages of the float64 steps
STEP_KERNEL = {"blurskip": 7}  # KERNEL_SIZE_OUTPUT where not the recipe's 21
WF_ITERATION = 30002  # the SR loss weights its maps from iteration > ORIENTED_WEIGHT_ITER
# (loss, gradient and statistics) tolerances where a recipe needs more than
# (1e-12, 1e-9): HRNet at image 32 runs train-mode BatchNorms over B = 2
# values (its deepest branch is 1 x 1; ObjectAttention's proxy map is
# B x K = 2 x 1), which magnify float64 rounding of another summation order
# by orders of magnitude: the port is 7e-11 off the package on the loss,
# 4.9e-8 on the worst gradient tensor and 3.0e-8 per group (the flagship
# and the other recipes 1e-16 and below 1e-12).
TOLS = {"hrnet": (1e-9, 2e-7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _to_port64(params, batch_stats=None):
    """A float64 JAX tree in the port's names, float64: the converter works
    in float32 and only moves elements, so each leaf crosses as hi + lo."""
    hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), (params, batch_stats))
    lo = jax.tree_util.tree_map(lambda a, h: np.asarray(np.asarray(a) - h, np.float32),
                                (params, batch_stats), hi)
    hi, lo = state_dict_from_jax(*hi), state_dict_from_jax(*lo)
    return {k: hi[k].double() + lo[k].double() for k in hi if hi[k].is_floating_point()}


def float64_steps(jcfg, cfg, variables, model, it, batch):
    """One train-mode forward + loss + backward at iteration `it` of both
    packages on the same weights and NHWC batch, in float64, dropout off:
    -> (JAX {"losses", "grads", "stats", "outputs"}, port {"losses",
    "outputs"}); the port's gradients stay on `model`."""
    import flax.linen as fnn

    from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg

    b = batch["hr"].shape[0]
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
    phase_j = jax_compute_phase(it, jax_phase_config(jcfg, NUM_TRAIN))
    loss_j = jax_build_loss_fn(jcfg)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
        sdf = jax_seg_losses.sdf_normalized
        mp.setattr(jax_seg_losses, "sdf_normalized", lambda m: sdf(m).astype(jnp.float32))
        jm = jax_model_from_cfg(jcfg, dtype=jnp.float64)

        def _loss(p, stats, jb):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": stats}, jb["lr"], jb["kernel"].reshape(b, -1),
                phase_j["use_gt_kernel"], sr_targets=jb["hr"], train=True,
                mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            losses = loss_j(out, jb, phase_j)
            return losses["total"], (losses, mutated.get("batch_stats", {}), out)

        # dispatched, not awaited: XLA runs it while the port steps below
        pending = jax.jit(jax.grad(_loss, has_aux=True))(
            f64(variables["params"]), f64(variables.get("batch_stats", {})), f64(batch))

    model.double()
    model.dtype = torch.float64
    _dropout_off(model.train())
    tb = {k: (nchw(v) if v.ndim == 4 else torch.from_numpy(v)).double() for k, v in batch.items()}
    phase = compute_phase(it, phase_config_from_cfg(cfg, NUM_TRAIN))
    out = model(tb["lr"], tb["kernel"].reshape(b, -1), phase["use_gt_kernel"],
                sr_targets=tb["hr"])
    losses = build_loss_fn(cfg)(out, tb, phase)
    losses["total"].backward()
    grads_j, (losses_j, stats_j, out_j) = jax.device_get(pending)
    assert phase["alpha"] == pytest.approx(float(phase_j["alpha"]))
    return ({"losses": losses_j, "grads": grads_j, "stats": stats_j, "outputs": out_j},
            {"losses": losses, "outputs": out, "phase": phase})


def assert_float64_steps_equal(jax_side, port_side, model, variables, loss_tol=1e-12,
                               grad_tol=1e-9):
    """Losses to loss_tol relative; every gradient tensor elementwise to
    grad_tol of its largest |value| (floored at 1e-3 of the model's largest
    |grad|), each gradient group's L2 norm to grad_tol; BatchNorm running
    statistics to grad_tol of each tensor's largest |value|. Returns the
    port's running statistics."""
    losses, losses_j = port_side["losses"], jax_side["losses"]
    for k in ("total", "seg_loss", "sr_loss"):
        np.testing.assert_allclose(float(losses[k].detach()), float(losses_j[k]), rtol=loss_tol,
                                   err_msg=k)
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
             for n, p in model.named_parameters()}
    ref = _to_port64(jax_side["grads"])
    assert set(grads) == set(ref)
    floor = 1e-3 * max(float(g.abs().max()) for g in ref.values())
    worst = max((float((g - ref[n]).abs().max()) / max(float(ref[n].abs().max()), floor), n)
                for n, g in grads.items())
    assert worst[0] <= grad_tol, worst
    groups = grad_group_ids(grads.items())
    for gid in sorted(set(groups.values())):
        names = [n for n in grads if groups[n] == gid]
        norm = lambda gs: sum(float(gs[n].square().sum()) for n in names) ** 0.5
        assert norm(ref) > 0.0 and norm(grads) == pytest.approx(norm(ref), rel=grad_tol), gid

    stats = {k: v for k, v in model.state_dict().items() if ".running_" in k}
    if stats:
        ref_stats = _to_port64(variables["params"], jax_side["stats"])
        for k, v in stats.items():
            err = float((v - ref_stats[k]).abs().max()) / float(ref_stats[k].abs().max())
            assert err <= grad_tol, (k, err)
    return stats


@pytest.fixture
def shallow_hrnet(monkeypatch):
    """Both packages' HRNet backbones with one module in stages 3 and 4."""
    import csbsr_tpu.models.hrnet_ocr as jax_hrnet
    import csbsr_tpu_torch.models.hrnet_ocr as port_hrnet

    for mod in (jax_hrnet, port_hrnet):
        def stages(width, table=mod.hrnet_stages):
            out = table(width)
            for key in ("stage3", "stage4"):
                out[key] = dict(out[key], num_modules=1)
            return out

        monkeypatch.setattr(mod, "hrnet_stages", stages)


@pytest.mark.parametrize("name", TRAIN_RECIPES)
def test_recipe_float64_train_step_equals_jax_float64(name, narrow_hrnet,  # noqa: F811
                                                      shallow_hrnet):
    k = STEP_KERNEL.get(name, 21)
    jcfg, cfg, _, variables, model = zoo_models(
        name, stages=STEP_STAGES, seed=9, extra=WINDOWS + ["BLUR.KERNEL_SIZE_OUTPUT", k])
    it = WF_ITERATION if name == "wf" else ITERATIONS[-1]
    assert name != "wf" or it > cfg.SOLVER.ORIENTED_WEIGHT_ITER > 0 and \
        cfg.SOLVER.SEG_FAIL_ORIENTED_WEIGHT4SR_AMP == 1.0
    jax_side, port_side = float64_steps(jcfg, cfg, variables, model, it, _batch(k=k))
    loss_tol, grad_tol = TOLS.get(name, (1e-12, 1e-9))
    stats = assert_float64_steps_equal(jax_side, port_side, model, variables, loss_tol, grad_tol)
    alpha = port_side["phase"]["alpha"] if name == "wf" else 0.4
    assert float(port_side["losses"]["seg_loss"].detach()) > 0.0
    assert port_side["phase"]["alpha"] == pytest.approx(alpha)
    assert (len(stats) > 0) == (name not in ("unet16", "crackformer"))


def test_blurskip_fine_tune_moves_only_the_ladder():
    """PSPNet_BlurSkip's recipe trains the blur_skip ladder alone: after a
    train step every other parameter is bit for bit where it was (the BN
    statistics of the frozen head still move, as in the JAX package, whose
    multipliers [0, 0, 0, 1] this is)."""
    from csbsr_tpu.engine.train_state import group_multipliers as jax_group_multipliers

    cfg = zoo_cfgs("blurskip", extra=["SOLVER.BATCH_SIZE", 2])[1]
    model = model_from_cfg(cfg, device="cpu", seed=4)
    pc = phase_config_from_cfg(cfg, NUM_TRAIN)
    state = create_train_state(cfg, model, pc)
    groups = grad_group_ids(model.named_parameters())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = {k: nchw(v) for k, v in _batch().items() if k in ("hr", "seg")}
    metrics = build_train_step(cfg, pc)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    after = model.state_dict()
    params = dict(model.named_parameters())
    moved = {n for n in params if not torch.equal(after[n], before[n])}
    ladder = {n for n in params if groups[n] == BLURSKIP}
    assert ladder and all(".blur_skip." in n for n in ladder)
    assert moved == ladder
    assert not torch.equal(after["segmentation_model.feats.bn1.running_mean"],
                           before["segmentation_model.feats.bn1.running_mean"])
    pc_j = jax_phase_config(zoo_cfgs("blurskip")[0], NUM_TRAIN)
    for it in (1, 6, 20000):
        ref = jax_group_multipliers(jax_compute_phase(it, pc_j), pc_j, blurskip_only=True,
                                    sr_seg_inv=False)
        assert group_multipliers(compute_phase(it, pc), pc, blurskip_only=True) == \
            np.asarray(ref).tolist()


@pytest.mark.parametrize("seg_loss", ["BoundaryCombo", "Dice"])
def test_crackformer_side_map_loss_equals_jax(seg_loss):
    """The aux output of CrackFormer is its five side maps, scored against
    the target broadcast to them and scaled by their count: the port's loss
    equals the JAX package's on the same outputs, and its seg loss is the
    main loss plus SEG_AUX_LOSS_WEIGHT x 5 x the side maps' loss."""
    from csbsr_tpu_torch.engine.losses_glue import build_seg_loss

    jcfg, cfg = zoo_cfgs("crackformer", extra=WINDOWS + ["SOLVER.SEG_LOSS_FUNC", seg_loss])
    rng = np.random.RandomState(6)
    batch = _batch()
    b = batch["hr"].shape[0]
    outs = {"sr": rng.rand(b, 32, 32, 3), "kernel": rng.rand(b, 441),
            "seg": rng.uniform(0.01, 0.99, (b, 32, 32, 1)),
            "aux": rng.uniform(0.01, 0.99, (b, 32, 32, 5))}
    outs = {k: np.asarray(v, np.float32) for k, v in outs.items()}
    it = ITERATIONS[-1]
    ref = jax_build_loss_fn(jcfg)({k: jnp.asarray(v) for k, v in outs.items()},
                                  {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax_compute_phase(it, jax_phase_config(jcfg, NUM_TRAIN)))
    tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    to = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in outs.items()}
    phase = compute_phase(it, phase_config_from_cfg(cfg, NUM_TRAIN))
    ours = build_loss_fn(cfg)(to, tb, phase)
    for k in ("total", "seg_loss", "sr_loss"):
        np.testing.assert_allclose(float(ours[k]), float(ref[k]), rtol=1e-6, err_msg=k)
    fn, _ = build_seg_loss(cfg)
    alpha, tgt = phase["alpha"], tb["seg"]
    main = fn(to["seg"], tgt, alpha, None)
    sides = fn(to["aux"], tgt.expand_as(to["aux"]), alpha, None)
    expect = (cfg.SOLVER.SEG_MAIN_LOSS_WEIGHT * main
              + cfg.SOLVER.SEG_AUX_LOSS_WEIGHT * 5 * sides).mean()
    np.testing.assert_allclose(float(ours["seg_loss"]), float(expect), rtol=1e-6)
