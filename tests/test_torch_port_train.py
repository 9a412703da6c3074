"""Port: the training path against the JAX package, on the CPU.

The cut-down flagship (image 32, 2 stages, batch 2, weights carried across by
csbsr_tpu_torch.utils.convert) runs one train-mode forward, the package's own
loss and the backward at iterations 1 (GT-kernel window), 3 (kernel window)
and 6 (joint phase, alpha 0.4) on both sides, with dropout off (flax's
Dropout patched to the identity, the port's Dropout modules in eval): one
jit compile of `jax.grad` serves the three iterations.

The port runs in float32, and again in float64. The JAX package is evaluated
in float64 (scoped `jax.enable_x64`, model dtype float64, the boundary
loss's SDF rounded to float32 as outside x64), so that the comparison carries the
float32 error of the port's step alone and not that of the reference too:
gradients of the joint phase are ill-conditioned in float32 (at full width
about 1% in relative L2 on the card and on the CPU alike, `chip_smoke.py`'s
train phase).

Tolerances, each with its reason:
  - outputs and BatchNorm statistics: rtol 1e-4, atol 1e-5; losses: rtol
    1e-5. Float32 rounding of the port (measured: 1.4e-5 on the seg map,
    2e-6 relative on the statistics, 1e-7 on the losses);
  - gradients: every element within 5e-3 of its tensor's largest |value|
    plus 1e-8, and a PReLU slope (one element) within 2e-2. Where a
    gradient is a small sum with cancellation float32 rounding reaches 3e-3
    of it on small-gradient layers, and up to 8e-3 on the slope of the first
    down block, with the thread count's summation order; the biases of the
    convs that feed a train-mode BatchNorm have a zero gradient in exact
    arithmetic and float32 noise below 1e-8;
  - the port's step in float64 against the package's: losses 1e-12, every
    gradient element 1e-9 of its tensor's largest |value| (float64 rounding;
    measured 2e-15 and 3.5e-12);
  - Adam against optax (both float32, the same operation order): 1e-6
    relative, the frozen group bit for bit; BatchNorm2d against flax's
    nn.BatchNorm in float32: 1e-5 (another summation order of the batch
    statistics);
  - compute_phase: exactly (both compute alpha and beta in float32).
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
from csbsr_tpu.ops.blur import degrade as jax_degrade
from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
from csbsr_tpu_torch.engine.train_state import (KERNEL, SEG, SR_CORE, MaskedAdam,
                                                create_train_state, grad_group_ids,
                                                make_lr_schedule)
from csbsr_tpu_torch.engine.trainer import build_train_step
from csbsr_tpu_torch.utils.convert import state_dict_from_jax
from tests.test_torch_port_inference import fixture_dirs  # noqa: F401  (a fixture)
from tests.test_torch_port_models import joint_models, nchw, nhwc, small_flagship_cfgs
from tests.test_train_step import tiny_cfg

WINDOWS = ["SOLVER.SR_PRETRAIN_ITER", [1, 5], "SOLVER.SR_SR_MODULE_PRETRAIN_ITER", [1, 3],
           "SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER", [3, 5], "SOLVER.DECREASE_RATIO", 30.0]
ITERATIONS = (1, 3, 6)
NUM_TRAIN = 2  # per_epoch 1 at batch 6: iteration 6 is 2 epochs past the SR pretrain
TINY = ["INPUT.IMAGE_SIZE", "[32, 32]", "MODEL.NUM_STAGES", "2", "TPU.COMPUTE_DTYPE", "float32"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once: keep torch to
    one intra-op thread here so the workers do not oversubscribe the CPU."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batch(b=2, hw=32, k=21, seed=12):
    """NHWC numpy batch: images, crack-line masks, sum-1 kernels and the LR."""
    rng = np.random.RandomState(seed)
    hr = rng.rand(b, hw, hw, 3).astype(np.float32)
    seg = np.zeros((b, hw, hw, 1), np.float32)
    for i in range(b):
        r = rng.randint(4, hw - 4)
        seg[i, r - 1: r + 2, :, 0] = 1.0
        seg[i, :, rng.randint(4, hw - 4), 0] = 1.0
    kern = rng.rand(b, k, k).astype(np.float32) ** 4
    kern /= kern.sum(axis=(1, 2), keepdims=True)
    lr = np.asarray(jax_degrade(jnp.asarray(hr), jnp.asarray(kern), 4, "bicubic"))
    return {"hr": hr, "seg": seg, "lr": lr, "kernel": kern}


def _dropout_off(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return model


@pytest.fixture(scope="module")
def parity():
    """JAX (float64) and port results (float32; float64 at the joint phase)
    of one train-mode forward + loss + backward at each of ITERATIONS, from
    the same weights and batch."""
    import flax.linen as fnn

    from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg

    jcfg, cfg, _, variables, model = joint_models(image_size=32, stages=2, seed=9)
    for c in (jcfg, cfg):
        c.merge_from_list(WINDOWS)
    batch = _batch()
    pc_j = jax_phase_config(jcfg, NUM_TRAIN)
    loss_j = jax_build_loss_fn(jcfg)
    b = batch["hr"].shape[0]
    f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)

    def run(params, batch_stats, jb, it):
        phase = jax_compute_phase(it, pc_j)

        def _loss(p):
            out, mutated = jm.apply(
                {"params": p, "batch_stats": batch_stats}, jb["lr"],
                jb["kernel"].reshape(b, -1), phase["use_gt_kernel"], sr_targets=jb["hr"],
                train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
            losses = loss_j(out, jb, phase)
            return losses["total"], (losses, out, mutated["batch_stats"])

        return jax.grad(_loss, has_aux=True)(params)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
        # the boundary loss's SDF in float32, as the package computes it outside
        # x64 and as the port always does (the min-plus kernel is float32)
        sdf = jax_seg_losses.sdf_normalized
        mp.setattr(jax_seg_losses, "sdf_normalized", lambda m: sdf(m).astype(jnp.float32))
        jm = jax_model_from_cfg(jcfg, dtype=jnp.float64)
        fn = jax.jit(run)
        ref = {it: jax.device_get(fn(f64(variables["params"]), f64(variables["batch_stats"]),
                                     f64(batch), jnp.int32(it)))
               for it in ITERATIONS}

    tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
    loss_fn, pc = build_loss_fn(cfg), phase_config_from_cfg(cfg, NUM_TRAIN)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    ours, ours64 = {}, {}
    for dtype, into, its in ((torch.float32, ours, ITERATIONS),
                             (torch.float64, ours64, ITERATIONS[-1:])):
        model.to(dtype)
        model.dtype = dtype
        tbd = {k: v.to(dtype) for k, v in tb.items()}
        for it in its:
            model.load_state_dict(start)
            _dropout_off(model.train())
            phase = compute_phase(it, pc)
            out = model(tbd["lr"], tbd["kernel"].reshape(b, -1), phase["use_gt_kernel"])
            losses = loss_fn(out, tbd, phase)
            model.zero_grad(set_to_none=True)
            losses["total"].backward()
            grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters()}
            stats = {k: v.clone() for k, v in model.state_dict().items() if ".running_" in k}
            into[it] = (phase, losses, out, grads, stats)
    return variables, ref, ours, ours64


def test_train_step_equals_jax_at_the_window_edges(parity):
    """One test for the three iterations, so that the JAX compile of the
    module fixture runs once even when the suite is spread over workers."""
    variables, ref, ours, _ = parity
    start = state_dict_from_jax(variables["params"], variables["batch_stats"])
    for it in ITERATIONS:
        grads_j, (losses_j, out_j, stats_j) = ref[it]
        phase, losses, out, grads, stats = ours[it]
        where = f"iteration {it}"
        # train-mode forward
        for key in ("sr", "seg", "aux"):
            np.testing.assert_allclose(nhwc(out[key]), out_j[key], rtol=1e-4, atol=1e-5,
                                       err_msg=f"{where}: {key}")
        np.testing.assert_allclose(out["kernel"].detach().numpy(), out_j["kernel"], rtol=1e-4,
                                   atol=1e-5, err_msg=where)
        # the mutated batch statistics, which moved from the start
        stats_j = state_dict_from_jax(variables["params"], stats_j)
        assert len(stats) == sum(k.endswith(".running_var") for k in stats_j) * 2
        for k, v in stats.items():
            np.testing.assert_allclose(v.numpy(), stats_j[k].numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{where}: {k}")
        assert not torch.equal(stats["segmentation_model.feats.bn1.running_mean"],
                               start["segmentation_model.feats.bn1.running_mean"])
        # the losses
        for k in ("total", "seg_loss", "sr_loss"):
            np.testing.assert_allclose(float(losses[k].detach()), float(losses_j[k]), rtol=1e-5,
                                       err_msg=f"{where}: {k}")
        assert phase["alpha"] == pytest.approx(0.4 if it == 6 else 1.0)
        # every gradient leaf
        grads_j = state_dict_from_jax(grads_j)
        assert set(grads) == set(grads_j)
        for name, g in grads.items():
            gj = grads_j[name].numpy()
            scale = float(np.abs(gj).max())
            err = float(np.abs(g.numpy() - gj).max())
            rtol = 2e-2 if g.numel() == 1 else 5e-3  # a PReLU slope: one sum over a whole map
            assert err <= rtol * scale + 1e-8, (where, name, err, scale)
        groups = grad_group_ids(grads.items())
        norm = lambda gid: sum(float(g.abs().sum()) for n, g in grads.items() if groups[n] == gid)
        # GT-kernel window: the predictors get no gradient; SR pretrain: the seg head none
        assert (norm(KERNEL) == 0.0) == (it == 1), where
        assert (norm(SEG) == 0.0) == (it in (1, 3)), where


def test_float64_train_step_equals_jax_float64(parity):
    """The port's step run in float64 against the JAX package's float64 one,
    at the joint phase (both losses live, every group with a gradient).
    No float32 rounding enters either side but the boundary loss's SDF (a
    float32 input on both), so the ill-conditioning of the joint phase does
    not show, and every gradient tensor of every group is held elementwise
    to 1e-9 of its largest |value| (floored at 1e-3 of the model's largest
    |grad|: conv biases that feed a train-mode BatchNorm have a zero gradient
    in exact arithmetic; measured 3.5e-12 at the joint phase), the losses to
    1e-12 (measured 2e-15)."""
    _, ref, _, ours64 = parity
    for it in ours64:
        grads_j, (losses_j, _, _) = ref[it]
        _, losses, _, grads, _ = ours64[it]
        for k in ("total", "seg_loss", "sr_loss"):
            np.testing.assert_allclose(float(losses[k].detach()), float(losses_j[k]), rtol=1e-12,
                                       err_msg=f"iteration {it}: {k}")
        # the converter works in float32 and only moves elements, so each
        # float64 leaf crosses as a float32 pair, hi + lo
        hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads_j)
        lo = jax.tree_util.tree_map(lambda a, h: np.asarray(np.asarray(a) - h, np.float32),
                                    grads_j, hi)
        hi, lo = state_dict_from_jax(hi), state_dict_from_jax(lo)
        grads_j = {n: hi[n].double() + lo[n].double() for n in hi}
        floor = 1e-3 * max(float(g.abs().max()) for g in grads_j.values())
        worst = max((float((g - grads_j[n]).abs().max())
                     / max(float(grads_j[n].abs().max()), floor), n) for n, g in grads.items())
        assert worst[0] <= 1e-9, (it, worst)


FLOAT32_SIZE, FLOAT32_STAGES = 64, 2  # a size where the port's float32 error reaches 1e-2
FLOAT32_INSTANCES = ((9, 12), (1, 3))  # (weight seed, batch seed)


def test_float32_joint_phase_gradient_loses_no_more_than_the_jax_package():
    """The float32 conditioning of the joint phase (iteration 6, alpha 0.4),
    held against the JAX package's own float32 step at image 64 (2 stages),
    a size where the port's float32 gradient is up to 1.7% off float64 in
    relative L2, as at full width on the card. Both packages' float32
    gradients are held to the package's float64 one (scoped x64) on two
    weight and batch instances. The error of each package depends on the
    instance, by up to 11x between the two; measured on the CPU,
    SR_CORE/KERNEL/SEG: the port 1.66e-2/1.57e-3/1.30e-2 and
    2.9e-3/1.4e-4/3.0e-3, the package 6.6e-3/5.2e-4/5.4e-3 and
    2.20e-2/1.26e-3/1.46e-2. Per group, the port's worst error over the
    instances must stay within PORT_FACTOR of the package's worst, and for
    SR_CORE and SEG above 5e-3, so that this size shows the effect: the
    ill-conditioning is the reference's too, not a fault of the port."""
    import flax.linen as fnn

    from csbsr_tpu.models import model_from_cfg as jax_model_from_cfg

    port_factor = 2.0
    it, b = ITERATIONS[-1], 2
    worst = {}
    steps, shapes = {}, None
    for seed, batch_seed in FLOAT32_INSTANCES:
        # the second instance reuses the first one's shape tree (one trace of init)
        jcfg, cfg, _, variables, model = joint_models(FLOAT32_SIZE, FLOAT32_STAGES, seed=seed,
                                                      shapes=shapes)
        shapes = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                        variables)
        for c in (jcfg, cfg):
            c.merge_from_list(WINDOWS)
        batch = _batch(hw=FLOAT32_SIZE, seed=batch_seed)
        phase = jax_compute_phase(it, jax_phase_config(jcfg, NUM_TRAIN))
        loss_j = jax_build_loss_fn(jcfg)

        def grad_fn(dtype):
            jm = jax_model_from_cfg(jcfg, dtype=dtype)

            def _loss(p, stats, jb):
                out, _ = jm.apply({"params": p, "batch_stats": stats}, jb["lr"],
                                  jb["kernel"].reshape(b, -1), phase["use_gt_kernel"],
                                  sr_targets=jb["hr"], train=True, mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
                return loss_j(out, jb, phase)["total"]

            return jax.jit(jax.grad(_loss))

        f64 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
            with jax.enable_x64(True):
                # the boundary loss's SDF in float32, as outside x64 (see parity)
                sdf = jax_seg_losses.sdf_normalized
                mp.setattr(jax_seg_losses, "sdf_normalized",
                           lambda m: sdf(m).astype(jnp.float32))
                if "64" not in steps:
                    steps["64"] = grad_fn(jnp.float64)
                # dispatched, not awaited: XLA runs it while the port steps below
                grads64 = steps["64"](f64(variables["params"]), f64(variables["batch_stats"]),
                                      f64(batch))
                mp.setattr(jax_seg_losses, "sdf_normalized", sdf)
            if "32" not in steps:
                steps["32"] = grad_fn(jnp.float32)
            jax32 = steps["32"](variables["params"], variables["batch_stats"], batch)

        tb = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in batch.items()}
        _dropout_off(model.train())
        ph = compute_phase(it, phase_config_from_cfg(cfg, NUM_TRAIN))
        out = model(tb["lr"], tb["kernel"].reshape(b, -1), ph["use_gt_kernel"])
        build_loss_fn(cfg)(out, tb, ph)["total"].backward()
        port32 = {n: torch.zeros_like(p) if p.grad is None else p.grad
                  for n, p in model.named_parameters()}
        groups = grad_group_ids(port32.items())

        grads64, jax32 = jax.device_get((grads64, jax32))
        jax32 = state_dict_from_jax(jax32)
        # the float64 reference crosses as a float32 pair, hi + lo
        hi = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), grads64)
        lo = jax.tree_util.tree_map(lambda a, h: np.asarray(np.asarray(a) - h, np.float32),
                                    grads64, hi)
        hi, lo = state_dict_from_jax(hi), state_dict_from_jax(lo)
        exact = {n: hi[n].double() + lo[n].double() for n in hi}

        def rel_l2(grads, gid):
            names = [n for n in exact if groups[n] == gid]
            diff = sum(float((grads[n].double() - exact[n]).square().sum()) for n in names)
            return (diff / sum(float(exact[n].square().sum()) for n in names)) ** 0.5

        for name, gid in (("SR_CORE", SR_CORE), ("KERNEL", KERNEL), ("SEG", SEG)):
            port_err, jax_err = rel_l2(port32, gid), rel_l2(jax32, gid)
            prev = worst.get(name, (0.0, 0.0))
            worst[name] = (max(prev[0], port_err), max(prev[1], jax_err))
    for name, (port_err, jax_err) in worst.items():
        assert port_err <= port_factor * jax_err, (name, worst)
        if name != "KERNEL":
            assert port_err > 5e-3, (name, worst)


def _phase_cfgs(**extra):
    jcfg = tiny_cfg(**extra)
    from csbsr_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    for sec in ("SOLVER", "MODEL"):
        for k in cfg[sec]:
            cfg[sec][k] = jcfg[sec][k]
    return jcfg, cfg


@pytest.mark.parametrize("ramp", [False, True])
@pytest.mark.parametrize("it", [0, 1, 2, 3, 4, 5, 6, 100])
def test_compute_phase_equals_jax_at_the_window_edges(it, ramp):
    extra = {"SOLVER.TASK_LOSS_WEIGHT": -1, "SOLVER.INCRESE_TASK_W_ITER": [2, 50],
             "SOLVER.DECREASE_RATIO": 7.0} if ramp else {}
    jcfg, cfg = _phase_cfgs(**extra)
    ref = jax_compute_phase(it, jax_phase_config(jcfg, 6))
    ours = compute_phase(it, phase_config_from_cfg(cfg, 6))
    assert set(ours) == set(ref)
    for k, v in ref.items():
        assert ours[k] == np.asarray(v).item(), k


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_masked_adam_equals_optax(mu_dtype):
    """Three steps on identical grads, the KERNEL group masked in step 2 and
    a seg grad missing (None, a zero in JAX) in step 3; the lr schedule with
    its warm-up and a gamma step; the first moment stored in TPU.OPT_MU_DTYPE
    (the update uses it before the cast in both, so the params agree to 1e-6
    either way; a bf16 moment to one bf16 step)."""
    import optax

    from csbsr_tpu.engine.train_state import make_optimizer as jax_make_optimizer

    extra = {"SOLVER.LR": 1e-3, "SOLVER.LR_STEPS": [2], "SOLVER.WARMUP_ITERS": 3,
             "SOLVER.WARMUP_FACTOR": 0.5, "SOLVER.GAMMA": 0.5, "TPU.OPT_MU_DTYPE": mu_dtype}
    jcfg, cfg = _phase_cfgs(**extra)
    tx = jax_make_optimizer(jcfg, jax_phase_config(jcfg, 6))
    mu_rtol = 1e-6 if mu_dtype == "float32" else 2.0**-8
    shapes = {"sr_model.predictor.feat_ext.0.layer.weight": (4, 3, 3, 3),
              "sr_model.feat.0.weight": (5, 3), "segmentation_model.final.0.bias": (7,)}
    rng = np.random.RandomState(0)
    p0 = {n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()} for _ in range(3)]
    grads[2]["segmentation_model.final.0.bias"] = None
    mults = [[1.0] * 4, [1.0, 0.0, 1.0, 1.0], [1.0] * 4]
    gid = grad_group_ids(shapes.items())
    assert [gid[n] for n in shapes] == [KERNEL, SR_CORE, SEG]

    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    st = tx.init(jp)
    params = {n: torch.tensor(v) for n, v in p0.items()}
    opt = MaskedAdam(list(params.items()), gid, make_lr_schedule(cfg, phase_config_from_cfg(cfg, 6)),
                     mu_dtype=getattr(torch, mu_dtype))
    for step, (g, m) in enumerate(zip(grads, mults)):
        gm = {n: (np.zeros(shapes[n], np.float32) if v is None else v) * m[gid[n]]
              for n, v in g.items()}
        upd, st = tx.update({n: jnp.asarray(v) for n, v in gm.items()}, st, jp)
        jp = optax.apply_updates(jp, {n: u * m[gid[n]] for n, u in upd.items()})

        before = {n: p.clone() for n, p in params.items()}
        for n, p in params.items():
            p.grad = None if g[n] is None else torch.tensor(g[n])
        opt.step(m)
        adam = st[0]
        mu, nu = opt.state_dict()["mu"], opt.state_dict()["nu"]
        for n, p in params.items():
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[n]), rtol=1e-6, atol=1e-9)
            assert mu[n].dtype == getattr(torch, mu_dtype)
            np.testing.assert_allclose(mu[n].float().numpy(), np.asarray(adam.mu[n], np.float32),
                                       rtol=mu_rtol, atol=1e-9)
            np.testing.assert_allclose(nu[n].numpy(), np.asarray(adam.nu[n]), rtol=1e-6, atol=1e-12)
            if m[gid[n]] == 0.0:
                assert torch.equal(p, before[n]), n  # frozen: bit for bit
            else:
                assert not torch.equal(p, before[n]), n
    assert opt.count == int(adam.count) == 3


@pytest.fixture(scope="module")
def tiny_train():
    from csbsr_tpu_torch.models import model_from_cfg

    cfg = small_flagship_cfgs(image_size=32, stages=2)[1]
    cfg.merge_from_list(WINDOWS + ["SOLVER.BATCH_SIZE", 2])
    return cfg, model_from_cfg(cfg, device="cpu", seed=3)


@pytest.mark.parametrize("it,frozen,moving", [(1, KERNEL, SR_CORE), (3, SR_CORE, KERNEL)])
def test_train_step_leaves_the_frozen_group_bit_for_bit(tiny_train, it, frozen, moving):
    cfg, model = tiny_train
    pc = phase_config_from_cfg(cfg, NUM_TRAIN)
    state = create_train_state(cfg, model, pc)
    state.step = it - 1
    batch = {k: nchw(v) for k, v in _batch().items() if k in ("hr", "seg")}
    groups = grad_group_ids(model.named_parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    metrics = build_train_step(cfg, pc)(state, batch)
    assert state.step == it and np.isfinite(float(metrics["loss"]))
    after = dict(model.named_parameters())
    assert all(torch.equal(after[n], before[n]) for n in before if groups[n] == frozen)
    assert any(not torch.equal(after[n], before[n]) for n in before if groups[n] == moving)


def test_each_main_branch_dropout_zeroes_its_rate():
    from csbsr_tpu_torch.models.pspnet import PSPNet

    model = PSPNet(generator=torch.Generator().manual_seed(0)).train()
    seen = {}

    def hook(name):
        def fn(mod, args, out):
            x = args[0]
            live = x != 0
            seen[name] = (mod.p, float(((out == 0) & live).sum() / live.sum()),
                          torch.allclose(out[out != 0], (x / (1 - mod.p))[out != 0]))
        return fn

    names = ("drop_psp", "drop_1", "drop_2", "drop_3")
    for n in names:
        getattr(model, n).register_forward_hook(hook(n))
    with torch.no_grad():
        model(torch.rand(2, 3, 64, 64), torch.Generator().manual_seed(1))
    assert [seen[n][0] for n in names] == [0.3, 0.15, 0.15, 0.15]
    for n in names:  # >= 1e5 live elements each: the rate to within 0.01
        p, rate, scaled = seen[n]
        assert abs(rate - p) < 0.01 and scaled, (n, rate)


def test_dropout_needs_a_generator_in_train_mode_only():
    from csbsr_tpu_torch.models.blocks import Dropout

    drop, x = Dropout(0.3), torch.rand(4, 8)
    with pytest.raises(ValueError):
        drop.train()(x)
    assert drop.eval()(x) is x


def test_batchnorm_train_mode_equals_flax():
    import flax.linen as fnn

    from csbsr_tpu_torch.models.blocks import BatchNorm2d

    rng = np.random.RandomState(2)
    x = (rng.randn(4, 5, 6, 6) * 3 + 2).astype(np.float32)
    v = {"params": {"scale": rng.rand(5).astype(np.float32) + 0.5,
                    "bias": rng.randn(5).astype(np.float32)},
         "batch_stats": {"mean": rng.randn(5).astype(np.float32),
                         "var": rng.rand(5).astype(np.float32) + 0.5}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y_j, mut = bn.apply(v, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), mutable=["batch_stats"])
    m = BatchNorm2d(5).train()
    m.load_state_dict({"weight": torch.tensor(v["params"]["scale"]),
                       "bias": torch.tensor(v["params"]["bias"]),
                       "running_mean": torch.tensor(v["batch_stats"]["mean"]),
                       "running_var": torch.tensor(v["batch_stats"]["var"]),
                       "num_batches_tracked": torch.tensor(0)})
    y = m(torch.from_numpy(x))
    np.testing.assert_allclose(nhwc(y), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    for ours, ref in ((m.running_mean, "mean"), (m.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), mut["batch_stats"][ref], rtol=1e-5, atol=1e-6)


def test_train_cli_without_device_raises_when_cuda_is_absent(monkeypatch, tmp_path):
    from csbsr_tpu_torch.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--synthetic", "OUTPUT_DIR", str(tmp_path)])


def test_train_cli_checkpoints_resumes_and_is_scored(fixture_dirs, tmp_path):  # noqa: F811
    """A 3-step run writes checkpoints/3.pth; --resume_iter 3 continues at
    iteration 4 with the saved optimizer; csbsr_tpu_torch.test scores 3.pth.
    The run directory (about 0.5 GB of checkpoints) is removed at the end."""
    import shutil

    from csbsr_tpu_torch.test import main as test_main
    from csbsr_tpu_torch.train import main as train_main

    out = str(tmp_path / "run")
    common = ["--config_file", "configs/config_csbsr_pspnet.yaml", "--synthetic", "--device",
              "cpu", "--log_step", "1", "--num_workers", "2", "--max_eval_batches", "1"]
    opts = TINY + ["SOLVER.BATCH_SIZE", "2", "OUTPUT_DIR", out,
                   "SOLVER.SR_PRETRAIN_ITER", "[1, 3]", "SOLVER.SR_SR_MODULE_PRETRAIN_ITER",
                   "[1, 2]", "SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER", "[2, 3]"]
    first = train_main(common + ["--save_step", "3", "--eval_step", "3"] + opts
                       + ["SOLVER.MAX_ITER", "3"])
    assert first.step == 3 and first.optimizer.count == 3
    ckpt = tmp_path / "run" / "checkpoints"
    assert (ckpt / "3.pth").is_file() and (ckpt / "3_optimizer.pth").is_file()
    assert any(p.name.startswith("sr3_") for p in (tmp_path / "run" / "pred" / "images").iterdir())

    resumed = train_main(common + ["--save_step", "0", "--eval_step", "0", "--resume_iter", "3"]
                         + opts + ["SOLVER.MAX_ITER", "4"])
    assert resumed.step == 4 and resumed.optimizer.count == 4

    img_dir, mask_dir, blur_dir = fixture_dirs
    summary = test_main(["--sf_save_image", "--device", "cpu", out, "3"] + TINY
                        + ["DATASET.TEST_IMAGE_DIR", img_dir, "DATASET.TEST_MASK_DIR", mask_dir,
                           "DATASET.TEST_BLURED_DIR", blur_dir])
    assert all(np.isfinite(v) for v in summary.values()) and "AIU" in summary
    shutil.rmtree(out)
