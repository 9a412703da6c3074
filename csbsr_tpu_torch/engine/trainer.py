"""Training engine: the host loop around the train step
(`csbsr_tpu/engine/trainer.py`).

  - The degradation (a random Gaussian kernel per sample, the blur and the
    bicubic 1/SF resize) runs on the device inside the step when the batch
    has no `lr`, from a generator seeded by (SEED, iteration).
  - The phases, alpha and beta are pure functions of the iteration
    (engine/phase.py); the phase masks act in MaskedAdam
    (engine/train_state.py).
  - The step runs forward (train mode; dropout masks from a generator seeded
    by (SEED, iteration)), loss and backward with TF32 off, so the float32
    loss math and the pseudo-LR blurs stay float32 on the card, as the
    scoring path does (`utils/device.full_fp32`); bf16 compute is not
    affected.
  - `do_train` prepares batch i+1 while step i runs on the device: a pinned
    host copy and a `non_blocking=True` transfer queued behind the step, so
    the host never waits on a copy; it reads the losses back only at log
    steps.
  - The step's parts run in named profiler ranges (train.degrade,
    train.forward, train.loss, train.backward, train.optimizer) that
    `python -m csbsr_tpu_torch.profile_train` reads; outside a profiler they
    cost a few microseconds per step.

Checkpoints: `OUTPUT_DIR/checkpoints/<iter>.pth` holds the model's state
dict in the reference's names (what `python -m csbsr_tpu_torch.test` reads);
`<iter>_optimizer.pth` beside it holds the optimizer state and the step, so
`resume_iter` continues the run.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..metrics.device_metrics import iou_thresholds, psnr, ssim
from ..models.build import BLURSKIP_TYPES
from ..ops.blur import degrade, identity_kernels, make_kernel_sampler
from ..utils.device import full_fp32
from .losses_glue import build_loss_fn
from .phase import compute_phase, phase_config_from_cfg
from .train_state import TrainState, create_train_state, group_multipliers

__all__ = ["step_generator", "make_degrade_fn", "build_train_step", "build_eval_step",
           "save_checkpoint", "restore_checkpoint", "do_train"]

# generator streams of one iteration
DEGRADE_STREAM, DROPOUT_STREAM = 7, 0


def step_generator(seed: int, iteration: int, stream: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded from (seed, iteration, stream)."""
    s = int(np.random.SeedSequence([seed, iteration, stream]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def make_degrade_fn(cfg):
    """-> fn(hr (B, 3, H, W), generator) -> (lr (B, 3, H/SF, W/SF), kernels (B, k, k))."""
    sf = int(cfg.MODEL.SCALE_FACTOR)
    ksize = int(cfg.BLUR.KERNEL_SIZE_OUTPUT)
    blur_flag = bool(cfg.BLUR.FLAG)
    method = cfg.SOLVER.DOWNSCALE_INTERPOLATION
    sampler = make_kernel_sampler(
        mode=cfg.BLUR.MODE, size=ksize, sigma_range=tuple(cfg.BLUR.SIGMA_RANGE),
        sigma_range2=tuple(cfg.BLUR.SIGMA_RANGE2) or None, isotropic=bool(cfg.BLUR.ISOTROPIC))

    def fn(hr, generator):
        b = hr.shape[0]
        kernels = sampler(generator, b) if blur_flag else identity_kernels(b, ksize, hr.device)
        return degrade(hr, kernels, sf, method), kernels

    return fn


def build_train_step(cfg, pc):
    """-> step(state, batch) -> metrics: one iteration (state.step + 1) of
    the phase's loss, backward and masked Adam, in place on `state`.
    batch: {"hr", "seg"[, "lr", "kernel"]} on the model's device."""
    loss_fn = build_loss_fn(cfg)
    degrade_fn = make_degrade_fn(cfg)
    seed = int(cfg.SEED)
    blurskip_only = cfg.MODEL.DETECTOR_TYPE in BLURSKIP_TYPES

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        it = state.step + 1
        phase = compute_phase(it, pc)
        dev = batch["hr"].device
        if "lr" not in batch:
            with record_function("train.degrade"):
                gen = step_generator(seed, it, DEGRADE_STREAM, dev)
                lr, kernels = degrade_fn(batch["hr"], gen)
            batch = dict(batch, lr=lr, kernel=kernels)
        model = state.model.train()
        with full_fp32():
            with record_function("train.forward"):
                outputs = model(batch["lr"], batch["kernel"].reshape(batch["kernel"].shape[0], -1),
                                phase["use_gt_kernel"],
                                generator=step_generator(seed, it, DROPOUT_STREAM, dev))
            with record_function("train.loss"):
                losses = loss_fn(outputs, batch, phase)
            with record_function("train.backward"):
                model.zero_grad(set_to_none=True)
                losses["total"].backward()
        with record_function("train.optimizer"):
            state.optimizer.step(group_multipliers(phase, pc, blurskip_only))
        state.step = it
        return {"loss": losses["total"].detach(), "seg_loss": losses["seg_loss"].detach(),
                "sr_loss": losses["sr_loss"].detach(), "alpha": phase["alpha"]}

    return step


def build_eval_step(cfg, model):
    """-> eval_step(batch) -> (metrics, outputs): forward in eval (running
    BN statistics, no dropout) with clipped SR; per-sample PSNR/SSIM of the
    SR, IoU at 0.5 and, for KBPN (the one SR net that predicts a kernel),
    the PSNR of the clipped sum-1 kernel against the GT kernel. batch holds
    "lr" and "kernel"."""
    ksize = int(cfg.BLUR.KERNEL_SIZE_OUTPUT)
    has_kernel = cfg.MODEL.SR == "KBPN"

    @torch.inference_mode()
    def eval_step(batch):
        model.eval()
        with full_fp32():
            b = batch["kernel"].shape[0]
            outputs = model(batch["lr"], batch["kernel"].reshape(b, -1), False, clip_sr=True)
            sr = outputs["sr"].float().clamp(0.0, 1.0)
            hr = batch["hr"].float()
            m = {
                "psnr": psnr(sr, hr),
                "ssim": ssim(sr, hr),
                "iou@0.5": iou_thresholds(outputs["seg"].float(), batch["seg"].float(),
                                          torch.full((1,), 0.5, device=sr.device))[:, 0],
            }
            if has_kernel:
                kvec = outputs["kernel"].float()
                kvec = kvec / kvec.sum(dim=-1, keepdim=True)
                m["kernel_psnr"] = psnr(kvec.reshape(b, 1, ksize, ksize).clamp(0.0, 1.0),
                                        batch["kernel"].float()[:, None].clamp(0.0, 1.0))
        return m, outputs

    return eval_step


def _checkpoint_paths(output_dir: str, iteration: int):
    base = os.path.join(os.path.abspath(output_dir), "checkpoints", str(iteration))
    return base + ".pth", base + "_optimizer.pth"


def save_checkpoint(output_dir: str, state: TrainState, iteration: int) -> str:
    model_path, opt_path = _checkpoint_paths(output_dir, iteration)
    os.makedirs(os.path.dirname(model_path), exist_ok=True)
    torch.save(state.model.state_dict(), model_path)
    torch.save({"step": state.step, "optimizer": state.optimizer.state_dict()}, opt_path)
    return model_path


def restore_checkpoint(output_dir: str, state: TrainState, iteration: int) -> TrainState:
    model_path, opt_path = _checkpoint_paths(output_dir, iteration)
    state.model.load_state_dict(torch.load(model_path, map_location="cpu", weights_only=True),
                                strict=True)
    saved = torch.load(opt_path, map_location="cpu", weights_only=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    return state


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def _lookahead(it):
    """(item, next item or None) pairs."""
    it = iter(it)
    prev = next(it, None)
    for nxt in it:
        yield prev, nxt
        prev = nxt
    if prev is not None:
        yield prev, None


def do_train(cfg, model, train_loader, eval_batches=None, *, resume_iter: int = 0,
             log_step: int = 50, save_step: int = 2000, eval_step_every: int = 2000,
             num_train_ds: Optional[int] = None, debug: bool = False, log_fn=print) -> TrainState:
    """The training loop on the model's device. `train_loader` yields host
    batches {"hr": (B, 3, H, W), "seg": (B, 1, H, W)} of float32 numpy;
    `eval_batches` are {"hr", "seg", "degrade_seed"} host batches, degraded
    on the device with that seed at each eval."""
    from ..utils.logging import MetricsLogger

    device = next(model.parameters()).device
    pc = phase_config_from_cfg(cfg, num_train_ds or len(train_loader))
    state = create_train_state(cfg, model, pc)
    if resume_iter:
        restore_checkpoint(cfg.OUTPUT_DIR, state, resume_iter)
    step_fn = build_train_step(cfg, pc)
    eval_fn = build_eval_step(cfg, model) if eval_batches is not None else None
    degrade_fn = make_degrade_fn(cfg)
    mlog = MetricsLogger(cfg.OUTPUT_DIR)

    keys = ("loss", "seg_loss", "sr_loss")
    sums = {k: 0.0 for k in keys}
    tic = time.time()
    pending = None
    for batch, nxt in _lookahead(train_loader):
        hb = pending if pending is not None else _to_device(batch, device)
        metrics = step_fn(state, hb)
        # queue the next batch's copy while this step runs on the device
        pending = _to_device(nxt, device) if nxt is not None else None
        iteration = state.step
        for k in keys:
            sums[k] = sums[k] + metrics[k]
        if iteration % log_step == 0:
            avg = {k: float(v) / log_step for k, v in sums.items()}
            log_fn(f"===> Iter: {iteration:07d}, Cost: {time.time() - tic:.2f}s, "
                   f"Loss: {avg['loss']:.6f}, Segment_Loss({cfg.SOLVER.SEG_LOSS_FUNC}): "
                   f"{avg['seg_loss']:.6f}, SR_Loss({cfg.SOLVER.SR_LOSS_FUNC}): "
                   f"{avg['sr_loss']:.6f}, alpha: {metrics['alpha']:.3f}")
            mlog.log(avg | {"alpha": metrics["alpha"]}, step=iteration)
            sums = {k: 0.0 for k in keys}
            tic = time.time()

        if save_step and iteration % save_step == 0 and not debug:
            log_fn(f"=====> Save Checkpoint to {save_checkpoint(cfg.OUTPUT_DIR, state, iteration)}")

        if eval_fn is not None and eval_step_every and iteration % eval_step_every == 0:
            scores: Dict[str, list] = {}
            for i, eb in enumerate(eval_batches):
                db = _to_device({"hr": eb["hr"], "seg": eb["seg"]}, device)
                gen = torch.Generator(device=device).manual_seed(int(eb.get("degrade_seed", 0)))
                db["lr"], db["kernel"] = degrade_fn(db["hr"], gen)
                m, outputs = eval_fn(db)
                for k, v in m.items():
                    scores.setdefault(k, []).append(v.cpu().numpy().reshape(-1))
                if i == 0 and not debug:  # sample dumps of the first eval batch
                    _save_samples(os.path.join(cfg.OUTPUT_DIR, "pred"), iteration, db, outputs)
            means = {k: float(np.concatenate(v).mean()) for k, v in scores.items()}
            log_fn(f"=====> Eval @ {iteration}: " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
            mlog.log({f"eval/{k}": v for k, v in means.items()}, step=iteration)

    mlog.close()
    return state


def _save_samples(pred_dir, iteration, batch, outputs, n: int = 4):
    from ..utils.save_output import save_img

    n = min(n, batch["hr"].shape[0])
    for name, t in (("lr", batch["lr"]), ("sr", outputs["sr"].clamp(0, 1)), ("hr", batch["hr"]),
                    ("seg", outputs["seg"])):
        save_img(pred_dir, t[:n].float().cpu().numpy(),
                 [f"{name}{iteration}_{i}.png" for i in range(n)])
