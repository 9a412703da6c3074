"""Phase schedule: iteration -> the phase's scalars (`csbsr_tpu/engine/phase.py`).

Every phase quantity is a pure function of the iteration, as in the JAX
package. Here they are Python scalars: PyTorch runs eagerly, so the train
step reads them on the host and nothing has to be traced. The float ones are
computed in float32, as the JAX package computes them.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np

__all__ = ["PhaseConfig", "phase_config_from_cfg", "compute_phase"]


class PhaseConfig(NamedTuple):
    """Schedule windows from the config."""

    sr_pretrain: tuple  # SOLVER.SR_PRETRAIN_ITER
    sr_sr_module: tuple  # SOLVER.SR_SR_MODULE_PRETRAIN_ITER (GT-kernel window)
    sr_kernel_module: tuple  # SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER
    seg_pretrain: tuple  # SOLVER.SEG_PRETRAIN_ITER
    task_loss_weight: float  # beta; -1 => ramp
    increase_task_w: tuple  # SOLVER.INCRESE_TASK_W_ITER
    per_epoch: int  # boundary-alpha epoch length
    alpha_min: float
    decrease_ratio: float
    joint_learning: bool
    scheduler: bool  # UpDownScheduler on/off


def phase_config_from_cfg(cfg, num_train_ds: int) -> PhaseConfig:
    return PhaseConfig(
        sr_pretrain=tuple(cfg.SOLVER.SR_PRETRAIN_ITER),
        sr_sr_module=tuple(cfg.SOLVER.SR_SR_MODULE_PRETRAIN_ITER),
        sr_kernel_module=tuple(cfg.SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER),
        seg_pretrain=tuple(cfg.SOLVER.SEG_PRETRAIN_ITER),
        task_loss_weight=float(cfg.SOLVER.TASK_LOSS_WEIGHT),
        increase_task_w=tuple(cfg.SOLVER.INCRESE_TASK_W_ITER),
        per_epoch=num_train_ds // cfg.SOLVER.BATCH_SIZE + 1,
        alpha_min=float(cfg.SOLVER.ALPHA_MIN),
        decrease_ratio=float(cfg.SOLVER.DECREASE_RATIO),
        joint_learning=bool(cfg.MODEL.JOINT_LEARNING),
        scheduler=bool(cfg.SOLVER.SCHEDULER),
    )


def _in_window(it: int, window) -> bool:
    lo, hi = window
    return lo <= it < hi


def compute_phase(it: int, pc: PhaseConfig) -> Dict[str, Any]:
    """All phase scalars for iteration `it`."""
    it = int(it)
    f32 = np.float32
    # BoundaryCombo alpha: epochs elapsed after the SR-pretrain window
    seg_it = max(0, it - (pc.sr_pretrain[1] - 1))
    alpha = f32(1.0) - f32(seg_it // pc.per_epoch) * f32(0.01) * f32(pc.decrease_ratio)
    alpha = min(max(alpha, f32(pc.alpha_min)), f32(1.0))
    # task weight beta
    if pc.task_loss_weight == -1:
        a, b = pc.increase_task_w
        w_task = min(f32(it - a) / f32(b - a), f32(1.0))
    else:
        w_task = f32(pc.task_loss_weight)
    # UpDownScheduler: x10 between main iterations 70k and 95k
    it_main = it - (pc.sr_pretrain[1] - 1)
    lr_mult = 10.0 if pc.scheduler and 70000 < it_main < 95000 else 1.0
    return {
        "iteration": it,
        "in_sr_pretrain": _in_window(it, pc.sr_pretrain),
        "in_seg_pretrain": _in_window(it, pc.seg_pretrain),
        "use_gt_kernel": _in_window(it, pc.sr_sr_module),
        "in_kernel_window": _in_window(it, pc.sr_kernel_module),
        "alpha": float(alpha),
        "w_task": float(w_task),
        "lr_mult": lr_mult,
    }
