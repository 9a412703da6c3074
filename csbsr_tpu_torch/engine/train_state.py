"""Gradient groups, phase masks, the lr schedule and Adam
(`csbsr_tpu/engine/train_state.py`).

The reference freezes parts of the model per phase by flipping
`requires_grad`. The JAX package gives every parameter a group and
multiplies, per phase, both its gradient and its Adam update by the group's
0/1 multiplier. So a frozen group's parameters stay exactly still while its
moments still decay and the step count still advances. `torch.optim.Adam`
does neither (a zero grad moves the parameters by the stale momentum; a
`None` grad skips the decay), so `MaskedAdam` writes the update out: optax's
`adam` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected, first moment stored in
`TPU.OPT_MU_DTYPE`) with the mask applied per group.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from .phase import PhaseConfig, compute_phase

__all__ = ["SR_CORE", "KERNEL", "SEG", "BLURSKIP", "grad_group_ids", "group_multipliers",
           "make_lr_schedule", "MaskedAdam", "TrainState", "create_train_state"]

# gradient groups
SR_CORE, KERNEL, SEG, BLURSKIP = 0, 1, 2, 3
# optax.adam's defaults, which the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def grad_group_ids(named_params) -> Dict[str, int]:
    """Parameter name -> group: `sr_model.*predictor*` (the KBPN predictor
    and the per-stage kernel refiners) KERNEL, the rest of `sr_model`
    SR_CORE, `segmentation_model.*blur_skip*` BLURSKIP, the rest of
    `segmentation_model` SEG (anything else SR_CORE, as in the JAX package)."""
    groups = {}
    for name, _ in named_params:
        if name.startswith("sr_model."):
            groups[name] = KERNEL if "predictor" in name else SR_CORE
        elif name.startswith("segmentation_model."):
            groups[name] = BLURSKIP if "blur_skip" in name else SEG
        else:
            groups[name] = SR_CORE
    return groups


def group_multipliers(phase: Dict, pc: PhaseConfig, blurskip_only: bool = False) -> List[float]:
    """The phase's 0/1 multiplier of each group, [SR_CORE, KERNEL, SEG,
    BLURSKIP]. `blurskip_only` (the PSPNet_BlurSkip detectors' fine-tune):
    everything frozen but the blur_skip ladder, at every iteration."""
    if blurskip_only:
        return [0.0, 0.0, 0.0, 1.0]
    m_sr = 0.0 if phase["in_kernel_window"] else 1.0
    m_kernel = 0.0 if phase["use_gt_kernel"] else 1.0
    m_seg = 1.0
    if not pc.joint_learning:  # staged: SR first, then the seg head alone
        after = phase["iteration"] >= pc.sr_pretrain[1]
        m_seg = 1.0 if after else 0.0
        if after:
            m_sr = m_kernel = 0.0
    return [m_sr, m_kernel, m_seg, 1.0]


def make_lr_schedule(cfg, pc: PhaseConfig) -> Callable[[int], float]:
    """count -> lr, evaluated at the optimizer's step count before the update
    (optax's scale_by_schedule): SOLVER.LR times the UpDown x10 window, and
    with SOLVER.LR_STEPS the linear warm-up and the gamma decays."""
    base_lr = float(cfg.SOLVER.LR)
    lr_steps = tuple(cfg.SOLVER.LR_STEPS)
    gamma = float(cfg.SOLVER.GAMMA)
    warmup_factor = float(cfg.SOLVER.WARMUP_FACTOR)
    warmup_iters = int(cfg.SOLVER.WARMUP_ITERS)

    def schedule(count: int) -> float:
        lr = base_lr * compute_phase(count + 1, pc)["lr_mult"]
        if lr_steps:
            it = count + 1
            alpha = min(max(it / max(warmup_iters, 1), 0.0), 1.0)
            wf = warmup_factor * (1.0 - alpha) + alpha
            lr = lr * wf * gamma ** sum(it >= m for m in lr_steps)
        return lr

    return schedule


class MaskedAdam:
    """optax.adam(schedule, mu_dtype) over named parameter groups, with the
    phase multiplier of each group applied to its gradient and its update.

    step(multipliers) reads `.grad` (None counts as zero, as in JAX, where
    every parameter has a gradient). A group with multiplier 0 gets
    mu *= b1, nu *= b2 and no parameter change, which is what the JAX
    package's `0 * grad` / `0 * update` computes; a group with multiplier 1
    the full update. All state changes in place."""

    def __init__(self, named_params, group_ids: Dict[str, int], schedule: Callable[[int], float],
                 mu_dtype=torch.float32):
        self.schedule = schedule
        self.names: List[List[str]] = [[], [], [], []]
        self.params: List[List[torch.Tensor]] = [[], [], [], []]
        for name, p in named_params:
            self.names[group_ids[name]].append(name)
            self.params[group_ids[name]].append(p)
        self.mu = [[torch.zeros_like(p, dtype=mu_dtype) for p in ps] for ps in self.params]
        self.nu = [[torch.zeros_like(p) for p in ps] for ps in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, multipliers) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        # optax bias correction, in float32: t / (1 - b**count)
        bc1 = float(f32(1.0) - f32(B1) ** f32(self.count))
        bc2 = float(f32(1.0) - f32(B2) ** f32(self.count))
        for gid, params in enumerate(self.params):
            if not params:
                continue
            mu, nu = self.mu[gid], self.nu[gid]
            if multipliers[gid] == 0.0:
                torch._foreach_mul_(mu, B1)
                torch._foreach_mul_(nu, B2)
                continue
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
            # optax's order: (1 - b) * g^k + b * moment, unfused, with b * moment
            # in the moment's stored dtype
            torch._foreach_mul_(mu, B1)
            mu32 = [m.float() for m in mu]  # the state itself when it is float32
            torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - B1))
            torch._foreach_mul_(nu, B2)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - B2)
            torch._foreach_add_(nu, sq)
            # update = (mu / bc1) / (sqrt(nu / bc2) + eps), params += -lr * update
            den = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, EPS)
            upd = torch._foreach_div(mu32, bc1)
            torch._foreach_div_(upd, den)
            torch._foreach_add_(params, upd, alpha=-lr)
            if mu32[0] is not mu[0]:
                torch._foreach_copy_(mu, mu32)

    def state_dict(self) -> Dict:
        names = [n for ns in self.names for n in ns]
        flat = lambda groups: [t for ts in groups for t in ts]
        return {"count": self.count, "mu": dict(zip(names, flat(self.mu))),
                "nu": dict(zip(names, flat(self.nu)))}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for names, mu, nu in zip(self.names, self.mu, self.nu):
            for n, m, v in zip(names, mu, nu):
                m.copy_(state["mu"][n])
                v.copy_(state["nu"][n])


class TrainState:
    """The model, its optimizer and the step count (the last iteration run)."""

    def __init__(self, model: torch.nn.Module, optimizer: MaskedAdam, step: int = 0):
        self.model, self.optimizer, self.step = model, optimizer, step


def create_train_state(cfg, model: torch.nn.Module, pc: PhaseConfig) -> TrainState:
    if cfg.MODEL.OPTIMIZER != "Adam":
        raise NotImplementedError(
            f"MODEL.OPTIMIZER {cfg.MODEL.OPTIMIZER!r} is not ported yet (Adam only); "
            "see ROADMAP.md, queue 1")
    named = list(model.named_parameters())
    opt = MaskedAdam(named, grad_group_ids(named), make_lr_schedule(cfg, pc),
                     mu_dtype=getattr(torch, str(cfg.TPU.OPT_MU_DTYPE)))
    return TrainState(model, opt)
