"""Where the time of the port's train step goes, on the card.

    python -m csbsr_tpu_torch.profile_train

The flagship recipe (config/flagship.py, random init from a seed) at its
batch of 6 on 224x224 crops of the synthetic train set, the same work as
chip_smoke.py's train phase: three steps to warm up, then eight from
iteration 4 (the GT-kernel window, SR-pretrain loss) in one pass under
torch.profiler (CPU + CUDA activity), each ended by reading its loss back.
Prints one JSON line: the card, wall seconds per step, device time per step
for each named range of engine/trainer.build_train_step (train.degrade,
train.forward, train.loss, train.backward, train.optimizer), device time by
kernel class and the top kernels, and the device's busy and idle shares of
the profiled wall time.
"""
from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .profile_eval import summarize

WARMUP, STEPS, SEED = 3, 8, 1121
RANGES = ("train.degrade", "train.forward", "train.loss", "train.backward", "train.optimizer")


def main():
    from .config.flagship import flagship_cfg
    from .data import IterationBasedLoader, SubsetView
    from .engine.phase import phase_config_from_cfg
    from .engine.train_state import create_train_state
    from .engine.trainer import build_train_step
    from .models import model_from_cfg
    from .train import build_datasets, split_and_eval_batches
    from .utils.device import resolve_device

    dev = resolve_device("cuda")
    cfg = flagship_cfg(SEED)
    b = cfg.SOLVER.BATCH_SIZE
    pool = build_datasets(cfg, synthetic=True)
    train_idx, _ = split_and_eval_batches(cfg, pool, max_eval_batches=1)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in hb.items()}
               for hb in IterationBasedLoader(SubsetView(pool, train_idx), b, WARMUP + STEPS,
                                              seed=SEED, num_workers=4)]
    pc = phase_config_from_cfg(cfg, len(train_idx))
    state = create_train_state(cfg, model_from_cfg(cfg, device=dev), pc)
    step = build_train_step(cfg, pc)
    for batch in batches[:WARMUP]:
        float(step(state, batch)["loss"])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[WARMUP:]:
            float(step(state, batch)["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    print(json.dumps({
        "batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE), "steps": STEPS,
        "first_iteration": WARMUP + 1, "wall_s_per_step": wall / STEPS,
        "images_per_s": b * STEPS / wall, **summarize(prof, RANGES, STEPS, wall, "step"),
    }))


if __name__ == "__main__":
    main()
