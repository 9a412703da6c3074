#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the exit code is not 0:

  1. env        the card (nvidia-smi name and power limit, also printed raw),
                torch/CUDA versions, which optional packages import;
  2. build      csbsr_tpu_torch/csrc/minplus.cu (the kernel) and rates.cu
                (dispatch-rate microkernels) into build/, one nvcc each, started
                together;
  3. rates      the card's measured rates, per SM per clock, of FMNMX, FADD,
                FFMA, DPX VIADDMNMX and VIMNMX3, of the three min-type
                instructions interleaved (they must share one pipe, as the
                bound assumes) and of two candidate mixes (ops/rates.py),
                with the SASS opcodes cuobjdump shows; they define the
                min-plus kernel's operations bound, the best mix of exact
                routes under the dispatch rate and the pipes' rates;
  4. kernels    each kernel against its plain PyTorch version on the card at
                the shapes of the main path and the edges of its launch plan
                (min-plus: torch.equal), plus the EDT against a brute-force
                distance on a small mask; at the three main-path shapes
                (99, 449, 449), (1, 449, 449) and (6, 1, 224, 224) the
                kernel's and the plain version's device times (CUDA events,
                the launch queued behind a sleep on the card), the kernel's
                duration in a profiler trace, and that of a launch with an
                empty k range (its fixed cost), beside the bound from the
                measured rates;
  5. main path  evaluation: the flagship recipe (config/flagship.py: KBPN 4
                stages x4, md 128, kernel 7 -> 21, PSPNet-ResNet34, IMAGE_SIZE
                224, bf16 compute) with random weights from a seed, scoring 8
                synthetic 448x448 crack images made on the card
                (data/synthetic.py; AIU + the device HD/MSD bank) through
                engine/inference.score_for_ss; kernel launch counts are reset
                just before and read just after; then the HD bank of one image
                again with the plain row pass, which must agree exactly, and
                the model in float32 on the card against the same weights on
                the host CPU on one patch (relative error <= 1e-3);
  6. train      training: the flagship recipe at batch 6 on 224x224 crops
                of the port's synthetic set and loader, random init from the
                seed, through the train step of engine/trainer.do_train: 3
                warm-up and 10 timed steps from iteration 1 (GT-kernel
                window), then one step at 10001 (kernel window) and one at
                30001 (joint phase); launch counts reset just before and read
                just after (2 min-plus launches per step: the boundary loss's
                SDF). Checks: every loss finite; the frozen group of each
                window bit for bit unchanged; the SDF of a training batch
                equal between the kernel and the plain row pass; one step
                (TF32 off, dropout off) on the card against the same (seeded
                initial) weights and batch on the host CPU, at iterations 1
                and 30001, in
                float64 (every grad tensor elementwise) and in float32 (the
                loss, each gradient group), as check_train_step_against_cpu
                states.
  7. zoo        the other five recipes of configs/ (DBPN + PSPNet, KBPN with
                U-Net16, PSPNet_BlurSkip, CrackFormer and HRNet-W48-OCR) at
                full width, random weights from the seed, bf16 compute: each
                scores 2 synthetic 448x448 images through score_for_ss with
                the device HD bank, is held card against CPU in float32 and
                in float64 on a 16x16 LR input (CrackFormer's float32 only
                reported: rounding flips near ties of its max-unpool's
                argmax), then takes 3 steps of do_train at batch 6 on
                224x224 crops, all in the joint phase (the pretrain windows
                set to none; the PSPNet_BlurSkip recipe has none and trains
                its ladder alone); the first step is the warm-up;
                launch counts reset just before and read just after each
                path (2 min-plus launches per image and per step). One JSON
                line per recipe: images/s, steps/s, peak memory, launches.

Then the `{"kernels": [...]}` line and, last, the `{"ok": true, ...}` line.
It exits without a result when CUDA is absent or the package is missing.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
N_IMAGES = 8
HR_SIZE = 448
SEED = 1121
TRAIN_WARMUP, TRAIN_TIMED = 3, 10  # steps from iteration 1
LATE_ITERATIONS = (10001, 30001)  # kernel window, joint phase
CPU_CHECK_BATCH = 2  # samples of the card-vs-CPU train step
FLOAT64_LOSS_TOL, FLOAT64_GRAD_TOL = 1e-9, 1e-6  # card vs CPU in float64
FLOAT32_ENVELOPE, FLOAT32_FLOOR = 10.0, 1e-4  # card vs CPU in float32, per grad group
BUILT = ("minplus", "rates")  # csbsr_tpu_torch/csrc/<name>.cu
# min-plus checks, (shape, mask density): the main paths' shapes, the edges
# of the launch plan (one row, ragged row groups and column groups, a split
# k, the widest row) and all-empty slices (the 1e9 cap)
CHECK_SHAPES = (((2, 1, 33, 47), 0.02), ((3, 128, 128), 0.02), ((2, 33, 2100), 0.02),
                ((1, 40, 50), 0.0), ((99, 449, 449), 0.02), ((1, 449, 449), 0.02),
                ((6, 1, 224, 224), 0.02), ((6, 1, 224, 224), 0.0), ((1, 1, 1), 0.5),
                ((7, 31), 0.1), ((9, 33), 0.1), ((3, 2896), 0.01), ((64, 2896), 0.01))
TIMED_SHAPES = ((99, 449, 449), (1, 449, 449), (6, 1, 224, 224))  # HD bank, GT border, SDF
ZOO = (("dbpn_pspnet", "config_cssr_pspnet"), ("unet16", "config_csbsr_unet"),
       ("pspnet_blurskip", "config_csbsr_pspnet_blurskip"),
       ("crackformer", "config_csbsr_crackformer"), ("hrnet_ocr", "config_csbsr_hrnet"))
ZOO_IMAGES, ZOO_STEPS = 2, 3
HEAD_LOGITS = ("cls_head", "aux_head")  # HRNet-OCR's heads, before resize and sigmoid
# the zoo trains in the joint phase from its first step (no pretrain windows,
# as the PSPNet_BlurSkip recipe has it): the phase of most of a run's
# iterations, which the flagship's train phase reaches only at 30001
ZOO_WINDOWS = ["SOLVER.SR_PRETRAIN_ITER", [0, 0], "SOLVER.SR_SR_MODULE_PRETRAIN_ITER", [0, 0],
               "SOLVER.SR_KERNEL_MODULE_PRETRAIN_ITER", [0, 0]]


def _finite_json(obj):
    """obj with each non-finite float written as its name (strict JSON)."""
    if isinstance(obj, dict):
        return {k: _finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite_json(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj


def emit(obj):
    print(json.dumps(_finite_json(obj)), flush=True)


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """First line of `nvidia-smi --query-gpu=<query> --format=<fmt>`."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_env():
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    optional = {}
    for mod in ("yaml", "PIL", "pandas", "matplotlib", "scipy"):
        try:
            __import__(mod)
            optional[mod] = True
        except ImportError:
            optional[mod] = False
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "optional_imports": optional})
    return card


def phase_build():
    from csbsr_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(*BUILT)
    emit({"phase": "build", "sources": [f"csbsr_tpu_torch/csrc/{n}.cu" for n in BUILT],
          "seconds": time.perf_counter() - t0,
          "ptxas": {k: [l for l in v.splitlines() if "registers" in l or "spill" in l]
                    for k, v in cuda_build.BUILD_REPORTS.items()}})


def phase_rates(dev):
    """The card's rates, which define the min-plus bound; returns (rates,
    SM count, max SM clock in Hz)."""
    from csbsr_tpu_torch.ops import rates

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits")) * 1e6
    measured = rates.measure(dev, clock_hz)
    min_ops = [measured[op] for op in rates.PIPES["min"]]
    if measured["minmix"] > 1.1 * max(min_ops):
        raise AssertionError(f"FMNMX, VIADDMNMX and VIMNMX3 interleaved run at "
                             f"{measured['minmix']:.1f} per SM per clock, faster than each alone "
                             f"({min_ops}): they do not share one pipe, as the bound assumes")
    per_clock, mix = rates.candidate_rate(measured)
    opcodes = {}
    for name in BUILT:  # the opcodes each kernel became, most frequent first
        for fn, counts in rates.sass_opcodes(name).items():
            opcodes[fn] = dict(counts.most_common(6))
    emit({"phase": "rates", "per_sm_per_clock": measured, "sm_count": sms,
          "sm_clock_max_hz": clock_hz, "dispatch_rate": rates.DISPATCH_RATE,
          "route_clocks_per_candidate": {r: rates.route_cost(r, measured) for r in rates.ROUTES},
          "best_mix_candidates_per_sm_per_clock": per_clock, "best_mix": mix,
          "sass_opcodes": opcodes})
    return measured, sms, clock_hz


def _brute_edt(mask):
    """Distance to the nearest True pixel by exhaustive search (numpy)."""
    import numpy as np

    pts = np.argwhere(mask)
    yy, xx = np.mgrid[: mask.shape[0], : mask.shape[1]]
    d2 = (yy[..., None] - pts[:, 0]) ** 2 + (xx[..., None] - pts[:, 1]) ** 2
    return np.sqrt(d2.min(-1))


def phase_kernels(dev, measured, sms, clock_hz):
    from csbsr_tpu_torch.ops.edt import _column_distance, edt
    from csbsr_tpu_torch.ops.minplus import launch_plan, minplus_rows, minplus_rows_reference

    gen = torch.Generator(device=dev).manual_seed(SEED)
    checks, max_err = [], 0.0
    for shape, density in CHECK_SHAPES:
        mask = torch.rand(shape, generator=gen, device=dev) < density
        g = _column_distance(mask).contiguous()
        out, ref = minplus_rows(g), minplus_rows_reference(g)
        torch.cuda.synchronize()
        equal = torch.equal(out, ref)
        err = float((out - ref).abs().max())
        max_err = max(max_err, err)
        plan = launch_plan(g.numel() // shape[-1], shape[-1], sms)
        checks.append({"shape": list(shape), "density": density, "equal": equal,
                       "max_abs_err": err, "split": plan.split, "threads": plan.threads,
                       "blocks": plan.blocks})
        if not equal:
            raise AssertionError(f"minplus kernel != plain version at {shape}: {err}")

    small = (torch.rand((61, 77), generator=gen, device=dev) < 0.03)
    small[5, 7] = True
    d = edt(small).cpu().numpy()
    ref = _brute_edt(small.cpu().numpy())
    edt_err = float(abs(d - ref).max())
    if edt_err > 1e-5:
        raise AssertionError(f"EDT disagrees with brute force: {edt_err}")

    # the three shapes of the main paths, on the column pass of a 2% mask
    by_shape = []
    for shape in TIMED_SHAPES:
        g = _column_distance(torch.rand(shape, generator=gen, device=dev) < 0.02).contiguous()
        by_shape.append(_time_minplus(g, measured, sms, clock_hz))
    bank = by_shape[0]
    entry = {
        "name": "minplus_rows", "route": "cuda", "source": "csbsr_tpu_torch/csrc/minplus.cu",
        "replaces": "csbsr_tpu/ops/pallas/minplus.py:68", "launches": None,
        "max_abs_err": max_err, "ms": bank["ms"], "plain_ms": bank["plain_ms"],
        "bound_ms": bank["bound_ms"], "bound_by": bank["bound_by"], "library_ms": None,
        "shape": bank["shape"],
        "by_shape": [{k: r[k] for k in ("shape", "ms", "trace_ms", "plain_ms", "bound_ms",
                                        "bound_by", "share_of_bound")} for r in by_shape],
    }
    emit({"phase": "kernels", "minplus_checks": checks, "edt_vs_bruteforce_max_err": edt_err,
          "minplus_by_shape": by_shape, "minplus": entry})
    return [entry]


def phase_main_path(dev):
    from csbsr_tpu_torch.config.flagship import flagship_cfg
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss, thresholds_for
    from csbsr_tpu_torch.metrics.device_surface import distance_metrics_banked
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.ops.minplus import minplus_rows_reference

    cfg = flagship_cfg(SEED)
    t0 = time.perf_counter()
    model = model_from_cfg(cfg, device=dev)
    build_s = time.perf_counter() - t0
    data = SyntheticCrackSet(cfg, N_IMAGES, HR_SIZE, dev, seed=SEED)
    torch.cuda.synchronize()
    kept = {}

    def keep_first(fname, sr_pred, seg_pred, k2d):
        if not kept:
            kept.update(sr=sr_pred, seg=seg_pred, k2d=k2d)

    cuda_build.LAUNCHES.clear()
    rows, summary, _ = score_for_ss(cfg, model, data, device=dev, test_aiu=True,
                                    test_surface_distance=True, on_image=keep_first,
                                    log_fn=lambda *a: None)
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)

    if launches.get("minplus_rows", 0) != 2 * N_IMAGES:
        raise AssertionError(f"expected {2 * N_IMAGES} minplus launches, got {launches}")
    bad = {k: v for k, v in summary.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    if tuple(kept["sr"].shape) != (1, 3, HR_SIZE, HR_SIZE) or \
            tuple(kept["seg"].shape) != (1, 1, HR_SIZE, HR_SIZE):
        raise AssertionError(f"unexpected output shapes {kept['sr'].shape} {kept['seg'].shape}")

    # the same HD bank, kernel vs plain row pass, on image 0
    seg_t = data.get(0)[2][None]
    th = torch.as_tensor(thresholds_for(True), device=dev)
    prob, gt = kept["seg"][:, 0], (seg_t[:, 0] > 0.5).float()
    pad = (0, -(-HR_SIZE // 64) * 64 - HR_SIZE, 0, -(-HR_SIZE // 64) * 64 - HR_SIZE)
    prob, gt = torch.nn.functional.pad(prob, pad), torch.nn.functional.pad(gt, pad)
    hd_k, msd_k = distance_metrics_banked(prob, gt, th, max_len=HR_SIZE)
    hd_p, msd_p = distance_metrics_banked(prob, gt, th, max_len=HR_SIZE,
                                          row_pass=minplus_rows_reference)
    if not (torch.equal(hd_k, hd_p) and torch.equal(msd_k, msd_p)):
        raise AssertionError("HD/MSD differ between the kernel and the plain row pass")

    ref = check_against_cpu(model, cfg, data.get(0)[0][:1])
    secs = [r["seconds"] for r in rows]
    emit({"phase": "main_path", "config": "configs/config_csbsr_pspnet.yaml (random init, "
          f"seed {SEED}, bf16 compute)", "images": N_IMAGES, "image_hw": [HR_SIZE, HR_SIZE],
          "patches_per_image": int(data.get(0)[0].shape[0]),
          "lr_patch_hw": list(data.get(0)[0].shape[-2:]),
          "params": sum(p.numel() for p in model.parameters()),
          "model_build_s": build_s, "summary": summary,
          "first_image_s": secs[0], "images_per_s_after_warmup": (len(secs) - 1) / sum(secs[1:]),
          "per_image_s": secs, "launches": launches,
          "hd_plain_row_pass_equal": True, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "float32_vs_cpu": ref})
    return launches


def _time_minplus(g, measured, sms, clock_hz):
    """Kernel and plain-version device ms on `g`, the kernel's trace time
    and that of the same launch with an empty k range (staging, barriers,
    stores), and the bound of the work from the measured rates."""
    from csbsr_tpu_torch.bench_minplus import device_ms, trace_ms
    from csbsr_tpu_torch.ops.minplus import (launch, launch_plan, minplus_rows,
                                             minplus_rows_reference)
    from csbsr_tpu_torch.ops.rates import minplus_bound

    ms = device_ms(lambda: minplus_rows(g), reps=25)
    plain_ms = device_ms(lambda: minplus_rows_reference(g), reps=5, warmup=1)
    plan = launch_plan(g.numel() // g.shape[-1], g.shape[-1], sms)
    bound = minplus_bound(tuple(g.shape), measured, sms, clock_hz)
    return {"shape": list(g.shape), "ms": ms, "plain_ms": plain_ms,
            "trace_ms": trace_ms(lambda: minplus_rows(g), reps=25),
            "empty_k_trace_ms": trace_ms(lambda: launch(g, plan._replace(kslice=0)), reps=25),
            **bound, "share_of_bound": bound["bound_ms"] / ms}


def phase_train(dev):
    import tempfile

    from csbsr_tpu_torch.config.flagship import flagship_cfg
    from csbsr_tpu_torch.data import IterationBasedLoader, SubsetView
    from csbsr_tpu_torch.engine.phase import phase_config_from_cfg
    from csbsr_tpu_torch.engine.train_state import KERNEL, SR_CORE, grad_group_ids
    from csbsr_tpu_torch.engine.trainer import build_train_step, do_train
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.ops.edt import sdf_normalized
    from csbsr_tpu_torch.ops.minplus import minplus_rows_reference
    from csbsr_tpu_torch.train import build_datasets, split_and_eval_batches

    cfg = flagship_cfg(SEED)
    b = cfg.SOLVER.BATCH_SIZE
    pool = build_datasets(cfg, synthetic=True)
    train_idx, _ = split_and_eval_batches(cfg, pool, max_eval_batches=1)
    n_train = len(train_idx)
    n_loop = TRAIN_WARMUP + TRAIN_TIMED
    n_steps = n_loop + len(LATE_ITERATIONS)
    loader = IterationBasedLoader(SubsetView(pool, train_idx), b, n_steps, seed=cfg.SEED,
                                  num_workers=4)
    model = model_from_cfg(cfg, device=dev)
    pc = phase_config_from_cfg(cfg, n_train)
    groups = grad_group_ids(model.named_parameters())

    def snapshot(gid):
        return {n: p.detach().clone() for n, p in model.named_parameters() if groups[n] == gid}

    def changed(snap):
        params = dict(model.named_parameters())
        return [n for n, v in snap.items() if not torch.equal(params[n], v)]

    # iterations 1..13 through do_train itself (one-ahead pinned copies); it
    # logs every step after reading the step's losses back, so the gaps
    # between log calls are the step times
    batches = iter(loader)
    loop_batches = [next(batches) for _ in range(n_loop)]
    log_t = []
    init_weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    kernel_before, core_before = snapshot(KERNEL), snapshot(SR_CORE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg.OUTPUT_DIR = out_dir
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        state = do_train(cfg, model, loop_batches, None, log_step=1, save_step=0,
                         eval_step_every=0, num_train_ds=n_train,
                         log_fn=lambda line: log_t.append(time.perf_counter()))
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            losses = [{"iteration": r["step"], **{k: r[k] for k in ("loss", "seg_loss", "sr_loss")}}
                      for r in map(json.loads, f)]
    step_s = [log_t[0] - t0] + [t1 - t0 for t0, t1 in zip(log_t, log_t[1:])]
    gt_core_changed, gt_kernel_changed = changed(core_before), changed(kernel_before)
    # then the same train step at the window edges, with the step counter set
    step = build_train_step(cfg, pc)
    late = {}
    for it, hb in zip(LATE_ITERATIONS, batches):
        state.step = it - 1
        kernel_before, core_before = snapshot(KERNEL), snapshot(SR_CORE)
        m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in hb.items()})
        late[it] = {"loss": float(m["loss"]), "seg_loss": float(m["seg_loss"]),
                    "sr_loss": float(m["sr_loss"]), "alpha": m["alpha"],
                    "kernel_params_changed": len(changed(kernel_before)),
                    "sr_core_params_changed": len(changed(core_before))}
        losses.append({"iteration": it, **{k: late[it][k] for k in ("loss", "seg_loss",
                                                                      "sr_loss")}})
    torch.cuda.synchronize()
    launches = dict(cuda_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    bad = [r for r in losses if not all(math.isfinite(r[k]) for k in ("loss", "seg_loss",
                                                                        "sr_loss"))]
    if bad:
        raise AssertionError(f"non-finite train losses: {bad}")
    per_step = 2  # sdf_normalized of the shared target: two EDTs
    if launches.get("minplus_rows", 0) != per_step * n_steps:
        raise AssertionError(f"expected {per_step * n_steps} minplus launches in {n_steps} "
                             f"train steps, got {launches}")
    if gt_kernel_changed or not gt_core_changed:
        raise AssertionError(f"GT-kernel window: KERNEL params changed {gt_kernel_changed}, "
                             f"SR_CORE params changed {len(gt_core_changed)}")
    k_win = late[LATE_ITERATIONS[0]]
    if k_win["sr_core_params_changed"] or not k_win["kernel_params_changed"]:
        raise AssertionError(f"kernel window: {k_win}")

    # the SDF of one training batch: kernel against the plain row pass
    first = {k: torch.from_numpy(v).to(dev) for k, v in loop_batches[0].items()}
    mask = first["seg"] > 0.5
    if not torch.equal(sdf_normalized(mask), sdf_normalized(mask, minplus_rows_reference)):
        raise AssertionError("train SDF differs between the kernel and the plain row pass")

    cpu_check = check_train_step_against_cpu(model, cfg, pc, first, init_weights)
    timed = step_s[TRAIN_WARMUP:]
    emit({"phase": "train", "config": "configs/config_csbsr_pspnet.yaml (random init, seed "
          f"{SEED}, bf16 compute)", "entry": "engine/trainer.do_train, then its train step",
          "batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE),
          "train_pool": len(pool), "steps": n_steps, "first_step_s": step_s[0],
          "steps_per_s_after_warmup": len(timed) / sum(timed),
          "images_per_s_after_warmup": b * len(timed) / sum(timed), "step_s": step_s,
          "peak_mem_gb": peak_gb, "launches": launches, "minplus_launches_per_step": per_step,
          "losses": losses, "late_iterations": late, "sdf_plain_row_pass_equal": True,
          "float32_vs_cpu": cpu_check})
    return launches


def _step_grads(model, weights, batch, phase, dtype, loss_fn):
    """Load `weights` into `model` in `dtype`, run one train-mode step
    (dropout off, TF32 off, no optimizer) and return (loss, {name: grad as a
    float64 CPU copy})."""
    from csbsr_tpu_torch.utils.device import full_fp32

    model.to(dtype).load_state_dict(weights)
    model.dtype = dtype
    model.train()
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.eval()
    b = {k: v.to(dtype) for k, v in batch.items()}
    with full_fp32():
        out = model(b["lr"], b["kernel"].reshape(b["kernel"].shape[0], -1),
                    phase["use_gt_kernel"])
        loss = loss_fn(out, b, phase)["total"]
        model.zero_grad(set_to_none=True)
        loss.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).detach().to(
        "cpu", torch.float64, copy=True) for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def _rel_l2(grads, ref, names):
    """|grads - ref| / |ref| over the tensors `names`, flattened together."""
    diff = math.sqrt(sum(float((grads[k] - ref[k]).square().sum()) for k in names))
    norm = math.sqrt(sum(float(ref[k].square().sum()) for k in names))
    return diff / norm if norm else (0.0 if diff == 0.0 else math.inf)


def check_train_step_against_cpu(model, cfg, pc, batch, weights):
    """One train-mode step (forward, loss, backward; TF32 off, dropout off;
    no optimizer) on the card and on the host CPU, on the same `weights`
    (the seeded initial ones) and batch, at iteration 1 (GT-kernel window,
    SR loss alone) and at 30001 (joint phase, SR and seg losses), in float64
    and in float32. The initial weights make the CPU side deterministic: the
    weights after the bf16 train steps vary from run to run, and with them
    the CPU's own float32 error, the envelope's unit (on KERNEL 3.1% in one
    run; in another the card's 3.9% was more than 10x the CPU's).

    - float64: the loss to FLOAT64_LOSS_TOL relative, and every gradient
      tensor of every group elementwise to FLOAT64_GRAD_TOL of its largest
      |value| (floored at 1e-3 of the model's largest |grad|: conv biases
      that feed a train-mode BatchNorm have a zero gradient in exact
      arithmetic). Float64 rounding leaves the two far inside that, so any
      difference in what the card computes shows, in PSPNet's backward as
      anywhere else.
    - float32: the loss to 1e-4 relative. The float32 gradient of the joint
      phase is itself about 1% off the float64 one in relative L2, on the
      card and on the CPU alike (PERF.md), so it cannot be held elementwise;
      instead, per gradient group (SR_CORE, KERNEL, SEG, BLURSKIP), the
      card's relative L2 distance from the CPU's float64 gradient must stay
      within FLOAT32_ENVELOPE times the CPU's own float32 distance from it,
      or under FLOAT32_FLOOR. A group whose float64 gradient is zero (SEG at
      iteration 1) must be zero on the card too.

    On an H100 80GB HBM3 (700 W) at batch 2, initial weights: float32
    group errors at 30001 SR_CORE/KERNEL/SEG on the card 1.52-1.56%,
    0.68-0.94% and 1.07-1.23% over two runs, on the CPU 1.358%, 1.94% and
    0.863% in both; at iteration 1 1e-5 (SR_CORE); float64 within 1.3e-12.
    The float64 CPU step takes about 90 s."""
    from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
    from csbsr_tpu_torch.engine.phase import compute_phase
    from csbsr_tpu_torch.engine.train_state import grad_group_ids
    from csbsr_tpu_torch.engine.trainer import (DEGRADE_STREAM, make_degrade_fn,
                                                step_generator)
    from csbsr_tpu_torch.models import model_from_cfg

    n = CPU_CHECK_BATCH
    hr = batch["hr"][:n]
    lr, kernels = make_degrade_fn(cfg)(hr, step_generator(SEED, 0, DEGRADE_STREAM, hr.device))
    data = {"card": {"hr": hr, "seg": batch["seg"][:n], "lr": lr, "kernel": kernels}}
    data["cpu"] = {k: v.cpu() for k, v in data["card"].items()}
    models = {"card": model, "cpu": model_from_cfg(cfg, device="cpu")}
    loss_fn = build_loss_fn(cfg)
    trained = {k: v.clone() for k, v in model.state_dict().items()}
    group_of = grad_group_ids(model.named_parameters())
    names = {"SR_CORE": 0, "KERNEL": 1, "SEG": 2, "BLURSKIP": 3}
    groups = {g: [k for k, v in group_of.items() if v == gid] for g, gid in names.items()}
    compute = model.dtype
    report = {}
    for it in (1, LATE_ITERATIONS[-1]):
        phase = compute_phase(it, pc)
        loss, grads, seconds = {}, {}, {}
        for where in ("card", "cpu"):
            for dtype in (torch.float64, torch.float32):
                key = f"{where}_{str(dtype)[6:]}"
                t0 = time.perf_counter()
                loss[key], grads[key] = _step_grads(models[where], weights, data[where], phase,
                                                    dtype, loss_fn)
                seconds[key] = time.perf_counter() - t0
        bad = []
        # float64: elementwise, every tensor
        ref = grads["cpu_float64"]
        floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
        elem = {k: float((grads["card_float64"][k] - r).abs().max())
                / max(float(r.abs().max()), floor) for k, r in ref.items()}
        loss64_err = abs(loss["card_float64"] - loss["cpu_float64"]) / abs(loss["cpu_float64"])
        bad += [("float64 loss", loss64_err)] if loss64_err > FLOAT64_LOSS_TOL else []
        bad += [(f"float64 {k}", e) for k, e in elem.items() if e > FLOAT64_GRAD_TOL]
        # float32: the loss, and each group against the CPU's float32 envelope
        loss32_err = abs(loss["card_float32"] - loss["cpu_float32"]) / abs(loss["cpu_float32"])
        bad += [("float32 loss", loss32_err)] if loss32_err > 1e-4 else []
        by_group = {}
        for g, ks in groups.items():
            if not ks:
                continue
            card_err = _rel_l2(grads["card_float32"], ref, ks)
            cpu_err = _rel_l2(grads["cpu_float32"], ref, ks)
            limit = max(FLOAT32_ENVELOPE * cpu_err, FLOAT32_FLOOR)
            by_group[g] = {"tensors": len(ks), "card_rel_l2": card_err, "cpu_rel_l2": cpu_err,
                           "limit": limit}
            if not card_err <= limit:
                bad.append((f"float32 group {g}", card_err))
        if bad:
            raise AssertionError(f"train step at iteration {it} differs between the card and "
                                 f"the CPU: {bad[:5]}; losses {loss}")
        every = list(ref)
        report[it] = {
            "loss": loss, "float64_loss_rel_err": loss64_err,
            "float64_worst": sorted(((e, k) for k, e in elem.items()), reverse=True)[:3],
            "float32_loss_rel_err": loss32_err, "float32_by_group": by_group,
            "float32_all": {"card_rel_l2": _rel_l2(grads["card_float32"], ref, every),
                            "cpu_rel_l2": _rel_l2(grads["cpu_float32"], ref, every),
                            "card_vs_cpu_rel_l2": _rel_l2(grads["card_float32"],
                                                          grads["cpu_float32"], every)},
            "seconds": seconds}
    model.to(torch.float32).load_state_dict(trained)
    model.dtype = compute
    return {"batch": n, "float64_grad_tol": FLOAT64_GRAD_TOL, "float64_loss_tol": FLOAT64_LOSS_TOL,
            "float32_envelope": FLOAT32_ENVELOPE, "float32_floor": FLOAT32_FLOOR,
            "by_iteration": report}


def zoo_cfg(recipe: str):
    from csbsr_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "configs", f"{recipe}.yaml"))
    cfg.merge_from_list(ZOO_WINDOWS)
    cfg.SEED = SEED
    return cfg


def phase_zoo(dev, name, recipe):
    """One recipe of configs/ at full width: eval, card vs CPU, train."""
    import tempfile

    from csbsr_tpu_torch.data import IterationBasedLoader, SubsetView
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss
    from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
    from csbsr_tpu_torch.engine.trainer import do_train
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.train import build_datasets, split_and_eval_batches

    t_start = time.perf_counter()
    cfg = zoo_cfg(recipe)
    model = model_from_cfg(cfg, device=dev)
    data = SyntheticCrackSet(cfg, ZOO_IMAGES, HR_SIZE, dev, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    rows, summary, _ = score_for_ss(cfg, model, data, device=dev, test_aiu=True,
                                    test_surface_distance=True, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    eval_launches = dict(cuda_build.LAUNCHES)
    eval_peak = torch.cuda.max_memory_allocated() / 1e9
    if eval_launches.get("minplus_rows", 0) != 2 * ZOO_IMAGES:
        raise AssertionError(f"{name}: expected {2 * ZOO_IMAGES} minplus launches in eval, "
                             f"got {eval_launches}")
    # DBPN predicts no kernel: its kernel PSNR is 0/0, NaN, as in the JAX package
    nan_ok = {"PSNR_kernel"} if cfg.MODEL.SR != "KBPN" else set()
    bad = {k: v for k, v in summary.items() if not math.isfinite(v) and k not in nan_ok}
    if bad or any(math.isfinite(summary[k]) for k in nan_ok):
        raise AssertionError(f"{name}: unexpected metrics {summary}")
    # CrackFormer's max-unpool places each value at its window's argmax, so a
    # near tie that float32 rounding breaks the other way moves a value (the
    # card's float32 seg map is 15% off the CPU's where float64 agrees to
    # 3e-13): its float32 comparison is reported, float64 held, as for all
    patch = data.get(0)[0][:1, :, :16, :16]
    cpu_check = {"float32": check_against_cpu(model, cfg, patch,
                                              hold=cfg.MODEL.DETECTOR_TYPE != "CrackFormer"),
                 "float64": check_against_cpu(model, cfg, patch, torch.float64)}

    b = cfg.SOLVER.BATCH_SIZE
    pool = build_datasets(cfg, synthetic=True)
    train_idx, _ = split_and_eval_batches(cfg, pool, max_eval_batches=1)
    pc = phase_config_from_cfg(cfg, len(train_idx))
    loader = IterationBasedLoader(SubsetView(pool, train_idx), b, ZOO_STEPS, seed=cfg.SEED,
                                  num_workers=4)
    batches = list(loader)
    params_before = {n: p.detach().clone() for n, p in model.named_parameters()}
    log_t = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        cfg.OUTPUT_DIR = out_dir
        cuda_build.LAUNCHES.clear()
        t0 = time.perf_counter()
        do_train(cfg, model, batches, None, log_step=1, save_step=0, eval_step_every=0,
                 num_train_ds=len(train_idx), log_fn=lambda line: log_t.append(time.perf_counter()))
        torch.cuda.synchronize()
        train_launches = dict(cuda_build.LAUNCHES)
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            losses = [{k: r[k] for k in ("step", "loss", "seg_loss", "sr_loss")}
                      for r in map(json.loads, f)]
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    step_s = [log_t[0] - t0] + [t1 - t0 for t0, t1 in zip(log_t, log_t[1:])]
    phases = [compute_phase(it, pc) for it in range(1, ZOO_STEPS + 1)]
    if any(p["in_sr_pretrain"] or p["in_seg_pretrain"] or p["use_gt_kernel"] for p in phases):
        raise AssertionError(f"{name}: a zoo step is not in the joint phase")
    if any(not all(math.isfinite(r[k]) for k in ("loss", "seg_loss", "sr_loss")) for r in losses):
        raise AssertionError(f"{name}: non-finite train losses {losses}")
    if train_launches.get("minplus_rows", 0) != 2 * ZOO_STEPS:
        raise AssertionError(f"{name}: expected {2 * ZOO_STEPS} minplus launches in "
                             f"{ZOO_STEPS} train steps, got {train_launches}")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, params_before[n])}
    if cfg.MODEL.DETECTOR_TYPE.startswith("PSPNet_BlurSkip"):
        if not moved or any(".blur_skip." not in n for n in moved):
            raise AssertionError(f"{name}: the fine-tune moved {sorted(moved)[:5]}")
    elif not any(n.startswith("segmentation_model.") for n in moved):
        raise AssertionError(f"{name}: the joint step left the seg head unchanged")
    eval_s = [r["seconds"] for r in rows]
    timed = step_s[1:]
    emit({"phase": "zoo", "recipe": f"configs/{recipe}.yaml", "name": name,
          "model": f"{cfg.MODEL.SR} + {cfg.MODEL.DETECTOR_TYPE}",
          "config": f"random init, seed {SEED}, bf16 compute, full width",
          "params": sum(p.numel() for p in model.parameters()),
          "eval": {"images": ZOO_IMAGES, "image_hw": [HR_SIZE, HR_SIZE], "per_image_s": eval_s,
                   "images_per_s_after_first": (len(eval_s) - 1) / sum(eval_s[1:]),
                   "summary": summary, "peak_mem_gb": eval_peak, "launches": eval_launches,
                   "minplus_launches_per_image": 2},
          "vs_cpu": cpu_check,
          "train": {"batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE), "steps": ZOO_STEPS,
                    "step_s": step_s, "steps_per_s_after_first": len(timed) / sum(timed),
                    "images_per_s_after_first": b * len(timed) / sum(timed),
                    "phases": [{"iteration": p["iteration"], "sr_pretrain": p["in_sr_pretrain"],
                                "use_gt_kernel": p["use_gt_kernel"]} for p in phases],
                    "losses": losses, "peak_mem_gb": train_peak, "launches": train_launches,
                    "minplus_launches_per_step": 2, "params_moved": len(moved)},
          "seconds": time.perf_counter() - t_start})
    del model
    torch.cuda.empty_cache()
    return eval_launches, train_launches


def check_against_cpu(model, cfg, patch, dtype=torch.float32, hold=True):
    """The full-width model on the card in `dtype` (float32: no TF32) against
    the same weights on the host CPU, on one LR patch. The CPU path is the
    one the tests hold to the JAX package; the two differ only in summation
    order. Tolerance 1e-3 of each output's largest |value| in float32, 1e-6
    in float64; `hold=False` reports without holding. Also reports how far
    the compute-dtype (bf16) run is from `dtype` (not a check)."""
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.utils.device import full_fp32

    tol = 1e-3 if dtype == torch.float32 else 1e-6
    cpu_model = model_from_cfg(cfg, device="cpu", dtype=dtype, seed=SEED).to(dtype)
    compute = model.dtype

    def run(m, x):
        """m's outputs, and for HRNet-OCR its heads' logits, whose sigmoids
        saturate with random weights (0 to the last bit on the seg map)"""
        out, hooks = {}, []
        for head in HEAD_LOGITS:
            if hasattr(m.segmentation_model, head):
                hooks.append(getattr(m.segmentation_model, head).register_forward_hook(
                    lambda mod, inp, o, k=head: out.__setitem__(f"{k}_logits", o)))
        try:
            with torch.inference_mode():
                return {**m(x, clip_sr=True), **out}
        finally:
            for h in hooks:
                h.remove()

    with full_fp32():
        low, cpu = run(model, patch), run(cpu_model, patch.cpu().to(dtype))
        # outside inference mode: the model's tensors must stay trainable
        model.to(dtype)
        model.dtype = dtype
        try:
            gpu = run(model, patch.to(dtype))
        finally:  # float32 -> float64 -> float32 is exact
            model.to(torch.float32)
            model.dtype = compute
    keys = [k for k, v in cpu.items() if v is not None]

    def rel(a, ref):
        """max |a - ref| relative to max |ref|; an all-zero ref (DBPN's
        kernel) must be matched exactly"""
        scale = float(ref.abs().max())
        diff = float((a.to(ref.dtype).cpu() - ref.cpu()).abs().max())
        return diff / scale if scale else (0.0 if diff == 0.0 else math.inf)

    err = {k: rel(gpu[k], cpu[k]) for k in keys}
    if hold and max(err.values()) > tol:
        raise AssertionError(f"CUDA {dtype} model disagrees with the CPU: {err} (tolerance {tol})")
    low_err = {k: rel(low[k], gpu[k]) for k in keys}
    return {"dtype": str(dtype)[6:], "max_rel_err": err, "tolerance": tol, "held": hold,
            "input_hw": list(patch.shape[-2:]), "compute_dtype_vs_this_dtype_max_rel": low_err}


def main():
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: CUDA is not available\n")
        return 2
    sys.path.insert(0, REPO)
    import csbsr_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_env()
    phase_build()
    measured, sms, clock_hz = phase_rates(dev)
    kernels = phase_kernels(dev, measured, sms, clock_hz)
    paths = {"eval": phase_main_path(dev), "train": phase_train(dev)}
    for name, recipe in ZOO:
        paths[f"zoo_eval:{name}"], paths[f"zoo_train:{name}"] = phase_zoo(dev, name, recipe)
    for k in kernels:
        by_path = {path: launches.get(k["name"], 0) for path, launches in paths.items()}
        k.update(launches=sum(by_path.values()), launches_by_path=by_path)
    emit({"phase": "done", "seconds": time.perf_counter() - T0})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
