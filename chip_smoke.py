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
                distance on a small mask; at the four main-path shapes
                (99, 449, 449), (1, 449, 449), (6, 1, 224, 224) and the
                inverse model's LR target (6, 1, 56, 56) the
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
                path (2 min-plus launches per image and per step). The wf
                recipe (the flagship with the failure-oriented SR weight)
                takes one step of the train step at 30002 instead, where
                that weight acts. One JSON line per recipe: images/s,
                steps/s, peak memory, launches.
  8. serve      the serving half of the test CLI, int8 serving included:
                the flagship at full width through engine/inference.inference_tti
                on TTI_IMAGES synthetic unlabelled 448x448 PNGs made from the
                seed in a temporary directory (64x64 patches: 49 per image,
                1792x1792 SR; chunks of 12), in bf16 and then in int8
                (calibrated on the first image's first 12 patches, as the CLI
                does), with images/s, the device part alone and peak memory;
                the serve_latency table (B = 1, 4, 8 at 56x56; full 448 and
                896 images, float and uint8 crossings; bf16 and int8) and its
                conv table (each int8 conv shape of a 12-patch call: bf16 conv,
                int8 conv, int8 product, bounds); card against CPU in int8 on
                one 56x56 patch: in float64 the card's int8 outputs equal the
                CPU's to 1e-12 in relative L2, with static and with dynamic
                scales (the quantization decisions agree); in float32 the
                calibrated abs-maxima within 1e-4 relative, the card's int8
                outputs within 1.5x of the CPU's int8 error against its float
                output, and within 2x of that error of the CPU's int8 outputs
                (level flips cascade, see tests/test_torch_port_int8.py); for
                each of the six recipes the bf16-vs-int8 agreement on the
                patches of one 448x448 image (int8_accuracy.agreement, with
                the int8 conv count), then that image through score_for_ss
                with the HD bank in int8 (2 min-plus launches); last, the
                _int_mm route against its float64 plain version with
                torch.equal on the int32 accumulators, for every distinct int8
                conv configuration (kind, kernel, stride, padding, dilation,
                groups) that the six recipes' serving paths ran, at the input
                shapes of its largest call (the 896x896 image's 16 patches,
                TTI's 12-patch chunk) and its smallest (one patch), with the
                weight of the module that made that call.
  9. surface    (run after the zoo) the rest of the training surface, each
                variant of SURFACE at full width from the seed's random
                weights, bf16, batch 6 of 224x224 crops, through do_train:
                sr_pretrain (DATASET.ONLY_IMAGES on PNGs it writes; 3 steps
                from iteration 1, then one at 10001, the kernel window),
                whose SR net it saves under the name do_train looks for;
                joint_from_pretrain (the flagship loading that file from a
                temporary weights directory: its SR net equal to the saved
                one before step 1; 2 steps); seg_only_x1, bicubic, inverse
                (DBPN + PSPNet, MODEL.SR_SEG_INV: its SDF at (6, 1, 56, 56)),
                sgd, blur_photometric (BLUR.MODE all_rand, RandomResizedCrop
                and PhotometricDistort over PNG pairs it writes) and
                crackformer_rcf (CrackFormerLoss), 3 joint-phase steps each.
                Launch counts reset just before and read just after each
                variant's steps (0 min-plus launches for sr_pretrain and
                crackformer_rcf, 2 per step for the others). sr_pretrain and
                inverse first take check_surface_step_against_cpu. One JSON
                line per variant (images/s after the first step, peak
                memory, launches, first and last loss), then the phase's
                seconds.
 10. baselines  (run after surface, before serve) the paper's other joint
                baselines, each the flagship recipe with overrides: DSRL with
                ResNet-101 (bilinear and deconv upsampling), DRN-D-54,
                MobileNetV2 and Xception, KBPN + SegNet, SrcNetSR + PSPNet;
                full width, seed's random weights, bf16: 2 eval images of
                448x448 through score_for_ss with the HD bank, the model in
                float64 on the card against the CPU on a 16x16 LR patch, 3
                joint-phase steps of do_train at batch 6 of 224x224 crops
                (2 min-plus launches per image and per step, counts reset
                just before and read just after each path); DSRL-ResNet's
                float64 train step on the card against the CPU at LR 32
                (check_surface_step_against_cpu); for DSRL-ResNet, SegNet
                and SrcNetSR the bf16-vs-int8 agreement on one image and
                that image in int8 (its int8 conv configurations join the
                serve phase's exactness check). One JSON line per row
                (images/s, peak memory, launches), then the phase's seconds.

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
                ((6, 1, 224, 224), 0.02), ((6, 1, 224, 224), 0.0), ((6, 1, 56, 56), 0.02),
                ((1, 1, 1), 0.5),
                ((7, 31), 0.1), ((9, 33), 0.1), ((3, 2896), 0.01), ((64, 2896), 0.01))
# HD bank, GT border, train SDF, the inverse model's LR train SDF
TIMED_SHAPES = ((99, 449, 449), (1, 449, 449), (6, 1, 224, 224), (6, 1, 56, 56))
ZOO = (("dbpn_pspnet", "config_cssr_pspnet"), ("unet16", "config_csbsr_unet"),
       ("pspnet_blurskip", "config_csbsr_pspnet_blurskip"),
       ("crackformer", "config_csbsr_crackformer"), ("hrnet_ocr", "config_csbsr_hrnet"),
       ("wf", "config_csbsr_pspnet_wf"))
ZOO_IMAGES, ZOO_STEPS = 2, 3
# a zoo recipe trained at these iterations by the train step (not do_train
# from iteration 1): wf's failure-oriented SR weight acts from iteration >
# ORIENTED_WEIGHT_ITER (30001)
ZOO_ITERATIONS = {"wf": (30002,)}
SERVED_ZOO = tuple(z for z in ZOO if z[0] != "wf")  # wf serves the flagship's model
TTI_IMAGES, TTI_SIZE, TTI_PATCH, TTI_CHUNK = 3, 448, 64, 12  # the CLI's 64 and batch_size
LATENCY_ITERS = 10
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
                         log_fn=lambda line: line.startswith("===> Iter") and log_t.append(
                             time.perf_counter()))
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


def zoo_cfg(recipe: str, joint: bool = True):
    """configs/<recipe>.yaml with the seed; with `joint`, no pretrain windows."""
    from csbsr_tpu_torch.config import get_cfg_defaults

    cfg = get_cfg_defaults()
    cfg.merge_from_file(os.path.join(REPO, "configs", f"{recipe}.yaml"))
    if joint:
        cfg.merge_from_list(ZOO_WINDOWS)
    cfg.SEED = SEED
    return cfg


def phase_zoo(dev, name, recipe):
    """One recipe of configs/ at full width: eval, card vs CPU, train."""
    from csbsr_tpu_torch.data import IterationBasedLoader, SubsetView
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss
    from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
    from csbsr_tpu_torch.engine.train_state import create_train_state
    from csbsr_tpu_torch.engine.trainer import build_train_step
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_build.LAUNCHES.clear()
    iterations = ZOO_ITERATIONS.get(name)
    if iterations is None:  # do_train from iteration 1
        iterations = range(1, ZOO_STEPS + 1)
        step_s, losses, _ = _do_train_steps(cfg, model, batches, len(train_idx))
    else:  # its train step at these iterations
        state = create_train_state(cfg, model, pc)
        step, step_s, losses = build_train_step(cfg, pc), [], []
        for it, hb in zip(iterations, batches):
            state.step = it - 1
            t0 = time.perf_counter()
            m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in hb.items()})
            losses.append({"step": it, **{k: float(m[k]) for k in ("loss", "seg_loss",
                                                                      "sr_loss")}})
            step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    train_launches = dict(cuda_build.LAUNCHES)
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    n_steps = len(losses)
    phases = [compute_phase(it, pc) for it in iterations]
    if any(p["in_sr_pretrain"] or p["in_seg_pretrain"] or p["use_gt_kernel"] for p in phases):
        raise AssertionError(f"{name}: a zoo step is not in the joint phase")
    if any(not all(math.isfinite(r[k]) for k in ("loss", "seg_loss", "sr_loss")) for r in losses):
        raise AssertionError(f"{name}: non-finite train losses {losses}")
    if train_launches.get("minplus_rows", 0) != 2 * n_steps:
        raise AssertionError(f"{name}: expected {2 * n_steps} minplus launches in "
                             f"{n_steps} train steps, got {train_launches}")
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, params_before[n])}
    if cfg.MODEL.DETECTOR_TYPE.startswith("PSPNet_BlurSkip"):
        if not moved or any(".blur_skip." not in n for n in moved):
            raise AssertionError(f"{name}: the fine-tune moved {sorted(moved)[:5]}")
    elif not any(n.startswith("segmentation_model.") for n in moved):
        raise AssertionError(f"{name}: the joint step left the seg head unchanged")
    eval_s = [r["seconds"] for r in rows]
    timed = step_s[1:] or [math.nan]
    emit({"phase": "zoo", "recipe": f"configs/{recipe}.yaml", "name": name,
          "model": f"{cfg.MODEL.SR} + {cfg.MODEL.DETECTOR_TYPE}",
          "config": f"random init, seed {SEED}, bf16 compute, full width",
          "params": sum(p.numel() for p in model.parameters()),
          "eval": {"images": ZOO_IMAGES, "image_hw": [HR_SIZE, HR_SIZE], "per_image_s": eval_s,
                   "images_per_s_after_first": (len(eval_s) - 1) / sum(eval_s[1:]),
                   "summary": summary, "peak_mem_gb": eval_peak, "launches": eval_launches,
                   "minplus_launches_per_image": 2},
          "vs_cpu": cpu_check,
          "train": {"batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE), "steps": n_steps,
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


# the surface phase: name -> (recipe, overrides, steps by do_train from
# iteration 1, iterations of the train step after them, min-plus launches per
# step, card-vs-CPU check); every variant but sr_pretrain trains in the joint
# phase (ZOO_WINDOWS), sr_pretrain in the recipe's GT-kernel and kernel windows
SURFACE = {
    "sr_pretrain": ("config_csbsr_pspnet", ["DATASET.ONLY_IMAGES", True], 3, (10001,), 0, True),
    "joint_from_pretrain": ("config_csbsr_pspnet", [], 2, (), 2, False),
    "seg_only_x1": ("config_csbsr_pspnet", ["MODEL.SCALE_FACTOR", 1], 3, (), 2, False),
    "bicubic": ("config_csbsr_pspnet", ["MODEL.SR", "bicubic"], 3, (), 2, False),
    "inverse": ("config_cssr_pspnet", ["MODEL.SR_SEG_INV", True], 3, (), 2, True),
    "sgd": ("config_csbsr_pspnet", ["MODEL.OPTIMIZER", "SGD"], 3, (), 2, False),
    "blur_photometric": ("config_csbsr_pspnet", [
        "BLUR.MODE", "all_rand", "DATASET.DATA_AUGMENTATION", [
            ["ConvertFromInts", None],
            ["RandomResizedCrop", {"scale": [0.5, 1.0], "ratio": [0.75, 1.333]}],
            ["PhotometricDistort", None], ["RandomMirror", None]]], 3, (), 2, False),
    "crackformer_rcf": ("config_csbsr_crackformer", ["SOLVER.SEG_LOSS_FUNC", "CrackFormerLoss"],
                        3, (), 0, False),
}
SURFACE_PNGS, SURFACE_PNG_HW = 24, 256  # the PNG sets the phase writes (>= the 224 crop)
SURFACE_CPU_LR = 16  # the card-vs-CPU step's LR side (HR 64)
SURFACE_FLOAT32_FLOOR = 1e-2  # see check_surface_step_against_cpu


def _write_pngs(root, n, hw, masks: bool):
    """n random RGB PNGs (and crack-line masks) under root/images (root/masks)."""
    from PIL import Image

    rng = np.random.RandomState(SEED)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        Image.fromarray((rng.rand(hw, hw, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"p{i}.png"))
        if masks:
            m = np.zeros((hw, hw), np.uint8)
            m[rng.randint(8, hw - 8), :] = m[:, rng.randint(8, hw - 8)] = 255
            Image.fromarray(m, "L").save(os.path.join(root, "masks", f"p{i}.png"))
    return [os.path.join(root, "images"), os.path.join(root, "masks")]


def check_surface_step_against_cpu(cfg, model, it, lr_side=SURFACE_CPU_LR,
                                   dtypes=(torch.float64, torch.float32)):
    """One train-mode step (forward, loss, backward; TF32 off, dropout off;
    no optimizer) of `model`'s current weights on the card and on the host
    CPU, on a batch of CPU_CHECK_BATCH random images at LR `lr_side`
    (degraded on the card; the SR-only variant's masks are zero), at
    iteration `it`, in each of `dtypes`, with the limits of
    check_train_step_against_cpu:

    - float64: the loss to FLOAT64_LOSS_TOL relative and every gradient
      tensor elementwise to FLOAT64_GRAD_TOL of its largest |value| (floored
      at 1e-3 of the model's largest |grad|);
    - float32: the relative error of the loss and, per gradient group, the
      relative L2 of the gradient from the CPU's float64 ones within
      FLOAT32_ENVELOPE times the CPU's own float32 distance from them, or
      SURFACE_FLOAT32_FLOOR. The floor is the float32 accuracy of these
      gradients, not FLOAT32_FLOOR: on an H100 80GB HBM3 (700 W) the float32
      SEG group of the inverse model measured 4.1e-3 against the CPU's
      1.6e-4 (the flagship's train phase reads 0.7-1.6% there), while
      float64 holds it."""
    from csbsr_tpu_torch.engine.losses_glue import build_loss_fn
    from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
    from csbsr_tpu_torch.engine.train_state import grad_group_ids
    from csbsr_tpu_torch.engine.trainer import DEGRADE_STREAM, make_degrade_fn, step_generator
    from csbsr_tpu_torch.models import model_from_cfg

    dev, n = next(model.parameters()).device, CPU_CHECK_BATCH
    hw = lr_side * int(cfg.MODEL.SCALE_FACTOR)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hr = torch.rand((n, 3, hw, hw), generator=gen, device=dev)
    seg = torch.zeros((n, 1, hw, hw), device=dev)
    if not cfg.DATASET.ONLY_IMAGES:
        seg[:, :, hw // 3, :] = seg[:, :, :, hw // 2] = 1.0
    lr, kernels = make_degrade_fn(cfg)(hr, step_generator(SEED, 0, DEGRADE_STREAM, dev))
    data = {"card": {"hr": hr, "seg": seg, "lr": lr, "kernel": kernels}}
    data["cpu"] = {k: v.cpu() for k, v in data["card"].items()}
    weights = {k: v.detach().clone() for k, v in model.state_dict().items()}
    models = {"card": model, "cpu": model_from_cfg(cfg, device="cpu")}
    phase = compute_phase(it, phase_config_from_cfg(cfg, 100))
    loss_fn, compute = build_loss_fn(cfg), model.dtype
    loss, grads = {}, {}
    for where in ("card", "cpu"):
        for dtype in dtypes:
            key = f"{where}_{str(dtype)[6:]}"
            loss[key], grads[key] = _step_grads(models[where], weights, data[where], phase,
                                                dtype, loss_fn)
    model.to(torch.float32).load_state_dict(weights)
    model.dtype = compute
    ref, bad = grads["cpu_float64"], []
    floor = 1e-3 * max(float(r.abs().max()) for r in ref.values())
    elem = {k: float((grads["card_float64"][k] - r).abs().max()) / max(float(r.abs().max()), floor)
            for k, r in ref.items()}
    rel = lambda key: abs(loss[key] - loss["cpu_float64"]) / abs(loss["cpu_float64"])
    bad += [("float64 loss", rel("card_float64"))] if rel("card_float64") > FLOAT64_LOSS_TOL \
        else []
    bad += [(f"float64 {k}", e) for k, e in elem.items() if e > FLOAT64_GRAD_TOL]
    report = {"iteration": it, "batch": n, "lr_hw": [lr_side] * 2, "loss": loss,
              "float64_loss_rel_err": rel("card_float64"), "float64_loss_tol": FLOAT64_LOSS_TOL,
              "float64_worst": sorted(((e, k) for k, e in elem.items()), reverse=True)[:3],
              "float64_grad_tol": FLOAT64_GRAD_TOL}
    if torch.float32 in dtypes:
        loss32 = {"card_rel": rel("card_float32"), "cpu_rel": rel("cpu_float32")}
        loss32["limit"] = max(FLOAT32_ENVELOPE * loss32["cpu_rel"], SURFACE_FLOAT32_FLOOR)
        bad += [("float32 loss", loss32["card_rel"])] \
            if not loss32["card_rel"] <= loss32["limit"] else []
        group_of = grad_group_ids(model.named_parameters())
        by_group = {}
        for g, gid in (("SR_CORE", 0), ("KERNEL", 1), ("SEG", 2), ("BLURSKIP", 3)):
            ks = [k for k, v in group_of.items() if v == gid]
            if not ks:
                continue
            card_err = _rel_l2(grads["card_float32"], ref, ks)
            cpu_err = _rel_l2(grads["cpu_float32"], ref, ks)
            limit = max(FLOAT32_ENVELOPE * cpu_err, SURFACE_FLOAT32_FLOOR)
            by_group[g] = {"tensors": len(ks), "card_rel_l2": card_err, "cpu_rel_l2": cpu_err,
                           "limit": limit}
            if not card_err <= limit:
                bad.append((f"float32 group {g}", card_err))
        report.update({"float32_loss": loss32, "float32_by_group": by_group,
                       "float32_envelope": FLOAT32_ENVELOPE,
                       "float32_floor": SURFACE_FLOAT32_FLOOR})
    if bad:
        raise AssertionError(f"train step at iteration {it} differs between the card and the "
                             f"CPU: {bad[:5]}; losses {loss}")
    return report


def phase_surface(dev):
    """The rest of the training surface: SR-only pretraining, joint training
    from its SR net, the SR-less, bicubic and inverse models, SGD, the
    all_rand blur with the photometric chain, CrackFormerLoss; full width,
    random weights from the seed, bf16 compute, batch 6 of 224 crops. One
    JSON line per variant, then the phase's seconds. Returns the min-plus
    launch counts of each variant's steps."""
    import tempfile

    import csbsr_tpu_torch.engine.losses_glue as glue
    import csbsr_tpu_torch.engine.trainer as trainer
    from csbsr_tpu_torch.data import IterationBasedLoader, SubsetView
    from csbsr_tpu_torch.engine.phase import compute_phase, phase_config_from_cfg
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.train import build_datasets, split_and_eval_batches
    from csbsr_tpu_torch.utils.pretrained import sr_checkpoint_name

    t_start = time.perf_counter()
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        pngs = {"pretrain": _write_pngs(os.path.join(tmp, "pretrain"), SURFACE_PNGS,
                                        SURFACE_PNG_HW, masks=False),
                "pairs": _write_pngs(os.path.join(tmp, "mass_roads"), SURFACE_PNGS,
                                     SURFACE_PNG_HW, masks=True)}
        # sr_pretrain's SR net goes to weights_dir, which joint_from_pretrain
        # alone reads; the others read an empty directory
        weights_dir, no_weights = os.path.join(tmp, "weights"), os.path.join(tmp, "none")
        os.makedirs(weights_dir)
        os.makedirs(no_weights)
        saved = {}  # sr_pretrain's state dict
        for name, (recipe, extra, n_loop, late, per_step, vs_cpu) in SURFACE.items():
            t0 = time.perf_counter()
            cfg = zoo_cfg(recipe, joint=name != "sr_pretrain")
            cfg.merge_from_list(extra)
            if name in ("sr_pretrain", "blur_photometric"):
                data_dirs = pngs["pretrain" if name == "sr_pretrain" else "pairs"]
                cfg.DATASET.TRAIN_IMAGE_DIR, cfg.DATASET.TRAIN_MASK_DIR = data_dirs
            pool = build_datasets(cfg, synthetic=name not in ("sr_pretrain", "blur_photometric"))
            train_idx, _ = split_and_eval_batches(cfg, pool, max_eval_batches=1)
            pc = phase_config_from_cfg(cfg, len(train_idx))
            b = cfg.SOLVER.BATCH_SIZE
            batches = list(IterationBasedLoader(SubsetView(pool, train_idx), b,
                                                n_loop + len(late), seed=cfg.SEED,
                                                num_workers=4))
            model = model_from_cfg(cfg, device=dev)
            report = {"phase": "surface", "variant": name, "recipe": f"configs/{recipe}.yaml",
                      "overrides": extra, "dataset": type(pool).__name__,
                      "model": f"{cfg.MODEL.SR} + {cfg.MODEL.DETECTOR_TYPE}"}
            if vs_cpu:
                report["vs_cpu"] = check_surface_step_against_cpu(cfg, model, 1)
            loads, sdf_shapes = {}, []
            load_sr, sdf = trainer.load_pretrained_sr, glue.boundary_sdf

            def spy_load(cfg_, model_, *a, **k):
                loads["loaded"] = load_sr(cfg_, model_, *a, **k)
                loads["equal"] = loads["loaded"] and all(
                    torch.equal(v, saved[f"sr_model.{k_}"].to(v.device))
                    for k_, v in model_.sr_model.state_dict().items())
                return loads["loaded"]

            trainer.load_pretrained_sr = spy_load
            glue.boundary_sdf = lambda m: sdf_shapes.append(list(m.shape)) or sdf(m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.LAUNCHES.clear()
            try:
                step_s, losses, state = _do_train_steps(
                    cfg, model, batches[:n_loop], len(train_idx),
                    weights_dir=weights_dir if name == "joint_from_pretrain" else no_weights)
                if late:  # the same run's train step, its counter moved on
                    step = trainer.build_train_step(cfg, pc)
                    for it, hb in zip(late, batches[n_loop:]):
                        state.step = it - 1
                        m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in hb.items()})
                        losses.append({"step": it, **{k: float(m[k]) for k in (
                            "loss", "seg_loss", "sr_loss")}})
                torch.cuda.synchronize()
            finally:
                trainer.load_pretrained_sr, glue.boundary_sdf = load_sr, sdf
            launches = dict(cuda_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 1e9
            n_steps = len(losses)
            paths[f"surface:{name}"] = launches
            if any(not all(math.isfinite(r[k]) for k in ("loss", "seg_loss", "sr_loss"))
                   for r in losses):
                raise AssertionError(f"surface {name}: non-finite losses {losses}")
            if launches.get("minplus_rows", 0) != per_step * n_steps:
                raise AssertionError(f"surface {name}: expected {per_step * n_steps} minplus "
                                     f"launches in {n_steps} steps, got {launches}")
            flags = ("in_sr_pretrain", "in_kernel_window", "use_gt_kernel")
            phases = [{"iteration": r["step"], **{k: compute_phase(r["step"], pc)[k]
                                                  for k in flags}} for r in losses]
            if name == "sr_pretrain":
                if any(r["seg_loss"] != 0.0 for r in losses) or not phases[-1]["in_kernel_window"]:
                    raise AssertionError(f"sr_pretrain: {losses}, {phases}")
                saved = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
                torch.save(saved, os.path.join(weights_dir, sr_checkpoint_name(cfg)))
            if name == "joint_from_pretrain" and not loads.get("equal"):
                raise AssertionError(f"joint_from_pretrain: the SR net was not the saved one "
                                     f"before step 1: {loads}")
            lr_shape = [b, 1] + [v // int(cfg.MODEL.SCALE_FACTOR) for v in cfg.INPUT.IMAGE_SIZE]
            if name == "inverse" and sdf_shapes != [lr_shape] * n_steps:
                raise AssertionError(f"inverse: SDF shapes {sdf_shapes}")
            timed = step_s[1:n_loop] or [math.nan]
            report.update({
                "batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE), "steps": n_steps,
                "step_s": step_s, "images_per_s_after_first": b * len(timed) / sum(timed),
                "peak_mem_gb": peak, "launches": launches, "minplus_launches_per_step": per_step,
                "sdf_shapes": sorted({tuple(s_) for s_ in sdf_shapes}),
                "first_loss": losses[0], "last_loss": losses[-1], "phases": phases,
                "seconds": time.perf_counter() - t0})
            if name == "joint_from_pretrain":
                report["sr_loaded_from_sr_pretrain"] = {
                    "file": sr_checkpoint_name(cfg), **loads}
            emit(report)
            del model
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_start
    emit({"phase": "surface", "variants": list(SURFACE), "seconds": seconds})
    return paths


# the baselines phase: the paper's other joint baselines, each the flagship
# recipe with these overrides (DSRL and SrcNetSR predict no kernel, so the
# KBPN SR loss, which divides the predicted kernel by its sum, is 0/0 for
# them: they train with L1, as the DBPN recipe does)
_DSRL = ["MODEL.SR", "DSRL", "MODEL.DETECTOR_TYPE", "DSRL", "SOLVER.SR_LOSS_FUNC", "L1"]
BASELINES = {
    "dsrl_resnet": _DSRL,
    "dsrl_resnet_deconv": _DSRL + ["MODEL.DSRL_UPSAMPLE", "deconv"],
    "dsrl_drn": _DSRL + ["TPU.DSRL_BACKBONE", "drn"],
    "dsrl_mobilenet": _DSRL + ["TPU.DSRL_BACKBONE", "mobilenet"],
    "dsrl_xception": _DSRL + ["TPU.DSRL_BACKBONE", "xception"],
    "kbpn_segnet": ["MODEL.DETECTOR_TYPE", "SegNet"],
    "srcnet_pspnet": ["MODEL.SR", "SrcNetSR", "SOLVER.SR_LOSS_FUNC", "L1"],
}
BASELINE_IMAGES, BASELINE_STEPS = 2, 3
BASELINE_INT8 = ("dsrl_resnet", "kbpn_segnet", "srcnet_pspnet")
# DSRL-ResNet's card-vs-CPU step runs at LR 32: at LR 16 its layers 3-4 are
# 1 x 1, where 78 train-mode BatchNorms over the batch's 2 values make the
# float64 step depend on the summation order (tests/test_torch_port_baselines.py)
BASELINE_CPU_LR = 32


def baseline_cfg(name):
    """The flagship recipe with BASELINES[name], no pretrain windows, the seed."""
    from csbsr_tpu_torch.config.flagship import flagship_cfg

    cfg = flagship_cfg(SEED)
    cfg.merge_from_list(ZOO_WINDOWS + BASELINES[name])
    return cfg


def phase_baselines(dev):
    """DSRL (ResNet-101 with either chain, DRN-D-54, MobileNetV2, Xception),
    KBPN + SegNet and SrcNetSR + PSPNet at full width from the seed's random
    weights, bf16: 2 eval images of 448x448 through score_for_ss with the HD
    bank, the model in float64 on the card against the CPU on a 16x16 LR
    patch, 3 joint-phase steps of do_train at batch 6 of 224x224 crops, the
    first the warm-up (launch counts reset just before and read just after
    each path: 2 min-plus launches per image and per step); DSRL-ResNet's
    float64 train step on the card against the CPU; the bf16-vs-int8
    agreement and one int8 image for BASELINE_INT8. One JSON line per row,
    then the phase's seconds. Returns (min-plus launch counts by path, the
    int8 conv configurations its int8 runs made)."""
    import tempfile

    from csbsr_tpu_torch.data import IterationBasedLoader, SubsetView
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build
    from csbsr_tpu_torch.train import build_datasets, split_and_eval_batches

    t_start = time.perf_counter()
    paths, configs = {}, {}
    with tempfile.TemporaryDirectory() as no_weights:
        for name in BASELINES:
            t0 = time.perf_counter()
            cfg = baseline_cfg(name)
            model = model_from_cfg(cfg, device=dev)
            data = SyntheticCrackSet(cfg, BASELINE_IMAGES, HR_SIZE, dev, seed=SEED)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.LAUNCHES.clear()
            rows, summary, _ = score_for_ss(cfg, model, data, device=dev, test_aiu=True,
                                            test_surface_distance=True, log_fn=lambda *a: None)
            torch.cuda.synchronize()
            eval_launches = dict(cuda_build.LAUNCHES)
            eval_peak = torch.cuda.max_memory_allocated() / 1e9
            paths[f"baselines_eval:{name}"] = eval_launches
            # DSRL and SrcNetSR predict no kernel: PSNR_kernel 0/0, NaN, as in the JAX package
            nan_ok = {"PSNR_kernel"} if cfg.MODEL.SR != "KBPN" else set()
            bad = {k: v for k, v in summary.items() if not math.isfinite(v) and k not in nan_ok}
            if bad or any(math.isfinite(summary[k]) for k in nan_ok) or \
                    eval_launches.get("minplus_rows", 0) != 2 * BASELINE_IMAGES:
                raise AssertionError(f"{name}: metrics {summary}, launches {eval_launches}")
            vs_cpu = check_against_cpu(model, cfg, data.get(0)[0][:1, :, :16, :16],
                                       torch.float64)

            pool = build_datasets(cfg, synthetic=True)
            train_idx, _ = split_and_eval_batches(cfg, pool, max_eval_batches=1)
            b = cfg.SOLVER.BATCH_SIZE
            batches = list(IterationBasedLoader(SubsetView(pool, train_idx), b, BASELINE_STEPS,
                                                seed=cfg.SEED, num_workers=4))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_build.LAUNCHES.clear()
            step_s, losses, _ = _do_train_steps(cfg, model, batches, len(train_idx),
                                                weights_dir=os.path.join(no_weights, "pretrain"))
            torch.cuda.synchronize()
            train_launches = dict(cuda_build.LAUNCHES)
            train_peak = torch.cuda.max_memory_allocated() / 1e9
            paths[f"baselines_train:{name}"] = train_launches
            if any(not all(math.isfinite(r[k]) for k in ("loss", "seg_loss", "sr_loss"))
                   for r in losses) or \
                    train_launches.get("minplus_rows", 0) != 2 * len(losses):
                raise AssertionError(f"{name}: losses {losses}, launches {train_launches}")
            report = {"phase": "baselines", "name": name, "overrides": BASELINES[name],
                      "model": f"{cfg.MODEL.SR} + {cfg.MODEL.DETECTOR_TYPE}"
                               + (f" ({cfg.TPU.DSRL_BACKBONE}, {cfg.MODEL.DSRL_UPSAMPLE})"
                                  if cfg.MODEL.SR == "DSRL" else ""),
                      "config": f"configs/config_csbsr_pspnet.yaml + overrides, random init, "
                                f"seed {SEED}, bf16 compute, full width",
                      "params": sum(p.numel() for p in model.parameters())}
            eval_s = [r["seconds"] for r in rows]
            timed = step_s[1:] or [math.nan]
            report["eval"] = {"images": BASELINE_IMAGES, "image_hw": [HR_SIZE, HR_SIZE],
                              "per_image_s": eval_s,
                              "images_per_s_after_first": (len(eval_s) - 1) / sum(eval_s[1:]),
                              "summary": summary, "peak_mem_gb": eval_peak,
                              "launches": eval_launches, "minplus_launches_per_image": 2}
            report["float64_vs_cpu"] = vs_cpu
            report["train"] = {"batch": b, "crop_hw": list(cfg.INPUT.IMAGE_SIZE),
                               "steps": len(losses), "step_s": step_s,
                               "images_per_s_after_first": b * len(timed) / sum(timed),
                               "losses": losses, "peak_mem_gb": train_peak,
                               "launches": train_launches, "minplus_launches_per_step": 2}
            if name == "dsrl_resnet":
                report["float64_step_vs_cpu"] = check_surface_step_against_cpu(
                    cfg, model, 1, lr_side=BASELINE_CPU_LR, dtypes=(torch.float64,))
            report["seconds"] = time.perf_counter() - t0
            emit(report)
            del model
            torch.cuda.empty_cache()
            if name in BASELINE_INT8:
                paths[f"baselines_int8:{name}"] = _zoo_int8_image(
                    dev, name, baseline_cfg(name), configs,
                    f"configs/config_csbsr_pspnet.yaml + {BASELINES[name]}", "baselines")
    emit({"phase": "baselines", "rows": list(BASELINES),
          "seconds": time.perf_counter() - t_start})
    return paths, configs


def _do_train_steps(cfg, model, batches, num_train_ds, **kw):
    """do_train over `batches` with logging at every step, in a temporary
    OUTPUT_DIR: (seconds of each step, each step's losses, the train state),
    the steps timed between do_train's log calls, which follow each step's
    loss read-back."""
    import tempfile

    from csbsr_tpu_torch.engine.trainer import do_train

    log_t = []
    with tempfile.TemporaryDirectory() as out_dir:
        cfg.OUTPUT_DIR = out_dir
        t0 = time.perf_counter()
        state = do_train(cfg, model, batches, None, log_step=1, save_step=0,
                         eval_step_every=0, num_train_ds=num_train_ds,
                         log_fn=lambda line: line.startswith("===> Iter") and log_t.append(
                             time.perf_counter()), **kw)
        torch.cuda.synchronize()
        with open(os.path.join(out_dir, "metrics.jsonl")) as f:
            losses = [{k: r[k] for k in ("step", "loss", "seg_loss", "sr_loss")}
                      for r in map(json.loads, f)]
    return [log_t[0] - t0] + [t1 - t0 for t0, t1 in zip(log_t, log_t[1:])], losses, state


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
        seg_model = getattr(m, "segmentation_model", None)  # DSRL has its parallel model
        for head in HEAD_LOGITS:
            if hasattr(seg_model, head):
                hooks.append(getattr(seg_model, head).register_forward_hook(
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


def _tti_run(cfg, model, data, out_dir, dev):
    """inference_tti over `data` after one warm-up image (host-inclusive
    images/s, PNG writes included), then the device part alone (tti_outputs
    of image 0, twice: upload, the model in chunks, joins, the uint8 SR and
    float32 seg copies to the host) and the peak memory; returns (report,
    (sr uint8 and seg of image 0, the files written))."""
    from csbsr_tpu_torch.engine.inference import inference_tti, tti_outputs
    from csbsr_tpu_torch.ops import quant

    class First:  # the warm-up: image 0 alone
        def __len__(self):
            return 1

        def get(self, i):
            return data.get(0)

    inference_tti(cfg, model, First(), output_dir=out_dir + "_warmup", device=dev,
                  max_patches_per_call=TTI_CHUNK, log_fn=lambda *a: None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    quant.PRODUCTS.clear()
    t0 = time.perf_counter()
    inference_tti(cfg, model, data, output_dir=out_dir, device=dev,
                  max_patches_per_call=TTI_CHUNK, log_fn=lambda *a: None)
    total = time.perf_counter() - t0
    products = sum(quant.PRODUCTS.values())
    patches, _, ushape, seg_ushape = data.get(0)
    dev_s = []
    for _ in range(2):
        t1 = time.perf_counter()
        sr_u8, seg, _ = tti_outputs(cfg, model, patches, ushape, seg_ushape, device=dev,
                                    max_patches_per_call=TTI_CHUNK)
        dev_s.append(time.perf_counter() - t1)
    files = sorted(os.path.relpath(os.path.join(r, f), out_dir)
                   for r, _, fs in os.walk(out_dir) for f in fs)
    return {"images": len(data), "seconds": total, "images_per_s": len(data) / total,
            "device_part_s": dev_s, "device_part_images_per_s": 1.0 / min(dev_s),
            "int8_products": products, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "sr_shape": list(sr_u8.shape), "png_files": len(files)}, (sr_u8, seg, files)


def phase_serve(dev, configs):
    """The serving half: TTI (bf16, int8), latency table, card vs CPU in int8,
    one int8 image per zoo recipe, the int8 exactness check over `configs`
    (those the baselines phase collected) and its own. Returns the min-plus
    launch counts of its paths that run the HD bank."""
    import tempfile

    from csbsr_tpu_torch import serve_latency
    from csbsr_tpu_torch.config.flagship import flagship_cfg
    from csbsr_tpu_torch.data import TTICrackDataSetTest
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import calibrate_int8
    from csbsr_tpu_torch.int8_accuracy import compare
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.models.blocks import int8_modules
    from csbsr_tpu_torch.ops.patch import split_patch
    from PIL import Image

    t_start = time.perf_counter()
    cfg = flagship_cfg(SEED)
    model = model_from_cfg(cfg, device=dev)
    report = {}  # configs: the int8 conv configurations the recipes ran
    with tempfile.TemporaryDirectory() as tmp:
        photos = os.path.join(tmp, "photos")
        os.makedirs(photos)
        syn = SyntheticCrackSet(cfg, TTI_IMAGES, TTI_SIZE, dev, seed=SEED)
        for i in range(TTI_IMAGES):
            img = (syn.get(i)[1].permute(1, 2, 0).clamp(0, 1) * 255).round().byte().cpu().numpy()
            Image.fromarray(img).save(os.path.join(photos, f"photo{i}.png"))
        tcfg = cfg.clone()
        tcfg.INPUT.IMAGE_SIZE = [TTI_PATCH, TTI_PATCH]
        data = TTICrackDataSetTest(tcfg, photos)
        n_patches = int(data.get(0)[0].shape[0])
        report["tti_bf16"], (sr_b, seg_b, files_b) = _tti_run(tcfg, model, data,
                                                              os.path.join(tmp, "bf16"), dev)
        calibrate_int8(model, data.get(0)[0][:TTI_CHUNK])
        n_int8 = len(int8_modules(model))
        chunk = torch.from_numpy(data.get(0)[0][:TTI_CHUNK]).to(dev)
        _collect_configs(configs, "flagship", model, chunk)
        _collect_configs(configs, "flagship", model, chunk[:1])
        report["tti_int8"], (sr_q, seg_q, files_q) = _tti_run(tcfg, model, data,
                                                              os.path.join(tmp, "int8"), dev)
    if report["tti_bf16"]["int8_products"] or not report["tti_int8"]["int8_products"]:
        raise AssertionError(f"int8 products: bf16 run {report['tti_bf16']['int8_products']}, "
                             f"int8 run {report['tti_int8']['int8_products']}")
    want = TTI_IMAGES * (1 + 2 + 11 + 1)  # SR image, two kernel dumps, 11 masks, raw map
    if not (len(files_b) == len(files_q) == want and files_b == files_q):
        raise AssertionError(f"TTI wrote {len(files_b)} / {len(files_q)} files, want {want}")
    if tuple(sr_b.shape) != (1, 3, 4 * TTI_SIZE, 4 * TTI_SIZE) or not np.isfinite(seg_q).all():
        raise AssertionError(f"TTI outputs: {sr_b.shape}, finite seg {np.isfinite(seg_q).all()}")
    tti_agree = compare({"sr": torch.from_numpy(sr_b) / 255.0, "seg": torch.from_numpy(seg_b)},
                        {"sr": torch.from_numpy(sr_q) / 255.0, "seg": torch.from_numpy(seg_q)})
    emit({"phase": "serve", "part": "tti", "config": "configs/config_csbsr_pspnet.yaml "
          f"(random init, seed {SEED}, bf16 compute)", "image_hw": [TTI_SIZE, TTI_SIZE],
          "patch": TTI_PATCH, "patches_per_image": n_patches,
          "chunk": TTI_CHUNK, "int8_convs": n_int8, **report, "bf16_vs_int8": tti_agree})

    # the serve_latency table, bf16 then int8 (calibrated on 8 patches of 56^2)
    model = model_from_cfg(cfg, device=dev)
    lat = {"bf16": serve_latency.run_mode(model, cfg, dev, LATENCY_ITERS)}
    calib = np.random.RandomState(SEED).rand(8, 3, serve_latency.PATCH, serve_latency.PATCH)
    calibrate_int8(model, calib.astype(np.float32))
    lat["int8"] = serve_latency.run_mode(model, cfg, dev, LATENCY_ITERS)
    side = max(serve_latency.HR_SIZES) // int(cfg.MODEL.SCALE_FACTOR)  # its largest call
    lr = torch.rand((3, side, side), device=dev)
    _collect_configs(configs, "flagship", model, split_patch(lr, serve_latency.PATCH,
                                                             serve_latency.PATCH)[0])
    convs = serve_latency.conv_table(model, dev, LATENCY_ITERS)
    emit({"phase": "serve", "part": "latency", "iters": LATENCY_ITERS, **lat})
    emit({"phase": "serve", "part": "convs", "batch": serve_latency.CONV_BATCH, "rows": convs})
    del model
    torch.cuda.empty_cache()

    report_cpu = check_int8_against_cpu(cfg, dev)
    emit({"phase": "serve", "part": "int8_vs_cpu", **report_cpu})

    paths = {}
    for name, recipe in (("flagship", "config_csbsr_pspnet"),) + SERVED_ZOO:
        paths[f"serve_int8:{name}"] = _zoo_int8_image(dev, name, zoo_cfg(recipe), configs,
                                                      f"configs/{recipe}.yaml")
    exact = check_int8_exactness(dev, configs)
    emit({"phase": "serve", "part": "int8_exactness", "configs": exact,
          "seconds": time.perf_counter() - t_start})
    return paths


def _collect_configs(configs, recipe, model, x):
    """Add the int8 conv configurations that one call of `model` on `x` runs,
    keeping for each the module (its weight, its int8 input channels) and
    input shape of its largest and of its smallest call (N*H*W of the input:
    the rows of the product, up to the stride)."""
    from csbsr_tpu_torch.serve_latency import conv_shapes

    for key, (name, m, shape, _) in conv_shapes(model, x).items():
        e = configs.setdefault(key[:6], {"recipes": set()})  # kind, k, stride, pad, dil, groups
        e["recipes"].add(recipe)
        qc = m.quant_channels
        case = {"rows": shape[0] * shape[2] * shape[3], "module": f"{recipe}:{name}",
                "weight": m.weight.detach() if qc is None else m.weight.detach()[:, :qc],
                "shape": (shape[0], shape[1] if qc is None else qc, shape[2], shape[3])}
        if "largest" not in e or case["rows"] > e["largest"]["rows"]:
            e["largest"] = case
        if "smallest" not in e or case["rows"] < e["smallest"]["rows"]:
            e["smallest"] = case


def check_int8_exactness(dev, configs):
    """The _int_mm route against the float64 plain version, torch.equal on the
    int32 accumulators, for each configuration at the input shapes of its
    largest and smallest call on the serving paths (the product's rows M,
    and the padding of K, N and M, as served), with that module's own int8
    weight and a random int8 input."""
    from csbsr_tpu_torch.ops.quant import conv_acc, conv_transpose_acc, quantize_weight

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for (kind, k, s, p, d, g), e in sorted(configs.items(), key=lambda kv: str(kv[0])):
        for which in ("largest", "smallest"):
            case = e[which]
            if which == "smallest" and case["shape"] == e["largest"]["shape"]:
                continue
            xq = torch.randint(-127, 128, case["shape"], generator=gen, device=dev,
                               dtype=torch.int8)
            if kind == "deconv":
                wq, _ = quantize_weight(case["weight"], out_axis=1)
                got = conv_transpose_acc(xq, wq, s, p)
                ref = conv_transpose_acc(xq, wq, s, p, route="plain")
            else:
                wq, _ = quantize_weight(case["weight"], out_axis=0)
                got = conv_acc(xq, wq, s, p, d, g)
                ref = conv_acc(xq, wq, s, p, d, g, route="plain")
            torch.cuda.synchronize()
            equal = got.dtype == torch.int32 and torch.equal(got, ref)
            rows.append({"kind": kind, "k": k, "stride": s, "padding": p, "dilation": d,
                         "groups": g, "call": which, "input": list(case["shape"]),
                         "out_channels": int(wq.shape[1] if kind == "deconv" else wq.shape[0]),
                         "module": case["module"], "recipes": sorted(e["recipes"]),
                         "equal": equal})
            del xq, got, ref
            if not equal:
                raise AssertionError(f"int8 _int_mm route != plain version at {rows[-1]}")
    return rows


def check_int8_against_cpu(cfg, dev):
    """The flagship with int8 convs on the card and on the host CPU, same
    weights, one 56x56 patch.

    In float64, where every quantization decision on the card is the CPU's
    (their activations differ by summation order alone, ~1e-16), the card's
    int8 outputs must equal the CPU's to 1e-12 in relative L2, with static
    scales (the card's calibration loaded into the CPU model) and with
    dynamic ones; a float or miswired int8 path on the card is as far off as
    the quantization error (~1e-3). In float32 (TF32 off), reported and held
    loosely: calibrated abs-maxima within 1e-4 relative; at the card's
    scales, per output, the card's int8 error against the CPU's float output
    within 1.5x of the CPU's int8 error, and the card's int8 output within 2x
    of that error of the CPU's (float32 rounding flips single int8 levels,
    and a flip cascades)."""
    from csbsr_tpu_torch.engine.inference import calibrate_int8
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.models.blocks import int8_modules, load_act_amax
    from csbsr_tpu_torch.utils.device import full_fp32

    t0 = time.perf_counter()
    patch = torch.rand((1, 3, 56, 56), generator=torch.Generator().manual_seed(SEED))
    keys = ("sr", "kernel", "seg", "aux")

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).norm() / b.norm())

    def int8_runs(dtype, modes):
        """{mode: {card, cpu: int8 outputs}} for modes "static" (at the
        card's calibrated scales) and "dynamic", the CPU's float outputs, and
        the calibrated abs-maxima"""
        models = {w: model_from_cfg(cfg, device=d, dtype=dtype, seed=SEED).to(dtype)
                  for w, d in (("card", dev), ("cpu", "cpu"))}
        out = {}
        x = patch.to(dtype)
        with full_fp32(), torch.inference_mode():
            float_cpu = models["cpu"](x, clip_sr=True)
            for where, m in models.items():
                calibrate_int8(m, x)
            amax = {w: {n: float(q.act_amax) for n, q in int8_modules(m)}
                    for w, m in models.items()}
            load_act_amax(models["cpu"], amax["card"])
            for mode in modes:
                out[mode] = {}
                for where, m in models.items():
                    for _, q in int8_modules(m) if mode == "dynamic" else ():
                        q.act_amax = None
                    out[mode][where] = m(x.to(next(m.parameters()).device), clip_sr=True)
        return out, float_cpu, amax

    out, float_cpu, _ = int8_runs(torch.float64, ("static", "dynamic"))
    float64 = {mode: {k: {"card_vs_cpu_int8": rel(o["card"][k], o["cpu"][k]),
                          "cpu_int8_vs_float": rel(o["cpu"][k], float_cpu[k])} for k in keys}
               for mode, o in out.items()}
    bad = [f"float64 {mode} {k}" for mode, e in float64.items() for k, v in e.items()
           if not (v["card_vs_cpu_int8"] <= 1e-12 and v["cpu_int8_vs_float"] > 1e-6)]

    out, float_cpu, amax = int8_runs(torch.float32, ("static",))
    out = out["static"]
    amax_err = max(abs(amax["card"][n] - amax["cpu"][n]) / max(abs(amax["cpu"][n]), 1e-12)
                   for n in amax["cpu"])
    errs = {}
    for key in keys:
        quant_err = rel(out["cpu"][key], float_cpu[key])
        card_quant_err = rel(out["card"][key], float_cpu[key])
        card_vs_cpu = rel(out["card"][key], out["cpu"][key])
        errs[key] = {"cpu_int8_vs_float": quant_err, "card_int8_vs_cpu_float": card_quant_err,
                     "card_vs_cpu_int8": card_vs_cpu}
        if not (card_quant_err <= 1.5 * quant_err and card_vs_cpu <= 2.0 * quant_err):
            bad.append(f"float32 {key}")
    if amax_err > 1e-4 or bad:
        raise AssertionError(f"int8 card vs CPU: amax rel err {amax_err}, outputs {bad}: "
                             f"float64 {float64}, float32 {errs}")
    return {"float64": float64, "float64_tolerance": 1e-12, "amax_max_rel_err": amax_err,
            "amax_tolerance": 1e-4, "int8_convs": len(amax["cpu"]), "float32": errs,
            "seconds": time.perf_counter() - t0}


def _zoo_int8_image(dev, name, cfg, configs, source, phase="serve"):
    """A recipe's bf16-vs-int8 agreement on the patches of one 448x448
    image (int8_accuracy.agreement: SR PSNR, seg IoU at 0.5, largest seg
    deviation, kernel PSNR; it calibrates the int8 convs on those patches),
    then the image through score_for_ss with the HD bank in int8; returns
    the int8 run's launch counts."""
    from csbsr_tpu_torch.data.synthetic import SyntheticCrackSet
    from csbsr_tpu_torch.engine.inference import score_for_ss
    from csbsr_tpu_torch.int8_accuracy import agreement
    from csbsr_tpu_torch.models import model_from_cfg
    from csbsr_tpu_torch.ops import cuda_build, quant

    t0 = time.perf_counter()
    model = model_from_cfg(cfg, device=dev)
    data = SyntheticCrackSet(cfg, 1, HR_SIZE, dev, seed=SEED)
    patches = data.get(0)[0]
    agree = agreement(model, patches)
    _collect_configs(configs, name, model, patches)
    _collect_configs(configs, name, model, patches[:1])
    torch.cuda.synchronize()
    cuda_build.LAUNCHES.clear()
    quant.PRODUCTS.clear()
    t1 = time.perf_counter()
    rows, summary, _ = score_for_ss(cfg, model, data, device=dev, test_surface_distance=True,
                                    log_fn=lambda *a: None)
    torch.cuda.synchronize()
    int8_s = time.perf_counter() - t1
    launches, products = dict(cuda_build.LAUNCHES), dict(quant.PRODUCTS)
    nan_ok = {"PSNR_kernel"} if cfg.MODEL.SR != "KBPN" else set()
    bad = {k: v for k, v in summary.items() if not math.isfinite(v) and k not in nan_ok}
    if bad or launches.get("minplus_rows", 0) != 2 or not products:
        raise AssertionError(f"{name} int8: metrics {summary}, launches {launches}, "
                             f"int8 products {products}")
    emit({"phase": phase, "part": "zoo_int8", "recipe": source, "name": name,
          "bf16_vs_int8": agree, "int8_products": sum(products.values()),
          "int8_summary": summary, "int8_image_s": int8_s, "launches": launches,
          "seconds": time.perf_counter() - t0})
    del model
    torch.cuda.empty_cache()
    return launches


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
    paths.update(phase_surface(dev))
    baseline_paths, configs = phase_baselines(dev)
    paths.update(baseline_paths)
    paths.update(phase_serve(dev, configs))
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
