"""Min-plus row pass of the exact EDT: CUDA kernel and plain version.

    d2[..., r, j] = min_k ( min(g[..., r, k]^2, 1e9) + (j - k)^2 )

On a CUDA tensor `minplus_rows` launches `csrc/minplus.cu` (the port of the
Pallas kernel `csbsr_tpu/ops/pallas/minplus.py:minplus_rows_pallas`) with
the launch plan of `launch_plan`; on a CPU tensor it runs
`minplus_rows_reference`, the blocked form of the JAX package's
`_min_plus_rows`. Empty slices (no True pixel) are capped at 1e9, the XLA
path's value; the Pallas kernel caps at 1e18, and every caller masks such
slices. Away from that cap all terms are integers below 2**24 for
H, W <= 2896, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from . import cuda_build

__all__ = ["minplus_rows", "minplus_rows_reference", "launch", "launch_plan", "work_map",
           "BIG", "MAX_W"]

BIG = 1e9
MAX_W = 2896  # the widest row the kernel takes: exact, and its band fits in shared memory
_BLOCK = 32
_NAME = "minplus"
# (g, out, rows, w, col_groups, split, kslice, items_per_block, rb, threads, blocks, smem,
#  stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_int] * 9 \
    + [ctypes.c_void_p]

ROWS_PER_THREAD = 8
COLS_PER_THREAD = 4
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
_THREADS = (256, 512)
_ITEMS_PER_BLOCK = (32, 64, 128, 256)  # a multiple of the warp: k slices stay warp-uniform
_MIN_KSLICE = 8  # k per slice, at least one unrolled trip of the kernel's loop
LATENCY_WARPS = 4  # warps a scheduler needs to hide the loop's latencies (fits the H100 sweep)


class LaunchPlan(NamedTuple):
    """How `csrc/minplus.cu` covers a (rows, w) row pass. A work item is
    ROWS_PER_THREAD rows x COLS_PER_THREAD columns; items are numbered row group by
    row group (item = row_group * col_groups + col_group) and dealt to the
    blocks in runs of `items_per_block`. The block's `threads` are `split`
    groups of `items_per_block`; group s sweeps k in [s * kslice, (s + 1) *
    kslice) clipped to w, and a min over the groups in shared memory
    finishes each output. `rb` is the shared row stride of the staged band
    (4 mod 8, at least the rows of `span` row groups)."""
    rows: int
    w: int
    col_groups: int
    items: int
    split: int
    kslice: int
    items_per_block: int
    threads: int
    blocks: int
    span: int
    rb: int
    smem_bytes: int


def _plan(rows: int, w: int, threads: int, per_block: int) -> LaunchPlan:
    split = threads // per_block
    col_groups = -(-w // COLS_PER_THREAD)
    row_groups = -(-rows // ROWS_PER_THREAD)
    items = row_groups * col_groups
    # row groups one run of per_block consecutive items can touch
    span = min(row_groups, (per_block + col_groups - 2) // col_groups + 1)
    rb = ROWS_PER_THREAD * span + 4
    # the staged band, then the partial minima of a split k
    smem = max(w * rb * 4, ROWS_PER_THREAD * COLS_PER_THREAD * threads * 4 if split > 1 else 0)
    return LaunchPlan(rows, w, col_groups, items, split, -(-w // split), per_block,
                      threads, -(-items // per_block), span, rb, smem)


def _cost(plan: LaunchPlan, sms: int) -> float:
    """Estimated clocks of the busiest SM. The blocks are equal, so it holds
    ceil(blocks / sms) of them (all resident at once on the main paths'
    shapes); a thread executes about 1.66 instructions per candidate
    (csrc/minplus.cu's main loop: two FADDs, one VIMNMX3 and a share of the
    two LDS.128 per k), its share of the staging, and the partial-min
    exchange when k is split. With fewer than LATENCY_WARPS warps on each of
    the SM's four schedulers, a scheduler idles while its warps wait."""
    per_k = 1.66 * ROWS_PER_THREAD * COLS_PER_THREAD
    staging = 8.0 * plan.span * ROWS_PER_THREAD * plan.w / plan.threads
    exchange = 3 * ROWS_PER_THREAD * COLS_PER_THREAD if plan.split > 1 else 0
    per_thread = plan.kslice * per_k + staging + exchange
    blocks_per_sm = math.ceil(plan.blocks / sms)
    warps_per_scheduler = blocks_per_sm * plan.threads / 128
    return blocks_per_sm * plan.threads * per_thread / 128 \
        / min(1.0, warps_per_scheduler / LATENCY_WARPS)


@functools.lru_cache(maxsize=256)
def launch_plan(rows: int, w: int, sms: int = 132) -> LaunchPlan:
    """The plan of least estimated time (`_cost`) among the block shapes the
    kernel takes: a large map (the HD bank) gets whole rows per thread group
    and no split; a few rows (the GT border, the training SDF) get k split
    over the warp groups of a block, so the grid fills the card's `sms`."""
    if rows <= 0 or w <= 0:
        raise ValueError(f"launch_plan: empty map ({rows}, {w})")
    options = [_plan(rows, w, t, p) for t in _THREADS for p in _ITEMS_PER_BLOCK
               if p <= t and (p == t or -(-w // (t // p)) >= _MIN_KSLICE)]
    options = [p for p in options if p.smem_bytes <= SMEM_LIMIT]
    if not options:
        raise ValueError(f"launch_plan: no block shape fits rows of {w}")
    return min(options, key=lambda p: (_cost(p, sms), p.split, p.threads))


def work_map(plan: LaunchPlan):
    """The kernel's index arithmetic on the host, for every thread of the
    grid: (row_group, col_group, k_lo, k_hi, live, local_row) arrays of shape
    (blocks, threads). `local_row` is the thread's first row in the block's
    staged band; idle lanes (live False) repeat the block's last item and
    store nothing."""
    tid = np.arange(plan.threads)
    item0 = np.arange(plan.blocks, dtype=np.int64)[:, None] * plan.items_per_block
    item_last = np.minimum(item0 + plan.items_per_block, plan.items) - 1
    slice_ = tid[None, :] // plan.items_per_block
    p = tid[None, :] - slice_ * plan.items_per_block
    live = item0 + p <= item_last
    item = np.minimum(item0 + p, item_last)
    rg = item // plan.col_groups
    local_row = rg * ROWS_PER_THREAD - (item0 // plan.col_groups) * ROWS_PER_THREAD
    k_lo = np.minimum(slice_ * plan.kslice, plan.w)
    k_hi = np.minimum(k_lo + plan.kslice, plan.w)
    return rg, item - rg * plan.col_groups, np.broadcast_to(k_lo, live.shape), \
        np.broadcast_to(k_hi, live.shape), live, local_row


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def minplus_rows_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, blocked over j so the (..., H, W, block)
    temporary stays bounded."""
    w = g.shape[-1]
    g2 = torch.minimum(g * g, torch.tensor(BIG, dtype=g.dtype, device=g.device))
    k = torch.arange(w, dtype=torch.float32, device=g.device)
    out = torch.empty_like(g2)
    for j0 in range(0, w, _BLOCK):
        j = torch.arange(j0, min(j0 + _BLOCK, w), dtype=torch.float32, device=g.device)
        sq = (j[None, :] - k[:, None]) ** 2  # (W, block)
        out[..., j0 : j0 + j.numel()] = torch.amin(g2[..., :, None] + sq, dim=-2)
    return out


def launch(g: torch.Tensor, plan: LaunchPlan) -> torch.Tensor:
    """One launch of the kernel on a checked CUDA tensor with the given
    plan. Not counted in LAUNCHES: `minplus_rows` is the path's entry."""
    fn = cuda_build.load(_NAME, "csbsr_minplus_rows", _ARGTYPES)
    out = torch.empty_like(g)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = fn(g.data_ptr(), out.data_ptr(), plan.rows, plan.w, plan.col_groups, plan.split,
                 plan.kslice, plan.items_per_block, plan.rb, plan.threads, plan.blocks,
                 plan.smem_bytes, stream)
    cuda_build.check_launch("minplus_rows", err)
    return out


def minplus_rows(g: torch.Tensor) -> torch.Tensor:
    """The row pass: the CUDA kernel on a CUDA tensor, the plain version on
    a CPU tensor. g: (..., W) float32, contiguous, at least 2-D, W <= MAX_W."""
    if g.device.type == "cpu":
        return minplus_rows_reference(g)
    if g.device.type != "cuda":
        raise ValueError(f"minplus_rows: unsupported device {g.device}")
    if g.dtype != torch.float32:
        raise TypeError(f"minplus_rows: float32 expected, got {g.dtype}")
    if g.dim() < 2:
        raise ValueError(f"minplus_rows: (..., H, W) expected, got shape {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("minplus_rows: contiguous input expected")
    w = g.shape[-1]
    if w > MAX_W:
        raise ValueError(f"minplus_rows: rows of at most {MAX_W} expected, got {w}")
    if g.numel() == 0:
        return torch.empty_like(g)
    out = launch(g, launch_plan(g.numel() // w, w, _sm_count(g.device.index)))
    cuda_build.LAUNCHES["minplus_rows"] += 1
    return out
