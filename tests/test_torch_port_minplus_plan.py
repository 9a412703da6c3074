"""Port: the min-plus kernel's launch plan and its bound, on the CPU.

`ops/minplus.launch_plan` decides how `csrc/minplus.cu` covers a row pass,
and `work_map` is the kernel's index arithmetic on the host. The card runs
the kernel itself (tests/test_torch_port_gpu.py, chip_smoke.py); here the
plan is held to cover every output (row, column) exactly once, with the
k ranges of each output whole and disjoint, inside the staged band and the
card's shared memory, for the row counts and widths of the main paths and
their edges. Exact checks: integer arithmetic.
"""
import collections

import numpy as np
import pytest

from csbsr_tpu_torch.ops import rates
from csbsr_tpu_torch.ops.minplus import (COLS_PER_THREAD, ROWS_PER_THREAD, SMEM_LIMIT,
                                         launch_plan, work_map)

ROWS = (1, 7, 8, 449, 1344, 44451)
WIDTHS = (1, 2, 31, 224, 449, 2100, 2896)
SMS = 132


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_launch_plan_covers_every_output_once_with_whole_k(rows, w):
    plan = launch_plan(rows, w, SMS)
    assert plan.threads in (256, 512) and plan.split * plan.items_per_block == plan.threads
    assert plan.items_per_block % 32 == 0 and plan.rb % 8 == 4
    assert plan.smem_bytes <= SMEM_LIMIT
    n_rg, n_cg = -(-rows // ROWS_PER_THREAD), -(-w // COLS_PER_THREAD)
    assert (plan.items, plan.col_groups) == (n_rg * n_cg, n_cg)

    rg, cg, k_lo, k_hi, live, local_row = work_map(plan)
    slice_ = np.broadcast_to(np.arange(plan.threads) // plan.items_per_block, live.shape)
    # every (row group, column group) item, with each of its k slices, once
    key = ((rg * n_cg + cg) * plan.split + slice_)[live]
    counts = np.bincount(key, minlength=n_rg * n_cg * plan.split)
    assert counts.size == n_rg * n_cg * plan.split and (counts == 1).all()
    # row groups tile [0, rows) and column groups [0, w), the last ones clipped
    assert (n_rg - 1) * ROWS_PER_THREAD < rows <= n_rg * ROWS_PER_THREAD
    assert (n_cg - 1) * COLS_PER_THREAD < w <= n_cg * COLS_PER_THREAD
    # the k slices of an item are whole and disjoint: [0, w) in order
    edges = [(int(k_lo[0, s * plan.items_per_block]), int(k_hi[0, s * plan.items_per_block]))
             for s in range(plan.split)]
    assert edges[0][0] == 0 and edges[-1][1] == w
    assert all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
    assert all(lo <= hi for lo, hi in edges)
    # each thread's rows lie in its block's staged band
    assert local_row.min() >= 0
    assert (local_row + ROWS_PER_THREAD).max() <= plan.span * ROWS_PER_THREAD <= plan.rb
    assert w * plan.rb * 4 <= plan.smem_bytes


@pytest.mark.parametrize("rows,w,split", [(44451, 449, False), (449, 449, True),
                                          (1344, 224, True)])
def test_launch_plan_keeps_the_card_busy_at_the_main_path_shapes(rows, w, split):
    """The HD bank has rows enough for whole-k blocks; the GT border and the
    training SDF split k so that the grid holds 8 or more warps per SM."""
    plan = launch_plan(rows, w, SMS)
    assert (plan.split > 1) == split
    assert plan.blocks * plan.threads >= SMS * 256


def test_minplus_bound_takes_the_best_mix_of_routes_at_the_measured_rates():
    """route_cost: the larger of the dispatch time (128 thread-instructions per
    SM per clock) and each instruction's time at its rate. candidate_rate:
    the best mix under the dispatch rate and each pipe's rate, here (rates
    of the H100's order) DPX and VIMNMX3 candidates that fill both the
    dispatch slots and the min pipe: x_dpx + 1.5 x_vimin3 = 128 and
    x_dpx / 64 + 0.5 x_vimin3 / 64 = 1, so x_vimin3 = 64, x_dpx = 32."""
    measured = {"fmnmx": 64.0, "fadd": 128.0, "viaddmin": 64.0, "vimin3": 64.0}
    assert rates.route_cost("float", measured) == pytest.approx(1 / 64)
    assert rates.route_cost("dpx", measured) == pytest.approx(1 / 64)
    assert rates.route_cost("vimin3", measured) == pytest.approx(1.5 / 128)
    per_clock, mix = rates.candidate_rate(measured)
    assert per_clock == pytest.approx(96.0)
    assert mix == pytest.approx({"float": 0.0, "dpx": 32.0, "vimin3": 64.0})
    bound = rates.minplus_bound((99, 449, 449), measured, SMS, 1.98e9)
    candidates = 99 * 449 ** 3
    assert bound["bound_by"] == "operations"
    assert bound["bound_ms"] == pytest.approx(candidates / (96.0 * SMS * 1.98e9) * 1e3)
    assert bound["vimin3_alone_ms"] == pytest.approx(candidates * 1.5 / 128 / (SMS * 1.98e9) * 1e3)
    assert bound["bytes_bound_ms"] == pytest.approx(2 * 99 * 449 * 449 * 4 / rates.MEM_BW * 1e3)


@pytest.mark.parametrize("measured,per_clock", [
    # a slow min pipe: VIMNMX3 alone, bound by that pipe (0.5 / 16 per candidate)
    ({"fmnmx": 16.0, "fadd": 128.0, "viaddmin": 16.0, "vimin3": 16.0}, 32.0),
    # a slow FADD pipe: DPX fills the min pipe, VIMNMX3 takes what is left
    ({"fmnmx": 64.0, "fadd": 8.0, "viaddmin": 64.0, "vimin3": 64.0}, 64.0 + 8.0 * 0.5),
    # no pipe limits: dispatch alone, all DPX (one instruction per candidate)
    ({"fmnmx": 1e6, "fadd": 1e6, "viaddmin": 1e6, "vimin3": 1e6}, 128.0),
])
def test_candidate_rate_is_the_best_mix_under_every_constraint(measured, per_clock):
    got, mix = rates.candidate_rate(measured)
    assert got == pytest.approx(per_clock, rel=1e-6)
    assert sum(mix.values()) == pytest.approx(got) and min(mix.values()) >= -1e-9
    use = {r: sum(rates.ROUTES[r].values()) for r in rates.ROUTES}
    assert sum(mix[r] * use[r] for r in mix) <= rates.DISPATCH_RATE * (1 + 1e-9)
    for ops in rates.PIPES.values():
        load = sum(mix[r] * n / measured[op] for r in mix for op, n in rates.ROUTES[r].items()
                   if op in ops)
        assert load <= 1 + 1e-9


def test_sass_opcodes_counts_the_opcodes_of_each_function(monkeypatch, tmp_path):
    text = """
        Function : _Z6kernelv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/              @!P0 FMNMX R2, R3, R4, PT ;
        /*0020*/                   VIMNMX3 R5, R6, R7, R8, PT ;
        /*0030*/                   FMNMX R2, R3, R4, !PT ;
        Function : _Z5otherv
        /*0000*/                   EXIT ;
"""

    class Done:
        stdout = text

    monkeypatch.setattr(rates.subprocess, "run", lambda *a, **kw: Done())
    got = rates.sass_opcodes("minplus")
    assert got == {"_Z6kernelv": collections.Counter({"FMNMX": 2, "LDC": 1, "VIMNMX3": 1}),
                   "_Z5otherv": collections.Counter({"EXIT": 1})}
