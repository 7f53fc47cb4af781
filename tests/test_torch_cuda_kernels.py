"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Needs a CUDA card (marked `cuda`, skipped with a reason
elsewhere) and imports nothing of JAX, so on a machine without JAX it runs
as `python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py`
(tests/conftest.py configures JAX). chip_smoke.py runs the same comparison
at larger shapes.

K1-K4 compute the same products, sums and copies in the same order as their
plain versions, so they must agree to the bit; K4 sums each bag in slot
order, so two calls also give the same bits. Each is held so with its
intermediate (G_u, R_u) in fp32 and in bf16 (the step's g_dtype).

The numpy builders of the run and pooling edge cases (_run_case,
_pool_case) live here, free of JAX, and tests/test_torch_stream_kernels.py
holds the plain versions against JAX on the same cases."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.ops import stream_plan as tsp
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan

TABLES = (3000, 500, 7000)
HOT = (3, 1, 5)
D = 128
B = 512
EDGE_BR = 1024  # the edge cases' block rows (JAX's rwsadagrad needs 1024)


def _pool_case(case, seed=12):
    """Plans and weights for the pooling edge cases: weight-0 slots in an
    unbudgeted layout; a budgeted table (weight-0 hits dropped from U); a
    bag whose hits are all dropped (a zero row); a bag that hits one row
    twice. Returns the plan, the numpy work and R_u (0 at sentinels, as K3
    writes them)."""
    rng = np.random.default_rng(seed)
    tables, b, h = (300, 50, 700), 64, 3
    idx = np.stack([rng.integers(0, n, (b, h)) for n in tables]).astype(
        np.int32)
    wt = rng.uniform(0.5, 1.5, size=idx.shape).astype(np.float32)
    budget = None
    if case == "weight0":
        wt[rng.random(wt.shape) < 0.3] = 0.0
    elif case in ("budgeted", "dropped_bag"):
        wt[1][rng.random(wt[1].shape) < 0.5] = 0.0
        if case == "dropped_bag":
            wt[1, 5] = 0.0  # bag 5 of table 1: every hit dropped
        budget = [None, int((wt[1] != 0).sum()) + 8, None]
    elif case == "repeat_row":
        idx[:, :, 1] = idx[:, :, 0]
    plan = tsp.make_stream_plan(tables, D, b, h, block_rows=256,
                                u_budget=budget)
    work = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    r_u = rng.normal(size=(plan.u_total, D)).astype(np.float32)
    r_u[work.rows_u.reshape(-1) == tsp.SENTINEL_ROW] = 0
    return plan, work, r_u


def _run_case(case, seed=13):
    """Plans for K2's run edge cases: one row with more than 256 hits (its
    run spans several items); tiny one-block tables whose last and first
    local rows coincide across a segment boundary; the long run on the
    touched-only list. Returns the rng, the plan, the numpy work, dly and
    an fp32 table."""
    rng = np.random.default_rng(seed)
    if case == "segment_boundary":
        tables, b, h = (5, 5, 5), 4, 2
        # table 0 ends with row 2, table 1 starts with row 2, and so on
        idx = np.array([[[0, 2], [2, 1], [0, 0], [1, 2]],
                        [[2, 4], [4, 3], [2, 2], [3, 4]],
                        [[4, 4], [4, 4], [4, 4], [4, 4]]], np.int32)
    else:
        tables, b, h = (700, 300, 40), 200, 3
        idx = np.stack([rng.integers(0, n, (b, h)) for n in tables]).astype(
            np.int32)
        idx[0, :, :2] = 7  # 400 hits of row 7 of table 0
    plan = tsp.make_stream_plan(tables, D, b, h, block_rows=EDGE_BR)
    wt = rng.uniform(0.5, 1.5, size=idx.shape).astype(np.float32)
    work = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    if case == "touched":
        work = tsp.touched_update_items(plan, work)
    rows = work.rows_u.reshape(-1)
    if case != "segment_boundary":
        run = np.flatnonzero(rows[:plan.u_base[1]] == 7)
        assert len(run) == 2 * b and run[-1] - run[0] == 2 * b - 1
        assert run[0] // 256 != run[-1] // 256  # it spans items
    else:
        for t in (1, 2):  # the same row on both sides of the boundary,
            prev = rows[plan.u_base[t - 1]:plan.u_base[t]]  # sentinels
            assert rows[plan.u_base[t]] == prev[prev >= 0][-1]  # between
            assert prev[-1] == tsp.SENTINEL_ROW
    dly = rng.normal(size=(len(tables), b, D)).astype(np.float32)
    # table 0's grads of one sign: the 400-term sum of the long run does not
    # cancel, so summation orders other than the kernel's stay within rtol
    # 1e-5 of it
    dly[0] = np.abs(dly[0])
    table = (rng.normal(size=(plan.padded_rows, D)) * 0.05).astype(np.float32)
    return rng, plan, work, dly, table


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _acc(optimizer, plan, gen, dev):
    if optimizer == "rwsadagrad":
        return torch.rand((plan.acc_rows, 128), generator=gen, device=dev)
    if optimizer == "adagrad":
        return torch.rand((plan.padded_rows, D), generator=gen, device=dev)
    return None


def _update_both(optimizer, plan, base, acc, g_u, sw, tdt, sr):
    """The kernel and the plain version on copies of (base, acc): one
    launch, bit-identical tables and accumulators."""
    outs = []
    launches = tk.LAUNCHES["stream_update"]
    for fn in (tk.stream_update, tk.stream_update_plain):
        t = base.clone()
        a = None if acc is None else acc.clone()
        fn(optimizer, plan, t, a, g_u, sw.rows_u, sw.item_block,
           sw.item_row0, sw.item_u, 0.05, mm_dtype=tdt, stochastic_round=sr,
           seed=3)
        outs.append((t, a))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stream_update"] == launches + 1
    (t_k, a_k), (t_p, a_p) = outs
    assert not torch.equal(t_k, base)
    assert torch.equal(t_k.view(torch.uint8), t_p.view(torch.uint8))
    if acc is not None:
        assert torch.equal(a_k, a_p)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("table_dtype,sr", [("float32", False),
                                            ("bfloat16", False),
                                            ("bfloat16", True)])
@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_stream_update_kernel_matches_plain(dev, optimizer, table_dtype, sr,
                                            touched, g_dtype):
    rng = np.random.default_rng(0)
    plan = make_stream_plan(TABLES, D, B, HOT, block_rows=1024)
    hb = ragged_multihot_batch(rng, 4, TABLES, HOT, B).with_stream_work(
        plan, update_touched_only=touched)
    sw = hb.to_device(dev).stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    dly = torch.randn((len(TABLES), B, D), generator=gen, device=dev)
    g_u = tk.gather_grads(dly, sw.vals_u, sw.wts_u, sw.w2t,
                          out_dtype=getattr(torch, g_dtype))
    tdt = getattr(torch, table_dtype)
    base = (torch.randn((plan.padded_rows, D), generator=gen, device=dev)
            * 0.05).to(tdt)
    _update_both(optimizer, plan, base, _acc(optimizer, plan, gen, dev), g_u,
                 sw, tdt, sr)


def _device_work(work, dev):
    return tsp.StreamWork(**{
        k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v
        for k, v in vars(work).items()})


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("table_dtype,sr", [("float32", False),
                                            ("bfloat16", True)])
@pytest.mark.parametrize("case", ["long_run", "segment_boundary", "touched"])
def test_stream_update_run_edge_cases_kernel_matches_plain(
        dev, case, optimizer, table_dtype, sr):
    _, plan, work, dly, table = _run_case(case)
    sw = _device_work(work, dev)
    g_u = tk.gather_grads(torch.from_numpy(dly).to(dev), sw.vals_u, sw.wts_u,
                          sw.w2t)
    tdt = getattr(torch, table_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    _update_both(optimizer, plan, torch.from_numpy(table).to(dev, tdt),
                 _acc(optimizer, plan, gen, dev), g_u, sw, tdt, sr)


def _work(dev, touched=False, seed=0):
    rng = np.random.default_rng(seed)
    plan = make_stream_plan(TABLES, D, B, HOT, block_rows=1024)
    hb = ragged_multihot_batch(rng, 4, TABLES, HOT, B)
    hb.wt[hb.wt != 0] = rng.uniform(0.5, 1.5, int((hb.wt != 0).sum()))
    return plan, hb.with_stream_work(plan, update_touched_only=touched
                                     ).to_device(dev).stream


def _wts(sw, weights):
    return sw.wts_u if weights == "random" else (sw.rows_u != -1).float()


@pytest.mark.cuda
@pytest.mark.parametrize("dly_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_window_grads_kernel_matches_plain(dev, dly_dtype, mm, weights,
                                           g_dtype):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # the [B, T, d] cotangent's transposed view, as the train step passes it
    dly = torch.randn((B, len(TABLES), D), generator=gen, device=dev).to(
        getattr(torch, dly_dtype)).transpose(0, 1)
    args = (dly, sw.vals_u, _wts(sw, weights), sw.w2t)
    kw = dict(mm_dtype=getattr(torch, mm), out_dtype=getattr(torch, g_dtype))
    launches = tk.LAUNCHES["window_grads"]
    got = tk.window_grads(*args, **kw)
    want = tk.window_grads_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["window_grads"] == launches + 1
    assert got.dtype == want.dtype == kw["out_dtype"]
    assert torch.equal(got, want)


# K1's edges: case -> (windows, tables, d, slots launched or None for all)
K1_CASES = {
    "ragged_tile": (2, 3, 128, 1000),  # ends inside a warp tile
    "below_tile": (1, 3, 128, 20),  # fewer slots than one warp tile
    "many_blocks": (300, 26, 128, None),  # 1,200 blocks over 26 tables
    "mixed_tables": (12, 5, 128, None),  # every window another table
    "d64": (6, 4, 64, None),
    "d256": (6, 4, 256, None),
    "sentinels": (6, 3, 128, None),  # all-sentinel windows, zero weights
}


def _k1_case(case, layout, dly_dtype, dev, seed=21):
    """Windows of random tables, bags and weights in [0.5, 1.5) (0 at
    sentinel slots: "sentinels" has windows 1 and 4 all sentinel and 30 %
    zero weights elsewhere), and dly as the [B, T, d] cotangent's
    transposed view or a contiguous [T, B, d]."""
    uw, t, d, _ = K1_CASES[case]
    b = 200
    rng = np.random.default_rng(seed)
    w2t = rng.integers(0, t, uw)
    if case == "mixed_tables":
        w2t = (np.arange(uw) * 3 + 1) % t
    vals = rng.integers(0, b, (uw, 8, 128))
    wts = rng.uniform(0.5, 1.5, (uw, 8, 128)).astype(np.float32)
    if case == "sentinels":
        wts[rng.random(wts.shape) < 0.3] = 0.0
        vals[[1, 4]] = 0
        wts[[1, 4]] = 0.0
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (b, t, d) if layout == "strided" else (t, b, d)
    dly = torch.randn(shape, generator=gen, device=dev).to(
        getattr(torch, dly_dtype))
    if layout == "strided":
        dly = dly.transpose(0, 1)
    return (dly, torch.from_numpy(vals).to(dev, torch.int32),
            torch.from_numpy(wts).to(dev),
            torch.from_numpy(w2t).to(dev, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(K1_CASES))
@pytest.mark.parametrize("layout", ["strided", "contiguous"])
@pytest.mark.parametrize("dly_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_window_grads_edges_kernel_matches_plain(dev, case, layout,
                                                 dly_dtype, mm, g_dtype):
    args = _k1_case(case, layout, dly_dtype, dev)
    mm_dt, g_dt = getattr(torch, mm), getattr(torch, g_dtype)
    slots = K1_CASES[case][3]
    want = tk.window_grads_plain(*args, mm_dtype=mm_dt, out_dtype=g_dt)
    launches = tk.LAUNCHES["window_grads"]
    if slots is None:
        got = tk.window_grads(*args, mm_dtype=mm_dt, out_dtype=g_dt)
    else:  # a count that is not whole windows: the launch under the wrapper
        got = tk._window_grads_launch(*args, slots, g_dt, mm_dt)
        want = want[:slots]
    torch.cuda.synchronize()
    assert tk.LAUNCHES["window_grads"] == launches + 1
    assert got.dtype == g_dt and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_stream_rows_kernel_matches_plain(dev, table_dtype, mm, r_dtype):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    table = torch.randn((plan.padded_rows, D), generator=gen,
                        device=dev).to(getattr(torch, table_dtype))
    args = (plan, table, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    kw = dict(mm_dtype=getattr(torch, mm), out_dtype=getattr(torch, r_dtype))
    launches = tk.LAUNCHES["stream_rows"]
    got = tk.stream_rows(*args, **kw)
    want = tk.stream_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stream_rows"] == launches + 1
    assert not bool(torch.isnan(want).any())  # every slot written
    assert got.dtype == want.dtype == kw["out_dtype"]
    assert torch.equal(got, want)


def _pool_both(plan, args, mm):
    """Two kernel calls (one launch each) and the plain version: all three
    bit-identical."""
    launches = tk.LAUNCHES["window_pool"]
    first = tk.window_pool(*args, mm_dtype=mm)
    again = tk.window_pool(*args, mm_dtype=mm)
    want = tk.window_pool_plain(*args, mm_dtype=mm)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["window_pool"] == launches + 2
    assert torch.equal(first, want)
    assert torch.equal(first.view(torch.int32), again.view(torch.int32))
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_window_pool_kernel_matches_plain(dev, mm, weights, r_dtype):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    r_u = torch.randn((plan.u_total, D), generator=gen, device=dev).to(
        getattr(torch, r_dtype))
    r_u[(sw.rows_u == -1).reshape(-1)] = 0  # as K3 writes the sentinels
    _pool_both(plan, (plan, r_u, sw.vals_u, _wts(sw, weights), sw.w2t),
               getattr(torch, mm))


@pytest.mark.cuda
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["weight0", "budgeted", "dropped_bag",
                                  "repeat_row"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_window_pool_edge_cases_kernel_matches_plain(dev, case, mm, r_dtype):
    plan, work, r_u = _pool_case(case)
    sw = _device_work(work, dev)
    r_u = torch.from_numpy(r_u).to(dev, getattr(torch, r_dtype))
    got = _pool_both(plan, (plan, r_u, sw.vals_u, sw.wts_u, sw.w2t),
                     getattr(torch, mm))
    if case == "dropped_bag":  # +0, written although no slot lists it
        assert not bool(got[1, 5].view(torch.int32).any())
