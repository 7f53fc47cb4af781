"""The port's gather_grads and its K1-K4 (window_grads, stream_update,
stream_rows, window_pool, stream_embedding_fwd) against dlrm_tpu's (Pallas
in interpret mode), on the same numpy-built U-layout inputs. On the CPU the
port's wrappers take their plain versions; the CUDA kernels are held
against the plain versions by tests/test_torch_cuda_kernels.py (skipped
without a card) and by chip_smoke.py.

K1 and K3 compute the same products and copies as JAX: K1 within rtol 1e-6
/ atol 1e-6, K3 bit-exact. K4 and the streamed forward sum in another order
(index_add_ against one-hot matmuls): rtol 1e-5 / atol 1e-5.

The bf16 intermediates (the step's g_dtype): gather_grads, K1 and K3 with
out_dtype bf16 round the same fp32 values once to the nearest bf16, so they
equal JAX's bit for bit; K2 on a bf16 G_u and K4 on a bf16 R_u read exact
bf16 values and are held at the fp32 cases' tolerances.

K2 tolerances: fp32 tables/accumulators rtol 1e-5 / atol 1e-6 (the JAX kernel
sums each block's grads with one-hot matmuls, the port per row in slot
order); bf16 tables at most 1 bf16 ulp apart at the scale of the update's
operands, both sides rounding to nearest (JAX interpret mode has no
stochastic rounding). Stochastic rounding is checked for bias
statistically.

The run edge cases (a row whose hits span several items, equal rows on
both sides of a table boundary, the touched-only list) and the pooling
edge cases (weight-0 slots, a budgeted table, a bag with every hit dropped,
a bag hitting one row twice) come from tests/test_torch_cuda_kernels.py,
which holds the kernels against the plain versions on the same cases."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.ops import stream_kernels as jk
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.ops import stream_plan as tsp
from test_torch_cuda_kernels import _pool_case, _run_case

TABLES = (300, 50, 700)
D = 128
B = 256  # B*H = 512: multi-chunk block runs
H = 2
BR = 1024
LR = 0.05


def _work(plan, idx, wt, touched):
    w = tsp.build_stream_work(plan, idx, wt, prefer_native=False)
    return tsp.touched_update_items(plan, w) if touched else w


def _setup(tables=TABLES, b=B, h=H, br=BR, seed=7, concentrate=None):
    rng = np.random.default_rng(seed)
    plan = tsp.make_stream_plan(tables, D, b, h, block_rows=br)
    idx = np.stack([rng.integers(0, n, (b, h)) for n in tables]).astype(
        np.int32)
    if concentrate is not None:
        idx %= concentrate
    wt = rng.uniform(0.5, 1.5, size=idx.shape).astype(np.float32)
    dly = rng.normal(size=(len(tables), b, D)).astype(np.float32)
    table = (rng.normal(size=(plan.padded_rows, D)) * 0.05).astype(np.float32)
    return rng, plan, idx, wt, dly, table


def _acc(optimizer, plan, rng):
    if optimizer == "sgd":
        return None
    if optimizer == "rwsadagrad":
        return (rng.random((plan.acc_rows, 128)) * 0.1).astype(np.float32)
    return (rng.random((plan.padded_rows, D)) * 0.1).astype(np.float32)


def _g_u(dly, work, g_dtype="float32"):
    return np.array(jk.gather_grads(
        jnp.asarray(dly), jnp.asarray(work.vals_u), jnp.asarray(work.wts_u),
        jnp.asarray(work.w2t), out_dtype=getattr(jnp, g_dtype)))


def _to_torch(a):
    """A numpy array (ml_dtypes bfloat16 included) as a torch tensor of
    the same dtype and bits."""
    a = np.array(a)  # a writable copy
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _assert_same(got, want):
    """got (torch) and want (numpy, from JAX) hold the same dtype and equal
    values: the same bits, but for the sign of a zero (K1's sentinel slots
    are w * dly = -0 where dly < 0, JAX's one-hot sums give +0)."""
    want = _to_torch(want)
    assert got.dtype == want.dtype
    assert torch.equal(got, want), int((got != want).sum())


def _run_jax(optimizer, plan, table, acc, g_u, work, mm):
    out = jk.stream_update(
        optimizer, plan, jnp.asarray(table),
        None if acc is None else jnp.asarray(acc), jnp.asarray(g_u),
        jnp.asarray(work.rows_u), jnp.asarray(work.item_block),
        jnp.asarray(work.item_row0), jnp.asarray(work.item_u), LR,
        mm_dtype=mm, interpret=True,
    )
    return [np.asarray(o).astype(np.float32) for o in out]


def _run_port(optimizer, plan, table, acc, g_u, work, mm, **kw):
    t_table = torch.from_numpy(table.copy())
    t_acc = None if acc is None else torch.from_numpy(acc.copy())
    out = tk.stream_update(
        optimizer, plan, t_table, t_acc, _to_torch(g_u),
        torch.from_numpy(work.rows_u), torch.from_numpy(work.item_block),
        torch.from_numpy(work.item_row0), torch.from_numpy(work.item_u), LR,
        mm_dtype=mm, **kw,
    )
    assert out[0] is t_table  # in place
    return out


@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dly_dtype", ["float32", "bfloat16"])
def test_gather_grads_matches_jax(dly_dtype, g_dtype):
    """G_u from an fp32 or a bf16 cotangent (the bf16 tower's), in fp32 or
    in bf16 (the step's g_dtype): the fp32 product rounded once, JAX's bits."""
    _, plan, idx, wt, dly, _ = _setup()
    work = _work(plan, idx, wt, False)
    t_dly = torch.from_numpy(dly).to(getattr(torch, dly_dtype))
    args = (t_dly, torch.from_numpy(work.vals_u),
            torch.from_numpy(work.wts_u), torch.from_numpy(work.w2t))
    got = tk.gather_grads(*args, out_dtype=getattr(torch, g_dtype))
    assert got.dtype == getattr(torch, g_dtype)
    want = np.array(jk.gather_grads(
        jnp.asarray(dly, getattr(jnp, dly_dtype)), jnp.asarray(work.vals_u),
        jnp.asarray(work.wts_u), jnp.asarray(work.w2t),
        out_dtype=getattr(jnp, g_dtype)))
    if g_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    else:
        _assert_same(got, want)
        assert torch.equal(got, tk.gather_grads(*args).to(torch.bfloat16))


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_plain_stream_update_matches_jax(optimizer, mm, touched, g_dtype):
    """G_u in fp32 or bf16 (the step's g_dtype; JAX's kernel reads the
    same bf16 G_u)."""
    rng, plan, idx, wt, dly, table = _setup()
    work = _work(plan, idx, wt, touched)
    assert work.num_real_items < plan.max_items  # pad items are present
    acc = _acc(optimizer, plan, rng)
    g_u = _g_u(dly, work, g_dtype)
    want = _run_jax(optimizer, plan, table, acc, g_u, work, getattr(jnp, mm))
    got = _run_port(optimizer, plan, table, acc, g_u, work,
                    getattr(torch, mm))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)
    # the trailing pad block is never written
    np.testing.assert_array_equal(
        got[0].numpy()[plan.pad_block * BR:], table[plan.pad_block * BR:])


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_touched_only_leaves_hit_free_blocks_untouched(optimizer):
    """Hits only in rows < 80: one block per table is touched; the
    touched-only list is shorter, gives the full list's result to the bit,
    and leaves every other block exactly as it was."""
    rng, plan, idx, wt, dly, table = _setup(
        tables=(1500, 300, 2200), concentrate=80)
    full = _work(plan, idx, wt, False)
    slim = _work(plan, idx, wt, True)
    assert slim.num_real_items < full.num_real_items
    assert len(np.unique(slim.item_block[: slim.num_real_items])) == 3
    acc = _acc(optimizer, plan, rng)
    g_u = _g_u(dly, full)
    a = _run_port(optimizer, plan, table, acc, g_u, full, torch.float32)
    b = _run_port(optimizer, plan, table, acc, g_u, slim, torch.float32)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    touched = set(int(x) for x in slim.item_block[: slim.num_real_items])
    for blk in range(plan.num_blocks + 1):
        if blk not in touched:
            np.testing.assert_array_equal(
                b[0].numpy()[blk * BR:(blk + 1) * BR],
                table[blk * BR:(blk + 1) * BR])
    want = _run_jax(optimizer, plan, table, acc, g_u, slim, jnp.float32)
    for w, g in zip(want, b):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_chunk_overrunning_into_next_block():
    """A block whose run is exactly 128 slots gets one 256-slot item, which
    reads the next block's run too: those hits belong to the next block and
    must be dropped by the row-range test."""
    b, br = 128, 128
    plan = tsp.make_stream_plan((512,), D, b, 2, block_rows=br)
    rng = np.random.default_rng(9)
    # 128 hits in block 0 (rows 0..127), 128 hits in block 1 (rows 128..255)
    idx = np.stack([np.arange(128), 128 + np.arange(128)], axis=1)
    idx = idx[None].astype(np.int32)  # [1, B, 2]
    wt = np.ones_like(idx, np.float32)
    work = _work(plan, idx, wt, True)
    n = work.num_real_items
    first = [i for i in range(n) if work.item_block[i] == 0]
    assert len(first) == 1
    u0 = int(work.item_u[first[0]])
    nxt = work.rows_u.reshape(-1)[u0 + 128: u0 + 256]
    assert (nxt >= br).all(), "the item should read block 1's run"
    dly = rng.normal(size=(1, b, D)).astype(np.float32)
    table = rng.normal(size=(plan.padded_rows, D)).astype(np.float32)
    g_u = _g_u(dly, work)
    want = table.copy()
    for bag in range(b):
        for k in range(2):
            want[idx[0, bag, k]] -= LR * dly[0, bag]
    got = _run_port("sgd", plan, table, None, g_u, work, torch.float32)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-5, atol=1e-6)
    jax_out = _run_jax("sgd", plan, table, None, g_u, work, jnp.float32)
    np.testing.assert_allclose(got[0].numpy(), jax_out[0], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_bf16_table_round_to_nearest_within_one_ulp(optimizer):
    rng, plan, idx, wt, dly, table = _setup()
    work = _work(plan, idx, wt, True)
    acc = _acc(optimizer, plan, rng)
    g_u = _g_u(dly, work)
    t16 = np.asarray(jnp.asarray(table, jnp.bfloat16))
    want = jk.stream_update(
        optimizer, plan, jnp.asarray(t16), None if acc is None
        else jnp.asarray(acc), jnp.asarray(g_u), jnp.asarray(work.rows_u),
        jnp.asarray(work.item_block), jnp.asarray(work.item_row0),
        jnp.asarray(work.item_u), LR, mm_dtype=jnp.bfloat16, interpret=True,
        stochastic_round=True,  # interpret mode rounds to nearest anyway
    )
    t_table = torch.from_numpy(t16.view(np.uint16).copy()).view(
        torch.bfloat16)
    got = tk.stream_update(
        optimizer, plan, t_table,
        None if acc is None else torch.from_numpy(acc.copy()),
        torch.from_numpy(g_u), torch.from_numpy(work.rows_u),
        torch.from_numpy(work.item_block), torch.from_numpy(work.item_row0),
        torch.from_numpy(work.item_u), LR, mm_dtype=torch.bfloat16,
        stochastic_round=False,
    )
    a = np.asarray(want[0]).astype(np.float64)
    b = got[0].double().numpy()
    old = t16.astype(np.float64)
    # one bf16 ulp at the scale of the operands: where the update nearly
    # cancels the old value, the result's own ulp is finer than the fp32
    # rounding of its operands, which differs with the summation order
    scale = np.maximum(np.maximum(np.abs(a), np.abs(b)), np.abs(old))
    ulp = np.exp2(np.floor(np.log2(np.maximum(scale, 2.0**-126))) - 7)
    assert (np.abs(a - b) <= ulp).all(), np.abs(a - b).max()
    exact = np.abs(a - b) <= np.exp2(
        np.floor(np.log2(np.maximum(np.maximum(np.abs(a), np.abs(b)),
                                    2.0**-126))) - 7)
    assert exact.mean() > 0.999, exact.mean()
    if acc is not None:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)


def test_stochastic_rounding_is_unbiased():
    """SR on: over many seeds, the mean of the rounded bf16 values equals
    the fp32 update within 4 sigma (aggregated over all updated elements);
    every rounded value is one of the two bf16 neighbours of the fp32 one."""
    rng, plan, idx, wt, dly, table = _setup()
    work = _work(plan, idx, wt, True)
    acc = _acc("rwsadagrad", plan, rng)
    g_u = _g_u(dly, work)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    exact = _run_port("rwsadagrad", plan, t16.float().numpy(), acc, g_u,
                      work, torch.bfloat16)[0]
    rows = torch.nonzero((exact != t16.float()).any(1)).squeeze(1)
    v = exact[rows].double()
    lo = v.to(torch.bfloat16).double()
    # bf16 neighbours of v: lo and the next value away from lo
    up = torch.where(lo <= v, torch.nextafter(lo.to(torch.bfloat16),
                                              torch.tensor(np.inf, dtype=torch.bfloat16)).double(),
                     torch.nextafter(lo.to(torch.bfloat16),
                                     torch.tensor(-np.inf, dtype=torch.bfloat16)).double())
    n_seeds = 64
    total = torch.zeros_like(v)
    for seed in range(n_seeds):
        t = t16.clone()
        tk.stream_update(
            "rwsadagrad", plan, t, torch.from_numpy(acc.copy()),
            torch.from_numpy(g_u), torch.from_numpy(work.rows_u),
            torch.from_numpy(work.item_block),
            torch.from_numpy(work.item_row0), torch.from_numpy(work.item_u),
            LR, mm_dtype=torch.bfloat16, stochastic_round=True, seed=seed,
        )
        got = t[rows].double()
        assert bool(((got == lo) | (got == up)).all())
        total += got
    mean = total / n_seeds
    p = ((v - lo) / (up - lo)).clamp(0, 1)
    var = (up - lo) ** 2 * p * (1 - p) / n_seeds
    z = float((mean - v).sum() / var.sum().sqrt())
    assert abs(z) < 4.0, z
    # and the bits do vary with the seed: SR is not round-to-nearest
    assert 0.05 < float(((mean != lo) & (mean != up)).double().mean())


def test_wrapper_rejects_bad_inputs():
    _, plan, idx, wt, dly, table = _setup()
    work = _work(plan, idx, wt, True)
    g_u = torch.from_numpy(_g_u(dly, work))
    args = [torch.from_numpy(work.rows_u), torch.from_numpy(work.item_block),
            torch.from_numpy(work.item_row0), torch.from_numpy(work.item_u),
            LR]
    t = torch.from_numpy(table.copy())
    with pytest.raises(ValueError, match="optimizer"):
        tk.stream_update("adam", plan, t, None, g_u, *args)
    with pytest.raises(TypeError, match="dtype"):
        tk.stream_update("sgd", plan, t.double(), None, g_u, *args)
    with pytest.raises(ValueError, match="shape"):
        tk.stream_update("sgd", plan, t[:-1], None, g_u, *args)
    with pytest.raises(ValueError, match="contiguous"):
        tk.stream_update("sgd", plan, t.t().contiguous().t(), None, g_u,
                         *args)
    with pytest.raises(TypeError, match="acc must be a tensor"):
        tk.stream_update("rwsadagrad", plan, t, None, g_u, *args)
    with pytest.raises(TypeError, match="host scalars"):
        tk.stream_update("sgd", plan, t, None, g_u, *args[:-1],
                         torch.tensor(LR))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.stream_update(
            "sgd", plan, t.to("meta"), None, g_u.to("meta"),
            *[a.to("meta") for a in args[:-1]], LR)


def test_sr_bits_match_the_kernel_hash():
    """The plain version's hash is the kernel's hash32 (fixed vectors
    computed from csrc/stream_update.cu's definition in uint32 arithmetic)."""

    def hash32(x):
        x &= 0xFFFFFFFF
        for shift, mul in ((16, 0x7FEB352D), (15, 0x2C1B3C6D),
                           (16, 0x297A2D39)):
            x ^= x >> shift
            x = (x * mul) & 0xFFFFFFFF
        return x ^ (x >> 15)

    rows = torch.tensor([0, 1, 5_220_351, 2**31 - 1])
    got = tk.sr_bits(12345, rows, 4)
    for i, r in enumerate(rows.tolist()):
        key = hash32(r ^ hash32(12345))
        for c in range(4):
            assert int(got[i, c]) == hash32(key ^ c) >> 16


# ------------------------------------------------------- K1, K3 and K4
def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _unit_wts(work):
    return (work.rows_u != tsp.SENTINEL_ROW).astype(np.float32)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("g_dtype", ["float32", "bfloat16"])
def test_window_grads_matches_jax(mm, weights, g_dtype):
    """fp32 G_u within rtol 1e-6; bf16 G_u (out_dtype, the step's
    g_dtype) JAX's bits and the fp32 G_u rounded once."""
    _, plan, idx, wt, dly, _ = _setup()
    work = _work(plan, idx, wt, False)
    wts = work.wts_u if weights == "random" else _unit_wts(work)
    want = np.asarray(jk.window_grads(
        jnp.asarray(dly), jnp.asarray(work.vals_u), jnp.asarray(wts),
        jnp.asarray(work.w2t), mm_dtype=getattr(jnp, mm),
        out_dtype=getattr(jnp, g_dtype), interpret=True))
    # the [B, T, d] cotangent's transposed view, as the train step passes it
    dly_btd = _t(dly.transpose(1, 0, 2))
    args = (dly_btd.transpose(0, 1), _t(work.vals_u), _t(wts), _t(work.w2t))
    got = tk.window_grads(*args, mm_dtype=getattr(torch, mm),
                          out_dtype=getattr(torch, g_dtype))
    assert got.dtype == getattr(torch, g_dtype)
    assert got.shape == (plan.u_total, D)
    if g_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        _assert_same(got, want)
        g32 = tk.window_grads(*args, mm_dtype=getattr(torch, mm))
        assert torch.equal(got, g32.to(torch.bfloat16))
    sent = work.rows_u.reshape(-1) == tsp.SENTINEL_ROW
    assert (got.float().numpy()[sent] == 0).all()


@pytest.mark.parametrize("u_total,want", [
    (0, (0, 0)),  # no slot: no launch
    (20, (1, 1)),  # below one warp tile
    (1000, (32, 4)),  # ends inside a warp tile
    (1024, (32, 4)),  # one window
    (300 * 1024, (9600, 1200)),
    (3_763 * 1024, (120_416, 15_052)),  # phase 4's full width
])
def test_window_grads_grid(u_total, want):
    """K1's launch: every slot lies in one of the tiles, and every tile has
    a warp of the grid and every warp a tile (the last block's excepted)."""
    tiles, grid = tk.window_grads_grid(u_total)
    assert (tiles, grid) == want
    assert (tiles - 1) * tk.K1_TILE < u_total <= tiles * tk.K1_TILE or (
        u_total == tiles == 0)
    assert (grid - 1) * tk.K1_WARPS < tiles <= grid * tk.K1_WARPS or (
        tiles == grid == 0)


def test_window_grads_launch_constants_match_the_kernel_source():
    """K1_TILE is window_grads.cu's kTile, K1_WARPS its blocks' warps; a
    tile lies in one window."""
    csrc = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "window_grads.cu")) as f:
        tile = re.search(r"constexpr int kTile = (\d+);", f.read())
    with open(os.path.join(csrc, "u_layout.cuh")) as f:
        threads = re.search(r"constexpr int kThreads = (\d+);", f.read())
    assert int(tile.group(1)) == tk.K1_TILE
    assert int(threads.group(1)) == 32 * tk.K1_WARPS
    assert tsp.WINDOW % tk.K1_TILE == 0


def test_window_grads_of_no_window():
    g_u = tk.window_grads(torch.zeros((2, 4, D)),
                          torch.zeros((0, 8, 128), dtype=torch.int32),
                          torch.zeros((0, 8, 128)),
                          torch.zeros((0,), dtype=torch.int32))
    assert g_u.shape == (0, D) and g_u.dtype == torch.float32


def _overrun_case():
    """One table of 4 blocks of 128 rows: block 0's run is exactly 128
    slots, so its 256-slot item reads block 1's run too; blocks 2 and 3 are
    hit-free (sentinel-chunk items); the full list adds the tail covers."""
    b, br = 128, 128
    plan = tsp.make_stream_plan((512,), D, b, 2, block_rows=br)
    idx = np.stack([np.arange(128), 128 + np.arange(128)], axis=1)
    idx = idx[None].astype(np.int32)  # [1, B, 2]
    work = _work(plan, idx, np.ones_like(idx, np.float32), False)
    first = [i for i in range(work.num_real_items) if work.item_block[i] == 0]
    assert len(first) == 1
    u0 = int(work.item_u[first[0]])
    assert (work.rows_u.reshape(-1)[u0 + 128: u0 + 256] >= br).all()
    return plan, work


@pytest.mark.parametrize("case", ["overrun", "multi_table"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_stream_rows_matches_jax(case, table_dtype, mm, r_dtype):
    """Bit-exact against JAX on the full list, and every slot holds its
    row: table[padded_offsets[t] + rows_u] (rounded to mm, then to R_u's
    dtype r_dtype, the step's g_dtype), 0 at sentinels."""
    rng = np.random.default_rng(11)
    if case == "overrun":
        plan, work = _overrun_case()
    else:
        _, plan, idx, wt, _, _ = _setup()
        work = _work(plan, idx, wt, False)
    table = rng.normal(size=(plan.padded_rows, D)).astype(np.float32)
    jt = jnp.asarray(table, getattr(jnp, table_dtype))
    want = np.asarray(jk.stream_rows(
        plan, jt, jnp.asarray(work.rows_u), jnp.asarray(work.item_block),
        jnp.asarray(work.item_row0), jnp.asarray(work.item_u),
        mm_dtype=getattr(jnp, mm), out_dtype=getattr(jnp, r_dtype),
        interpret=True))
    tt = _t(np.asarray(jt.astype(jnp.float32))).to(getattr(torch, table_dtype))
    got = tk.stream_rows(
        plan, tt, _t(work.rows_u), _t(work.item_block), _t(work.item_row0),
        _t(work.item_u), mm_dtype=getattr(torch, mm),
        out_dtype=getattr(torch, r_dtype))
    _assert_same(got, want)
    rows = work.rows_u.reshape(-1)
    t_of = np.repeat(work.w2t, 1024)
    real = rows != tsp.SENTINEL_ROW
    ref = tt[torch.from_numpy(np.asarray(plan.padded_offsets)[t_of[real]]
                              + rows[real])].to(getattr(torch, mm)).to(
                                  getattr(torch, r_dtype))
    torch.testing.assert_close(got[torch.from_numpy(real)], ref, rtol=0,
                               atol=0)
    assert (got.float().numpy()[~real] == 0).all()


def test_stream_rows_needs_the_full_list():
    """The touched-only list has no cover items: its tail slots stay
    unwritten (NaN in the plain version, garbage in the kernel)."""
    _, plan, idx, wt, _, table = _setup()
    work = _work(plan, idx, wt, True)
    got = tk.stream_rows(
        plan, _t(table), _t(work.rows_u), _t(work.item_block),
        _t(work.item_row0), _t(work.item_u))
    unwritten = torch.isnan(got).any(1)
    assert bool(unwritten.any())
    assert not bool(unwritten[torch.from_numpy(
        work.rows_u.reshape(-1) != tsp.SENTINEL_ROW)].any())


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "random"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_window_pool_matches_jax(mm, weights, r_dtype):
    """R_u in fp32 or bf16 (the step's g_dtype); pooled fp32 either way."""
    rng, plan, idx, wt, _, _ = _setup()
    work = _work(plan, idx, wt, False)
    wts = work.wts_u if weights == "random" else _unit_wts(work)
    r_u = np.asarray(jnp.asarray(
        rng.normal(size=(plan.u_total, D)).astype(np.float32),
        getattr(jnp, r_dtype)))
    want = np.asarray(jk.window_pool(
        plan, jnp.asarray(r_u), jnp.asarray(work.vals_u), jnp.asarray(wts),
        jnp.asarray(work.w2t), mm_dtype=getattr(jnp, mm), interpret=True))
    got = tk.window_pool(plan, _to_torch(r_u), _t(work.vals_u), _t(wts),
                         _t(work.w2t), mm_dtype=getattr(torch, mm))
    assert got.shape == (len(TABLES), B, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["weight0", "budgeted", "dropped_bag",
                                  "repeat_row"])
def test_window_pool_edge_cases_match_jax(case, mm):
    """The bag-major plain version (each bag's slots of nonzero weight in
    slot order) against JAX's one-hot pooling over every slot."""
    plan, work, r_u = _pool_case(case)
    args = (r_u, work.vals_u, work.wts_u, work.w2t)
    want = np.asarray(jk.window_pool(
        plan, *[jnp.asarray(a) for a in args], mm_dtype=getattr(jnp, mm),
        interpret=True))
    got = tk.window_pool(plan, *[_t(a) for a in args],
                         mm_dtype=getattr(torch, mm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if case == "dropped_bag":  # +0, not -0 or garbage
        row = got.numpy()[1, 5]
        assert (row == 0).all() and not np.signbit(row).any()


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("case", ["long_run", "segment_boundary", "touched"])
def test_plain_stream_update_run_edge_cases_match_jax(case, optimizer):
    rng, plan, work, dly, table = _run_case(case)
    acc = _acc(optimizer, plan, rng)
    g_u = _g_u(dly, work)
    want = _run_jax(optimizer, plan, table, acc, g_u, work, jnp.float32)
    got = _run_port(optimizer, plan, table, acc, g_u, work, torch.float32)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_warp_sum_order():
    """_warp_sum is the kernel's order: lane j sums its 4 neighbouring
    columns (per 128) from zero, then the xor butterfly; padding past d
    changes nothing."""
    rng = np.random.default_rng(14)
    for d in (8, 128, 200, 256):
        x = torch.from_numpy(rng.random((5, d)).astype(np.float32))
        lanes = np.zeros((5, 32), np.float32)
        xp = np.pad(x.numpy(), ((0, 0), (0, -(-d // 128) * 128 - d)))
        for k in range(xp.shape[1] // 128):
            for q in range(4):
                lanes = lanes + xp[:, k * 128 + q:(k + 1) * 128:4]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ o]
        np.testing.assert_array_equal(tk._warp_sum(x).numpy(), lanes[:, 0])
        np.testing.assert_allclose(tk._warp_sum(x).numpy(),
                                   x.double().sum(1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("r_dtype", ["float32", "bfloat16"])
def test_stream_embedding_fwd_matches_jax(mm, r_dtype):
    """K3 then K4, R_u in r_dtype (the step's g_dtype), against JAX's
    stream_embedding_fwd and, with fp32 throughout, against the port's own
    gather forward (one F.embedding_bag)."""
    from dlrm_tpu_torch.ops.embedding import grouped_embedding_bag

    _, plan, idx, wt, _, table = _setup()
    work = _work(plan, idx, wt, False)
    arrays = (work.rows_u, work.vals_u, work.wts_u, work.w2t,
              work.item_block, work.item_row0, work.item_u)
    want = np.asarray(jk.stream_embedding_fwd(
        plan, jnp.asarray(table), *[jnp.asarray(a) for a in arrays],
        mm_dtype=getattr(jnp, mm), r_dtype=getattr(jnp, r_dtype),
        interpret=True))
    got = tk.stream_embedding_fwd(plan, _t(table), *[_t(a) for a in arrays],
                                  mm_dtype=getattr(torch, mm),
                                  r_dtype=getattr(torch, r_dtype))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if mm == r_dtype == "float32":
        ref = grouped_embedding_bag(
            _t(table), torch.tensor(plan.padded_offsets), _t(idx), _t(wt),
            plan.hot)
        torch.testing.assert_close(got.transpose(0, 1), ref, rtol=1e-5,
                                   atol=1e-5)


def test_kernel_wrappers_reject_bad_inputs():
    rng, plan, idx, wt, dly, table = _setup()
    work = _work(plan, idx, wt, False)
    vals, wts, w2t = _t(work.vals_u), _t(work.wts_u), _t(work.w2t)
    items = [_t(work.rows_u), _t(work.item_block), _t(work.item_row0),
             _t(work.item_u)]
    r_u = torch.zeros((plan.u_total, D))
    with pytest.raises(TypeError, match="out_dtype"):
        tk.window_grads(_t(dly), vals, wts, w2t, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="out_dtype"):
        tk.gather_grads(_t(dly), vals, wts, w2t, out_dtype=torch.float16)
    with pytest.raises(TypeError, match="mm_dtype"):
        tk.window_grads(_t(dly), vals, wts, w2t, mm_dtype=torch.float16)
    with pytest.raises(ValueError, match="unit column stride"):
        tk.window_grads(_t(dly).transpose(1, 2), vals, wts, w2t)
    with pytest.raises(TypeError, match="dtype"):
        tk.window_grads(_t(dly), vals.long(), wts, w2t)
    with pytest.raises(ValueError, match="elements"):
        tk.window_grads(_t(dly), vals[:-1], wts, w2t)
    with pytest.raises(ValueError, match="shape"):
        tk.stream_rows(plan, _t(table)[:-1], *items)
    with pytest.raises(TypeError, match="out_dtype"):
        tk.stream_rows(plan, _t(table), *items, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        tk.stream_rows(plan, _t(table).t().contiguous().t(), *items)
    with pytest.raises(ValueError, match="shape"):
        tk.window_pool(plan, r_u[:-1], vals, wts, w2t)
    with pytest.raises(TypeError, match="dtype"):
        tk.window_pool(plan, r_u.double(), vals, wts, w2t)
    with pytest.raises(TypeError, match="r_u has dtype"):
        tk.window_pool(plan, r_u.half(), vals, wts, w2t)
    with pytest.raises(TypeError, match="g_u has dtype"):
        tk.stream_update("sgd", plan, _t(table), None, r_u.half(), *items,
                         LR)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tk.window_pool(plan, r_u.to("meta"), vals.to("meta"),
                       wts.to("meta"), w2t.to("meta"))
    with pytest.raises(ValueError, match="span devices"):
        tk.window_pool(plan, r_u.to("meta"), vals, wts, w2t)
