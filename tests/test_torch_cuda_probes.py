"""The probes' hand-written CUDA kernels (ops/probe_kernels.py) against
their plain PyTorch versions on the card, at small sizes. Needs a CUDA card
(marked `cuda`, skipped with a reason elsewhere) and imports nothing of JAX,
so on a machine without JAX it runs as
`python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_probes.py`.
chip_smoke.py phase 5 runs the same comparisons at the probes' own sizes.

Bit-identical: row_gather, row_scatter_add_ (one add per element, unique
rows), block_stream (the same two rounded ops; blocks that are not whole
spans of its grid, a ragged last block, walks of one block and permuted,
in place and not, and a launch captured in a CUDA graph), t3_reshape_add,
k2_bisect's skeletons (the table unchanged) and its full variants against
the plain sgd update and K2 itself (also on plans of blocks holding
multiples of 128 hits, hit-free blocks and a row of 6,000 hits, at d 64
and 128), t6_revolve_accumulate (both add in j order from +0.0) and
t4_onehot_accumulate against its plain version run on CPU copies of its
inputs (index order from +0.0 on both; on the card the plain version's
index_add_ adds with atomics in no fixed order). Against the plain
versions' other sum orders: t2_contract rtol 1e-5 / atol 1e-4 (a cuBLAS
product), and at T2_SCALE within twice the plain version's error against
an fp64 product, plus 1e-5; two t2_contract calls give the same bits.
T2, T3, T4 and T6 also at ragged and misaligned shapes, and launched
inside a CUDA graph's capture."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.ops.stream_plan import (
    build_stream_work,
    make_stream_plan,
    touched_update_items,
)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def _counted(name):
    """Asserts on exit that kernel `name` was launched exactly once."""
    class _C:
        def __enter__(self):
            self.n = tk.LAUNCHES[name]

        def __exit__(self, *exc):
            torch.cuda.synchronize()
            if exc[0] is None:
                assert tk.LAUNCHES[name] == self.n + 1
    return _C()


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["rows", "transposed", "2d_idx"])
def test_row_gather_kernel_matches_plain(dev, view):
    table = torch.randn((3000, 128), generator=_gen(dev, 0), device=dev)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 3000, 1000).astype(np.int32)).to(dev)
    if view == "transposed":  # P2b's lane take: rows of a transposed view
        table = table[:256].T.contiguous().T
        idx = idx % 256
    elif view == "2d_idx":
        idx = idx[:1024 // 8 * 8].reshape(-1, 8)
    with _counted("row_gather"):
        got = pk.row_gather(table, idx)
    assert torch.equal(got, pk.row_gather_plain(table, idx))


@pytest.mark.cuda
def test_row_scatter_add_kernel_matches_plain(dev):
    gen = _gen(dev, 1)
    table = torch.randn((5000, 128), generator=gen, device=dev)
    idx = torch.from_numpy(np.random.default_rng(1).permutation(5000)[
        :1200].astype(np.int32)).to(dev)
    delta = torch.randn((1200, 128), generator=gen, device=dev)
    want = pk.row_scatter_add_plain(table.clone(), idx, delta)
    with _counted("row_scatter_add"):
        got = pk.row_scatter_add_(table.clone(), idx, delta,
                                  check_unique=True)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_row_scatter_add_skips_rows_outside_the_table(dev):
    """The fused step's slots past the table (rows total_rows + slot) and
    negative rows are skipped by the kernel and by its plain version
    alike: the same bits."""
    gen = _gen(dev, 2)
    table = torch.randn((5000, 128), generator=gen, device=dev)
    perm = np.random.default_rng(2).permutation(5000)[:1000]
    idx = np.concatenate([perm, 5000 + np.arange(300), [-1, -7]])
    idx = torch.from_numpy(idx.astype(np.int32)).to(dev)
    delta = torch.randn((idx.numel(), 128), generator=gen, device=dev)
    want = pk.row_scatter_add_plain(table.clone(), idx, delta)
    with _counted("row_scatter_add"):
        got = pk.row_scatter_add_(table.clone(), idx, delta)
    assert torch.equal(got, want)
    untouched = torch.ones(5000, dtype=torch.bool, device=dev)
    untouched[idx[:1000].long()] = False
    assert torch.equal(got[untouched], table[untouched])


# (rows, d, block_rows): blocks that are not whole spans of the grid (its
# CTAs cover 8-16 KB, twice that on a walk from ib), a ragged last block on
# the static map (a walk takes whole blocks: rows cut to them), one block
BLOCK_SHAPES = [(480, 128, 48), (1000, 128, 48), (16 * 100, 128, 100),
                (5 * 33, 12, 33), (2048, 128, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,br", BLOCK_SHAPES)
@pytest.mark.parametrize("walk", ["static", "one", "dynamic"])
@pytest.mark.parametrize("in_place", [False, True], ids=["out", "aliased"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_block_stream_kernel_matches_plain(dev, rows, d, br, walk, in_place,
                                           depth):
    """dynamic: a permuted walk over 7 of every 10 blocks (the others keep
    their values); one: a walk of one block."""
    if walk != "static":
        rows -= rows % br
    nblk = -(-rows // br)
    t = torch.randn((rows, d), generator=_gen(dev, 2), device=dev)
    perm = np.random.default_rng(2).permutation(nblk)
    ib = (None if walk == "static" else torch.from_numpy(
        (perm[:1] if walk == "one" else perm[:max(1, nblk * 7 // 10)])
        .astype(np.int32)).to(dev))
    kw = dict(scale=1.000001, shift=0.5, depth=depth, block_rows=br)
    out0 = torch.full_like(t, -7.0)
    want = pk.block_stream_plain(t.clone(), ib,
                                 out=None if in_place else out0.clone(), **kw)
    src = t.clone()
    with _counted("block_stream"):
        got = pk.block_stream(src, ib, out=None if in_place else out0.clone(),
                              **kw)
    assert (got is src) == in_place
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_block_stream_launch_is_captured_by_a_cuda_graph(dev):
    """A permuted walk in place, captured: each replay applies the update
    once more, as the eager calls do."""
    br, nblk = 64, 12
    t = torch.randn((nblk * br, 128), generator=_gen(dev, 8), device=dev)
    ib = torch.from_numpy(np.random.default_rng(8).permutation(nblk)[:9]
                          .astype(np.int32)).to(dev)
    kw = dict(scale=1.5, shift=-0.25, block_rows=br)
    want = t.clone()
    for _ in range(3):
        pk.block_stream_plain(want, ib, **kw)
    got = t.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with _counted("block_stream"):
            pk.block_stream(got, ib, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _counted("block_stream"):
        with torch.cuda.graph(graph):
            pk.block_stream(got, ib, **kw)
    n = tk.LAUNCHES["block_stream"]
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert tk.LAUNCHES["block_stream"] == n
    assert torch.equal(got, want)


def _k2_work(dev):
    tables, hot, b = (3000, 500, 7000), (3, 1, 5), 512
    plan = make_stream_plan(tables, 128, b, hot, block_rows=1024)
    hb = ragged_multihot_batch(np.random.default_rng(0), 4, tables, hot, b)
    sw = hb.with_stream_work(plan).to_device(dev).stream
    gen = _gen(dev, 4)
    table = torch.randn((plan.padded_rows, 128), generator=gen, device=dev)
    g_u = torch.randn((plan.u_total, 128), generator=gen, device=dev)
    items = (sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    return plan, table, g_u, items


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(pk.K2_VARIANTS))
def test_k2_bisect_kernel_matches_plain(dev, variant):
    plan, table, g_u, items = _k2_work(dev)
    want = pk.k2_bisect_plain(variant, plan, table.clone(), g_u, *items, 0.05)
    with _counted("k2_bisect"):
        got = pk.k2_bisect(variant, plan, table.clone(), g_u, *items, 0.05)
    if pk.K2_VARIANTS[variant]:
        assert not torch.equal(got, table)
        assert torch.equal(got, want)
        k2 = tk.stream_update("sgd", plan, table.clone(), None, g_u, *items,
                              0.05)[0]
        assert torch.equal(got, k2)  # V1 is K2; the others write its values
    else:
        assert torch.equal(got, table)


def _k2_trouble(dev, case, d, touched):
    """Plans where the tile search can go wrong: 'x128' blocks holding 128
    and 384 hits (the next block's rows follow with no sentinel), a
    hit-free block and a one-hit block; 'sparse' mostly hit-free blocks
    (sentinel-only items, empty tiles); 'skewed' one row with 6,000 hits
    beside a Pareto tail."""
    rng = np.random.default_rng(9)
    if case == "x128":
        block = [0] * 128 + [1] * 384 + [3]
        rows = np.array(block) * 1024 + rng.integers(0, 1024, len(block))
        tables, b, hot = (4096, 2100), len(block), 1
        idx = np.stack([rows, 2048 + rng.integers(0, 52, b)])[:, :, None]
    elif case == "sparse":
        tables, b, hot = (100_000, 40_000), 8, 2
        idx = np.stack([rng.integers(0, n, (b, hot)) for n in tables])
    else:
        tables, b, hot = (5000, 9000), 300, 20
        idx = np.stack([np.minimum(rng.pareto(1.1, (b, hot)) * 3, n - 1)
                        for n in tables])
        idx[0, :, :] = 777  # 6,000 hits on one row
    plan = make_stream_plan(tables, d, b, hot, block_rows=1024)
    work = build_stream_work(plan, idx.astype(np.int32))
    if touched:
        work = touched_update_items(plan, work)
    items = tuple(torch.from_numpy(a).to(dev) for a in (
        work.rows_u, work.item_block, work.item_row0, work.item_u))
    gen = _gen(dev, 10)
    table = torch.randn((plan.padded_rows, d), generator=gen, device=dev)
    g_u = torch.randn((plan.u_total, d), generator=gen, device=dev)
    return plan, table, g_u, items


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["x128", "sparse", "skewed"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
def test_k2_bisect_kernel_trouble_cases(dev, case, d, touched):
    """V1-V6 bit for bit: the full variants against the plain sgd update
    and K2, the skeletons leaving the table unchanged; one launch a call."""
    plan, table, g_u, items = _k2_trouble(dev, case, d, touched)
    want = pk.k2_bisect_plain("V1", plan, table.clone(), g_u, *items, 0.05)
    k2 = tk.stream_update("sgd", plan, table.clone(), None, g_u, *items,
                          0.05)[0]
    assert torch.equal(k2, want) and not torch.equal(want, table)
    for variant, sums in pk.K2_VARIANTS.items():
        with _counted("k2_bisect"):
            got = pk.k2_bisect(variant, plan, table.clone(), g_u, *items,
                               0.05)
        assert torch.equal(got, want if sums else table), variant


@pytest.mark.cuda
def test_k2_bisect_refuses_rows_it_cannot_move(dev):
    """Rows move 16 bytes at a time: a d that is not a multiple of 4, or a
    bulk variant's tile past shared memory, is refused in words."""
    for d, variant, match in ((6, "V1", "multiple of 4"),
                              (pk.K2_BULK_MAX_D + 2, "V6", "at most")):
        plan, table, g_u, items = _k2_trouble(dev, "sparse", d, False)
        with pytest.raises(ValueError, match=match):
            pk.k2_bisect(variant, plan, table, g_u, *items, 0.05)


@pytest.mark.cuda
def test_feasibility_kernels_match_plain(dev):
    gen = _gen(dev, 5)
    a = torch.randn((8, 128, 256), generator=gen, device=dev)
    b = torch.randn((8, 128, 128), generator=gen, device=dev)
    with _counted("t2_contract"):
        got = pk.t2_contract(a, b)
    torch.testing.assert_close(got, pk.t2_contract_plain(a, b), rtol=1e-5,
                               atol=1e-4)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    with _counted("t3_reshape_add"):
        got = pk.t3_reshape_add(x)
    assert torch.equal(got, pk.t3_reshape_add_plain(x))
    idx = torch.from_numpy(np.random.default_rng(5).integers(
        0, 512, (256, 1)).astype(np.int32)).to(dev)
    g = torch.randn((256, 128), generator=gen, device=dev)
    with _counted("t4_onehot_accumulate"):
        got = pk.t4_onehot_accumulate(idx, g, 512)
    want = pk.t4_onehot_accumulate_plain(idx.cpu(), g.cpu(), 512)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    xs = torch.randn((4 * 3 * 256, 128), generator=gen, device=dev)
    with _counted("t6_revolve_accumulate"):
        got = pk.t6_revolve_accumulate(xs, 3, 256)
    assert torch.equal(got, pk.t6_revolve_accumulate_plain(xs, 3, 256))


# T2: R and C not multiples of 4, K = 1, K not a whole number of stages,
# ragged tiles on the float4 path (132 x 36), the reference's shape
T2_SHAPES = [(1, 1, 1, 1), (3, 7, 33, 17), (2, 129, 65, 3),
             (4, 100, 132, 36), (8, 128, 256, 128)]
# chip_smoke.py's T2_SCALE: K 16,384, 1.074 GFLOP
T2_SCALE = (8, 2048, 256, 128)


def _contract_inputs(dev, s, l, r, c, offset, seed):
    """a [s, l, r] and b [s, l, c] on the card, each starting `offset`
    floats into its buffer (offset 1: 4 bytes past a 16-byte boundary)."""
    gen = _gen(dev, seed)
    abuf = torch.randn((s * l * r + offset,), generator=gen, device=dev)
    bbuf = torch.randn((s * l * c + offset,), generator=gen, device=dev)
    return abuf[offset:].view(s, l, r), bbuf[offset:].view(s, l, c)


@pytest.mark.cuda
@pytest.mark.parametrize("s,l,r,c", T2_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_t2_contract_kernel_ragged_and_misaligned(dev, s, l, r, c, offset):
    """Within rtol 1e-5 / atol 1e-4 of the plain version (a cuBLAS product,
    TF32 off) at ragged shapes and at starts that are not 16-byte aligned
    (the 4-byte copies); a second call gives the same bits (the cluster's
    partials are summed in a fixed order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    a, b = _contract_inputs(dev, s, l, r, c, offset, 8)
    with _counted("t2_contract"):
        got = pk.t2_contract(a, b)
    assert got.shape == (r, c)
    torch.testing.assert_close(got, pk.t2_contract_plain(a, b), rtol=1e-5,
                               atol=1e-4)
    with _counted("t2_contract"):
        again = pk.t2_contract(a, b)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
def test_t2_contract_kernel_at_scale_within_fp32_error(dev):
    """At T2_SCALE the kernel's max abs error against an fp64 product is no
    more than twice the fp32 plain version's, plus 1e-5."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s, l, r, c = T2_SCALE
    a, b = _contract_inputs(dev, s, l, r, c, 0, 9)
    with _counted("t2_contract"):
        got = pk.t2_contract(a, b)
    exact = a.double().reshape(-1, r).T @ b.double().reshape(-1, c)
    err = float((got.double() - exact).abs().max())
    plain_err = float((pk.t2_contract_plain(a, b).double() - exact)
                      .abs().max())
    assert err <= 2 * plain_err + 1e-5, (err, plain_err)


# T4: the CPU tests' ragged shapes, every hit on one row, indices outside
# [0, rows), and cap 4,096 into 4,096 rows
T4_CASES = [(1, 1, 1, "spread"), (37, 30, 3, "spread"),
            (256, 512, 128, "spread"), (256, 512, 129, "spread"),
            (256, 30, 128, "one_row"), (37, 1, 129, "one_row"),
            (256, 512, 128, "out_of_range"), (37, 30, 3, "out_of_range"),
            (4096, 4096, 128, "spread")]


def _t4_inputs(cap, rows, d, kind):
    rng = np.random.default_rng(cap * 1009 + rows * 31 + d)
    if kind == "spread":
        idx = rng.integers(0, rows, cap)
    elif kind == "one_row":
        idx = np.full(cap, rows // 2)
    else:  # out_of_range: about a third of the hits in [0, rows)
        idx = rng.integers(-rows - 3, 2 * rows + 3, cap)
        idx[:2] = np.array([-1, rows])[:cap]
    g = rng.normal(size=(cap, d)).astype(np.float32)
    if d > 1:
        g[:, 0] = -0.0  # each row's sum starts from +0.0
    return idx.astype(np.int32).reshape(cap, 1), g


@pytest.mark.cuda
@pytest.mark.parametrize("cap,rows,d,kind", T4_CASES)
@pytest.mark.parametrize("offset", [0, 1])
def test_t4_onehot_accumulate_kernel_matches_plain_on_cpu(dev, cap, rows, d,
                                                          kind, offset):
    """Bit for bit against the plain version run on CPU copies of the
    inputs (both add each row's hits in index order from +0.0 and drop an
    index outside [0, rows)); offset 1: g starts 4 bytes past a 16-byte
    boundary (the scalar instance, as d % 4 != 0 is)."""
    idx, g = _t4_inputs(cap, rows, d, kind)
    gbuf = torch.zeros((cap * d + offset,), device=dev)
    gbuf[offset:] = torch.from_numpy(g.reshape(-1)).to(dev)
    g_dev = gbuf[offset:].view(cap, d)
    with _counted("t4_onehot_accumulate"):
        got = pk.t4_onehot_accumulate(torch.from_numpy(idx).to(dev), g_dev,
                                      rows)
    want = pk.t4_onehot_accumulate_plain(torch.from_numpy(idx),
                                         torch.from_numpy(g), rows)
    assert got.shape == (rows, d)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 5), (1, 1), (1, 3), (7, 129),
                                   (8, 128), (1000, 1001)])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_t3_reshape_add_kernel_ragged_and_misaligned(dev, shape, offset):
    """numel % 4 != 0 and x[offset:] of a contiguous buffer (a start 4,
    8 or 12 bytes past a 16-byte boundary): the scalar head and tail around
    the int4 body; int32 wrap-around at the top of the range."""
    n = shape[0] * shape[1]
    buf = torch.from_numpy(np.random.default_rng(n).integers(
        -2**31, 2**31 - 1, n + offset, dtype=np.int64).astype(np.int32))
    buf[-1] = 2**31 - 1
    x = buf.to(dev)[offset:].view(shape)
    with _counted("t3_reshape_add"):
        got = pk.t3_reshape_add(x)
    assert got.shape == x.shape
    assert torch.equal(got, pk.t3_reshape_add_plain(x))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,steps,br,d", [
    (2, 3, 5, 3), (3, 1, 4, 8), (1, 3, 256, 128), (2, 5, 3, 7),
    (1, 4, 2, 4), (4, 9, 16, 128), (70_000, 1, 1, 4)])
@pytest.mark.parametrize("offset", [0, 1])
def test_t6_revolve_accumulate_kernel_ragged_and_misaligned(
        dev, nb, steps, br, d, offset):
    """Bit for bit against the plain version: blocks of numel % 4 != 0, a
    start that is not 16-byte aligned (the scalar instance), steps 1, 4, 5
    and 9 (past the loads of 4 at a time), more output blocks than the grid's
    y limit (70,000)."""
    n = nb * steps * br * d
    buf = torch.randn((n + offset,), generator=_gen(dev, 6), device=dev)
    buf[:: 7] = -0.0
    x = buf[offset:].view(nb * steps * br, d)
    with _counted("t6_revolve_accumulate"):
        got = pk.t6_revolve_accumulate(x, steps, br)
    assert torch.equal(got, pk.t6_revolve_accumulate_plain(x, steps, br))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["t2_contract", "t3_reshape_add",
                                    "t4_onehot_accumulate",
                                    "t6_revolve_accumulate"])
def test_probe_kernel_launch_is_captured_by_a_cuda_graph(dev, kernel):
    """The wrapper launches on the current stream, which is the capture
    stream inside torch.cuda.graph (a side stream): the replayed graph
    gives the eager call's bits into its own output. Each eager call and
    the capture count one launch; replays count none. T2's is a cluster
    launch (cudaLaunchKernelEx)."""
    if kernel == "t2_contract":
        a, b = _contract_inputs(dev, 8, 128, 256, 128, 0, 7)
        call = lambda: pk.t2_contract(a, b)  # noqa: E731
    elif kernel == "t3_reshape_add":
        x = torch.from_numpy(np.random.default_rng(7).integers(
            0, 1000, (37, 129)).astype(np.int32)).to(dev)
        call = lambda: pk.t3_reshape_add(x)  # noqa: E731
    elif kernel == "t4_onehot_accumulate":
        idx, g = (torch.from_numpy(v).to(dev)
                  for v in _t4_inputs(256, 512, 128, "out_of_range"))
        call = lambda: pk.t4_onehot_accumulate(idx, g, 512)  # noqa: E731
    else:
        x = torch.randn((3 * 5 * 64, 128), generator=_gen(dev, 7), device=dev)
        call = lambda: pk.t6_revolve_accumulate(x, 5, 64)  # noqa: E731
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with _counted(kernel):
            want = call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with _counted(kernel):
        with torch.cuda.graph(graph):
            got = call()
    n = tk.LAUNCHES[kernel]
    got.fill_(0)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert tk.LAUNCHES[kernel] == n
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with _counted(kernel):
        again = call()
    assert torch.equal(again.view(torch.int32), want.view(torch.int32))
