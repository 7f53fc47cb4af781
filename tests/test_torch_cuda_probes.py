"""The probes' hand-written CUDA kernels (ops/probe_kernels.py) against
their plain PyTorch versions on the card, at small sizes. Needs a CUDA card
(marked `cuda`, skipped with a reason elsewhere) and imports nothing of JAX,
so on a machine without JAX it runs as
`python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_probes.py`.
chip_smoke.py phase 5 runs the same comparisons at the probes' own sizes.

Bit-identical: row_gather, row_scatter_add_ (one add per element, unique
rows), block_stream (the same two rounded ops), t3_reshape_add, k2_bisect's
skeletons (the table unchanged) and V1 against K2 itself. Against the plain
versions' other sum orders: k2_bisect V1/V2/V5/V6 rtol 1e-5 / atol 1e-6,
t2_contract and t4_onehot_accumulate rtol 1e-5 / atol 1e-4 (the plain
versions are a cuBLAS product and an atomic index_add_), t6 atol 1e-5."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan


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
@pytest.mark.parametrize("walk", ["static", "dynamic"])
@pytest.mark.parametrize("in_place", [False, True], ids=["out", "aliased"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_block_stream_kernel_matches_plain(dev, walk, in_place, depth):
    br, nblk, d = 48, 10, 128
    t = torch.randn((nblk * br, d), generator=_gen(dev, 2), device=dev)
    ib = (torch.from_numpy(np.random.default_rng(2).permutation(nblk)[:7]
                           .astype(np.int32)).to(dev)
          if walk == "dynamic" else None)
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
def test_block_stream_kernel_ragged_static_map(dev):
    t = torch.randn((1000, 128), generator=_gen(dev, 3), device=dev)
    kw = dict(scale=2.0, shift=-1.0, block_rows=96)
    want = pk.block_stream_plain(t, out=torch.empty_like(t), **kw)
    with _counted("block_stream"):
        got = pk.block_stream(t, out=torch.empty_like(t), **kw)
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
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        k2 = tk.stream_update("sgd", plan, table.clone(), None, g_u, *items,
                              0.05)[0]
        assert torch.equal(got, k2)  # V1 is K2; the others write its values
    else:
        assert torch.equal(got, table)


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
    torch.testing.assert_close(got, pk.t4_onehot_accumulate_plain(idx, g, 512),
                               rtol=1e-5, atol=1e-4)
    xs = torch.randn((4 * 3 * 256, 128), generator=gen, device=dev)
    with _counted("t6_revolve_accumulate"):
        got = pk.t6_revolve_accumulate(xs, 3, 256)
    torch.testing.assert_close(got, pk.t6_revolve_accumulate_plain(xs, 3, 256),
                               rtol=0, atol=1e-5)
