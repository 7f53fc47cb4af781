"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Needs a CUDA card (marked `cuda`, skipped with a reason
elsewhere) and imports nothing of JAX, so on a machine without JAX it runs
as `python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py`
(tests/conftest.py configures JAX). chip_smoke.py runs the same comparison
at larger shapes.

K1, K2 and K3 compute the same products, sums and copies in the same order
as their plain versions, so they must agree to the bit. K4 adds with atomics
in a run-dependent order: rtol 1e-5 / atol 1e-6."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.ops.stream_plan import make_stream_plan

TABLES = (3000, 500, 7000)
HOT = (3, 1, 5)
D = 128
B = 512


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("table_dtype,sr", [("float32", False),
                                            ("bfloat16", False),
                                            ("bfloat16", True)])
@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
def test_stream_update_kernel_matches_plain(dev, optimizer, table_dtype, sr,
                                            touched):
    rng = np.random.default_rng(0)
    plan = make_stream_plan(TABLES, D, B, HOT, block_rows=1024)
    hb = ragged_multihot_batch(rng, 4, TABLES, HOT, B).with_stream_work(
        plan, update_touched_only=touched)
    sw = hb.to_device(dev).stream
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    dly = torch.randn((len(TABLES), B, D), generator=gen, device=dev)
    g_u = tk.gather_grads(dly, sw.vals_u, sw.wts_u, sw.w2t)
    tdt = getattr(torch, table_dtype)
    base = (torch.randn((plan.padded_rows, D), generator=gen, device=dev)
            * 0.05).to(tdt)
    acc = None
    if optimizer == "rwsadagrad":
        acc = torch.rand((plan.acc_rows, 128), generator=gen, device=dev)
    elif optimizer == "adagrad":
        acc = torch.rand((plan.padded_rows, D), generator=gen, device=dev)
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
def test_window_grads_kernel_matches_plain(dev, dly_dtype, mm, weights):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    # the [B, T, d] cotangent's transposed view, as the train step passes it
    dly = torch.randn((B, len(TABLES), D), generator=gen, device=dev).to(
        getattr(torch, dly_dtype)).transpose(0, 1)
    args = (dly, sw.vals_u, _wts(sw, weights), sw.w2t)
    launches = tk.LAUNCHES["window_grads"]
    got = tk.window_grads(*args, mm_dtype=getattr(torch, mm))
    want = tk.window_grads_plain(*args, mm_dtype=getattr(torch, mm))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["window_grads"] == launches + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
def test_stream_rows_kernel_matches_plain(dev, table_dtype, mm):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    table = torch.randn((plan.padded_rows, D), generator=gen,
                        device=dev).to(getattr(torch, table_dtype))
    args = (plan, table, sw.rows_u, sw.item_block, sw.item_row0, sw.item_u)
    launches = tk.LAUNCHES["stream_rows"]
    got = tk.stream_rows(*args, mm_dtype=getattr(torch, mm))
    want = tk.stream_rows_plain(*args, mm_dtype=getattr(torch, mm))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["stream_rows"] == launches + 1
    assert not bool(torch.isnan(want).any())  # every slot written
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mm", ["float32", "bfloat16"])
@pytest.mark.parametrize("weights", ["unit", "random"])
def test_window_pool_kernel_matches_plain(dev, mm, weights):
    plan, sw = _work(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    r_u = torch.randn((plan.u_total, D), generator=gen, device=dev)
    r_u[(sw.rows_u == -1).reshape(-1)] = 0  # as K3 writes the sentinels
    args = (plan, r_u, sw.vals_u, _wts(sw, weights), sw.w2t)
    launches = tk.LAUNCHES["window_pool"]
    got = tk.window_pool(*args, mm_dtype=getattr(torch, mm))
    want = tk.window_pool_plain(*args, mm_dtype=getattr(torch, mm))
    torch.cuda.synchronize()
    assert tk.LAUNCHES["window_pool"] == launches + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
