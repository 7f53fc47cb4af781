"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Needs a CUDA card (marked `cuda`, skipped with a reason
elsewhere) and imports nothing of JAX, so on a machine without JAX it runs
as `python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py`
(tests/conftest.py configures JAX). chip_smoke.py runs the same comparison
at larger shapes.

The kernel and the plain version add each row's hits in the same order,
so they must agree to the bit."""

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
