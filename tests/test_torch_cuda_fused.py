"""The fused step's kernels on the card: coalesce_rows against its plain
version (ops/sparse_update.py), and the fused step's determinism. Needs a
CUDA card (marked `cuda`, skipped with a reason elsewhere) and imports
nothing of JAX, so on a machine without JAX it runs as
`python3 -m pytest --noconftest -m cuda tests/test_torch_cuda_fused.py`.
chip_smoke.py phase 7 runs the same comparisons at the trainer's shapes.

coalesce_rows adds each run's weighted rows in a fixed order with the same
roundings as its plain version (which adds them in rounds, one term per
row at a time, with no conflicting writes): a run of up to COALESCE_CHUNK
(C) hits in slot order, a longer one as chunks of C hits in slot order
added in chunk order. The same bits, on every call, for runs around C and
for runs of 65,275 hits (the longest at the Criteo Kaggle counts) and
262,144."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops import sparse_update as su
from dlrm_tpu_torch.ops import stream_kernels as tk
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.train.fused_step import make_fused_train_step


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _hits(dev, n, rows, d, skew, seed):
    """n hits on `rows` rows (a fraction `skew` of them on row 3), their
    bag rows in a [n // 4, d] dly, and weights."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, n)
    r[rng.random(n) < skew] = 3
    bag = rng.integers(0, n // 4, n)
    w = rng.uniform(0.5, 1.5, n)
    t = lambda a, dt: torch.from_numpy(a.astype(dt)).to(dev)  # noqa: E731
    dly = torch.randn((n // 4, d), device=dev)
    return t(r, np.int32), t(bag, np.int32), t(w, np.float32), dly


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 64, 256, 8])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("skew", [0.0, 0.3])
def test_coalesce_rows_matches_plain(dev, d, weighted, skew):
    rows, bag, w, dly = _hits(dev, 40_000, 9_000, d, skew, seed=d)
    r_s, order = torch.sort(rows, stable=True)
    head = torch.ones_like(r_s)
    head[1:] = (r_s[1:] != r_s[:-1]).int()
    seg = torch.cumsum(head, 0, dtype=torch.int32) - 1
    bag_s = bag[order].contiguous()
    w_s = w[order].contiguous() if weighted else None
    n0 = tk.LAUNCHES["coalesce_rows"]
    g1, u1 = su.coalesce_rows(r_s, seg, bag_s, w_s, dly, 9_000)
    g2, u2 = su.coalesce_rows(r_s, seg, bag_s, w_s, dly, 9_000)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["coalesce_rows"] == n0 + 2
    gp, up = su.coalesce_rows_plain(r_s, seg, bag_s, w_s, dly, 9_000)
    assert torch.equal(u1, up) and torch.equal(u1, u2)
    assert torch.equal(g1, gp) and torch.equal(g1, g2)


C = su.COALESCE_CHUNK


def _long_runs(dev, lengths, d, weighted, seed):
    """Sorted hits (r_s, seg, bag_s, w_s) and a [4096, d] dly: before each
    run of lengths[i] hits, short runs of C hits in all (so the first long
    run starts at slot C) or 37 hits (an odd start)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, length in enumerate(lengths):
        parts.append(rng.integers(1000 * i, 1000 * i + 90, 37 if i else C))
        parts.append(np.full(length, 1000 * i + 500))
    r = np.sort(np.concatenate(parts)).astype(np.int32)
    n = r.size
    head = np.ones(n, bool)
    head[1:] = r[1:] != r[:-1]
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    seg = (np.cumsum(head) - 1).astype(np.int32)
    bag = rng.integers(0, 4096, n).astype(np.int32)
    w = (t(rng.uniform(0.5, 1.5, n).astype(np.float32)) if weighted
         else None)
    dly = torch.from_numpy(rng.normal(size=(4096, d)).astype(np.float32))
    return t(r), t(seg), t(bag), w, dly.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 128, 256, 512])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("lengths", [
    (C - 1, C - 1), (C, C), (C + 1, C + 1), (3 * C + 17, 3 * C + 17),
    (65_275,), (262_144,)], ids=lambda v: f"runs{v[0]}x{len(v)}")
def test_coalesce_rows_long_runs_match_plain(dev, lengths, weighted, d):
    r_s, seg, bag_s, w_s, dly = _long_runs(dev, lengths, d, weighted,
                                           seed=lengths[0] + d)
    total = 1000 * len(lengths)
    n0 = tk.LAUNCHES["coalesce_rows"]
    g1, u1 = su.coalesce_rows(r_s, seg, bag_s, w_s, dly, total)
    g2, u2 = su.coalesce_rows(r_s, seg, bag_s, w_s, dly, total)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["coalesce_rows"] == n0 + 2
    gp, up = su.coalesce_rows_plain(r_s, seg, bag_s, w_s, dly, total)
    assert torch.equal(u1, up) and torch.equal(u1, u2)
    assert torch.equal(g1, gp) and torch.equal(g1, g2)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_fused_step_same_bits_on_every_run(dev, optimizer):
    """Two fused steps from the same state on the same flat batch give the
    same bits: the coalescing adds in slot order, the table update writes
    each row once, the accumulators add +0 to the invalid slots' row."""
    cfg = DLRMConfig(embedding_dim=128, table_sizes=(7, 3000, 50_000),
                     mlp_bot=(13, 64, 128), mlp_top=(64, 1), loss="bce",
                     interaction="dcn", compute_dtype="bfloat16",
                     num_indices_per_lookup=20,
                     dcn=DCNConfig(2, 32))
    model = DLRMModel(cfg)
    hots = (1, 5, 20)
    rng = np.random.default_rng(0)
    b = 2048
    idx = np.stack([rng.integers(0, n, (b, 20)) for n in cfg.table_sizes]
                   ).astype(np.int32)
    hb = HostBatch(rng.random((b, 13), dtype=np.float32), idx,
                   np.ones(idx.shape, np.float32),
                   (rng.random((b, 1)) < 0.5).astype(np.float32))
    batch = hb.to_device(dev, flat_hots=hots)
    outs = []
    for _ in range(2):
        p = model.init_params(seed=1, device=dev)
        s = init_opt_state(optimizer, p)
        n0 = tk.LAUNCHES["row_scatter_add"]
        make_fused_train_step(model, optimizer, hot_sizes=hots)(
            p, s, batch, 0.05)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["row_scatter_add"] == n0 + 1
        outs.append((p, s))
    flat = [torch.utils._pytree.tree_leaves(o) for o in outs]
    for a, c in zip(*flat):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, c)
