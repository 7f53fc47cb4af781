"""GspmdDLRM's training half on a CUDA card (marker `cuda`; needs no JAX,
so it runs on the card's machine with `python3 -m pytest --noconftest -m
cuda`): chip_smoke.py phase 13's check at a small size. Two ranks share
the card over gloo, each collective staged through host memory (NCCL
refuses two ranks on one card), and train plain, QR and learned-v_w models
3 rwsadagrad steps from an init drawn on the card; their unsharded params
are held to the same 3 steps of train/step.py's dense step on the card,
each global batch taken in the ranks' two slices
(make_grad_accum_train_step: the tower's products in the ranks' shapes,
which cuBLAS rounds as it rounds the ranks'): losses rtol 1e-5, tables
(QR's q and r, v_w) rtol 1e-5 / atol 1e-6, dense params rtol 1e-4 / atol
1e-5 (the elements whose accumulator stays below 1e-12, rounding-level
grads that element-wise Adagrad divides by themselves, held to |dw| <=
steps * lr), every padded row 0. Skips with a reason where there is no
card."""

import numpy as np
import pytest
import torch

from dlrm_tpu_torch.config import DLRMConfig, QRConfig
from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.data.random_data import ragged_multihot_batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import (
    init_opt_state,
    tree_map,
    tree_map_with_path,
)
from dlrm_tpu_torch.parallel.launch import run_ranks

B = 64
LR = 0.05
STEPS = 3
TABLES = (3001, 640, 2500, 170, 1300, 77)
HOTS = (3, 2, 1, 2, 4, 1)
KW = dict(embedding_dim=16, table_sizes=TABLES, mlp_bot=(8, 16, 16),
          mlp_top=(32, 16, 1), interaction="dot", loss="bce",
          num_indices_per_lookup=max(HOTS))
VARIANTS = {"plain": {}, "qr": {"qr": QRConfig(collisions=4, threshold=0)},
            "v_w": {"weighted_pooling": "learned"}}


def _model(variant):
    return DLRMModel(DLRMConfig(**KW, **VARIANTS[variant]))


def _batches(model, device):
    hots = HOTS if model.fused else None
    rng = np.random.default_rng(0)
    return [ragged_multihot_batch(rng, 8, TABLES, HOTS, B)
            .to_device(device, flat_hots=hots) for _ in range(STEPS)]


def _slices(batch):
    """The global batch as the two ranks' slices, stacked on a leading
    axis."""
    from dlrm_tpu_torch.parallel.gspmd import batch_slice

    parts = [batch_slice(batch, m, 2, HOTS) for m in range(2)]
    return Batch(*(torch.stack(f) for f in zip(*(p[:4] for p in parts))))


def _flat(tree):
    out = []
    tree_map_with_path(lambda path, x: out.append((path, x)), tree)
    return out


def _rank(rank):
    """Both ranks on cuda:0: each variant's losses, unsharded params and
    whether its padded rows stayed 0."""
    from dlrm_tpu_torch.parallel.gspmd import GspmdDLRM, _is_row_shardable
    from dlrm_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, model=2, stage=True)
    out = {}
    for variant in VARIANTS:
        model = _model(variant)
        runner = GspmdDLRM(model, mesh, device=dev, hot_sizes=HOTS)
        params = model.init_params(seed=0, device=dev)
        sp = runner.shard_params(params)
        st = runner.shard_opt_state(init_opt_state("rwsadagrad", params))
        step = runner.make_train_step("rwsadagrad")
        losses = []
        for b in _batches(model, "cpu"):
            sp, st, loss, _ = step(sp, st, runner.shard_batch(b), LR)
            losses.append(float(loss))
        zero = all(
            bool((leaf[max(0, t.shape[0] - mesh.m * leaf.shape[0]):] == 0)
                 .all())
            for (path, leaf), (_, t) in zip(_flat(sp), _flat(params))
            if _is_row_shardable(path, leaf))
        out[variant] = (losses, zero, tree_map(
            lambda t: t.numpy(), runner.unshard_params(sp, params)))
    return out


@pytest.mark.cuda
def test_cuda_gspmd_two_ranks_on_one_card_match_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable
    from dlrm_tpu_torch.train.step import make_grad_accum_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = run_ranks(_rank, 2)
    dev = torch.device("cuda", 0)
    for variant in VARIANTS:
        model = _model(variant)
        params = model.init_params(seed=0, device=dev)
        state = init_opt_state("rwsadagrad", params)
        step = make_grad_accum_train_step(model, "rwsadagrad", 2,
                                          hot_sizes=HOTS)
        losses = []
        for b in _batches(model, dev):
            params, state, loss, _ = step(params, state,
                                          _slices(b), LR)
            losses.append(float(loss))
        accs = dict(_flat(state["accum"]))
        for r, out in enumerate(ranks):
            got_losses, zero, got = out[variant]
            what = f"{variant} rank {r}"
            assert zero, f"{what}: a padded row moved"
            np.testing.assert_allclose(got_losses, losses, rtol=1e-5,
                                       err_msg=what)
            for (path, x), (_, y) in zip(_flat(got), _flat(params)):
                y = y.cpu().numpy()
                name = f"{what} {path}"
                if _is_row_shardable(path, y):
                    np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6,
                                               err_msg=name)
                    continue
                noise = accs[path].cpu().numpy() < 1e-12
                np.testing.assert_allclose(x[~noise], y[~noise], rtol=1e-4,
                                           atol=1e-5, err_msg=name)
                assert (np.abs(x - y)[noise] <= STEPS * LR).all(), name
