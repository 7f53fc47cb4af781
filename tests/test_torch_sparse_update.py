"""The port's sparse embedding update (dlrm_tpu_torch/ops/sparse_update.py)
against dlrm_tpu/ops/sparse_update.py on the same numpy inputs: the
coalescing (rows, validity and sums), the three appliers, the legacy
(rows, grads) API and per_hit_gradients. Both sides sort the rows and add
each row's hits in hit order from zero, so the coalesced grads are
bit-equal; the appliers are held to the fused-step tests' atol 3e-6 (the
row means of G^2 are reduced in another order). Plus the flat per-hit
layout against the padded one, and row_scatter_add_'s plain version
skipping rows outside the table, as the card kernel does."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.ops import sparse_update as js
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import sparse_update as ts

SIZES = (40, 7, 100)  # the tiny table guarantees duplicate hits
OFFS = np.concatenate([[0], np.cumsum(SIZES)[:-1]]).astype(np.int32)
TOTAL = sum(SIZES)
B, H, D = 12, 5, 8
APPLY = dict(atol=3e-6, rtol=0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed, weights="random", heavy=False):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, (B, H)) for n in SIZES]
                   ).astype(np.int32)
    if heavy:
        idx %= 2  # every hit on two rows per table
    wt = None
    if weights == "random":
        wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    elif weights == "padded":  # ragged bags: weight-0 padding columns
        wt = np.ones(idx.shape, np.float32)
        wt[:, :, 3:] = 0.0
    dp = rng.normal(size=(B, len(SIZES), D)).astype(np.float32)
    return dp, idx, wt


def _port_coalesce(dp, idx, wt):
    return ts.coalesce_hits(_t(dp), _t(idx), None if wt is None else _t(wt),
                            _t(OFFS), TOTAL)


def _jax_coalesce(dp, idx, wt):
    return js.coalesce_hits(jnp.asarray(dp), jnp.asarray(idx),
                            None if wt is None else jnp.asarray(wt),
                            jnp.asarray(OFFS), TOTAL)


@pytest.mark.parametrize("weights", ["random", "none", "padded"])
@pytest.mark.parametrize("heavy", [False, True], ids=["spread", "heavy"])
def test_coalesce_hits_matches_jax(weights, heavy):
    dp, idx, wt = _case(1, weights, heavy)
    ju, jg, jv = _jax_coalesce(dp, idx, wt)
    tu, tg, tv = _port_coalesce(dp, idx, wt)
    assert tu.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    n_seg = int(tv.sum())
    # unique ascending rows, then distinct rows past the table, zero grads
    assert (np.diff(tu.numpy()) > 0).all()
    assert (tu[n_seg:].numpy() == TOTAL + np.arange(n_seg, tu.numel())).all()
    assert not tg[n_seg:].any()
    if heavy:
        assert n_seg == 2 * len(SIZES)


def test_coalesce_matches_jax():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 9, 50).astype(np.int32)
    grads = rng.normal(size=(50, D)).astype(np.float32)
    out_j = js.coalesce(jnp.asarray(rows), jnp.asarray(grads), 9)
    out_t = ts.coalesce(_t(rows), _t(grads), 9)
    for t, j in zip(out_t, out_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_per_hit_gradients_matches_jax():
    dp, idx, wt = _case(3)
    jr, jg = js.per_hit_gradients(jnp.asarray(dp), jnp.asarray(idx),
                                  jnp.asarray(wt), jnp.asarray(OFFS))
    tr, tg = ts.per_hit_gradients(_t(dp), _t(idx), _t(wt), _t(OFFS))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))


def _state(seed, optimizer):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(TOTAL, D)).astype(np.float32)
    acc = {"sgd": None,
           "rwsadagrad": rng.random(TOTAL).astype(np.float32),
           "adagrad": rng.random((TOTAL, D)).astype(np.float32)}[optimizer]
    return table, acc


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("heavy", [False, True], ids=["spread", "heavy"])
def test_appliers_match_jax(optimizer, heavy):
    """Each applier on the coalesced triple, in place on the port's side;
    rows outside the batch keep their bits."""
    dp, idx, wt = _case(4, heavy=heavy)
    table, acc = _state(5, optimizer)
    ju, jg, jv = _jax_coalesce(dp, idx, wt)
    tu, tg, tv = _port_coalesce(dp, idx, wt)
    tt = _t(table)
    if optimizer == "sgd":
        jt = js.sgd_from_coalesced(jnp.asarray(table), ju, jg, jv, 0.1)
        assert ts.sgd_from_coalesced(tt, tu, tg, tv, 0.1) is tt
    else:
        fj = {"rwsadagrad": js.rowwise_adagrad_from_coalesced,
              "adagrad": js.adagrad_from_coalesced}[optimizer]
        ft = {"rwsadagrad": ts.rowwise_adagrad_from_coalesced,
              "adagrad": ts.adagrad_from_coalesced}[optimizer]
        ta = _t(acc)
        jt, ja = fj(jnp.asarray(table), jnp.asarray(acc), ju, jg, jv, 0.1,
                    eps=1e-8)
        out = ft(tt, ta, tu, tg, tv, 0.1, eps=1e-8)
        assert out[0] is tt and out[1] is ta
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **APPLY)
        untouched = np.setdiff1d(np.arange(TOTAL), tu[tv].numpy())
        np.testing.assert_array_equal(ta.numpy()[untouched], acc[untouched])
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **APPLY)
    untouched = np.setdiff1d(np.arange(TOTAL), tu[tv].numpy())
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])


def test_rowwise_row_sq_override_matches_jax():
    dp, idx, wt = _case(6)
    table, acc = _state(7, "rwsadagrad")
    ju, jg, jv = _jax_coalesce(dp, idx, wt)
    tu, tg, tv = _port_coalesce(dp, idx, wt)
    row_sq = np.abs(np.random.default_rng(8).normal(size=tu.numel())
                    ).astype(np.float32)
    jt, ja = js.rowwise_adagrad_from_coalesced(
        jnp.asarray(table), jnp.asarray(acc), ju, jg, jv, 0.1,
        row_sq=jnp.asarray(row_sq))
    tt, ta = ts.rowwise_adagrad_from_coalesced(
        _t(table), _t(acc), tu, tg, tv, 0.1, row_sq=_t(row_sq))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **APPLY)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **APPLY)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_legacy_apply_sparse_matches_jax(optimizer):
    """apply_sparse_* on materialized (rows, grads) with repeated rows."""
    rng = np.random.default_rng(9)
    rows = rng.integers(0, 20, 60).astype(np.int32)
    grads = rng.normal(size=(60, D)).astype(np.float32)
    table, acc = _state(10, optimizer)
    table, acc = table[:20], None if acc is None else acc[:20]
    if optimizer == "sgd":
        jt = js.apply_sparse_sgd(jnp.asarray(table), jnp.asarray(rows),
                                 jnp.asarray(grads), 0.05)
        tt = ts.apply_sparse_sgd(_t(table), _t(rows), _t(grads), 0.05)
    else:
        fj = {"rwsadagrad": js.apply_sparse_rowwise_adagrad,
              "adagrad": js.apply_sparse_adagrad}[optimizer]
        ft = {"rwsadagrad": ts.apply_sparse_rowwise_adagrad,
              "adagrad": ts.apply_sparse_adagrad}[optimizer]
        jt, ja = fj(jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
                    jnp.asarray(grads), 0.05)
        tt, ta = ft(_t(table), _t(acc), _t(rows), _t(grads), 0.05)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **APPLY)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **APPLY)


def test_flat_layout_coalesces_as_padded():
    """The flat per-hit layout of ragged bags gives the padded layout's
    table update bit for bit: the padding adds weight-0 terms only, and
    its rows' updates are exact no-ops."""
    hots = (3, 1, 5)
    dp, idx, wt = _case(11)
    for t, h in enumerate(hots):
        wt[t, :, h:] = 0.0
    flat_idx = np.concatenate([idx[t, :, :h].ravel()
                               for t, h in enumerate(hots)])
    flat_wt = np.concatenate([wt[t, :, :h].ravel()
                              for t, h in enumerate(hots)])
    outs = []
    for i, w in ((idx, wt), (flat_idx, flat_wt)):
        table, acc = _state(12, "rwsadagrad")
        tt, ta = _t(table), _t(acc)
        urows, G, valid = ts.coalesce_hits(
            _t(dp), _t(i), _t(w), _t(OFFS), TOTAL,
            hot_sizes=hots if i.ndim == 1 else None)
        ts.rowwise_adagrad_from_coalesced(tt, ta, urows, G, valid, 0.1)
        outs.append((tt, ta))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_coalesce_rows_plain_contract():
    """The kernel's contract on the CPU: each run summed in slot order from
    zero (the last bit of a three-term sum depends on the order), the slots
    past the last run zero with rows past the table."""
    r_s = torch.tensor([2, 2, 2, 5, 9, 9], dtype=torch.int32)
    seg = torch.tensor([0, 0, 0, 1, 2, 2], dtype=torch.int32)
    bag = torch.tensor([0, 1, 2, 3, 1, 0], dtype=torch.int32)
    w = torch.tensor([1.0, 1.0, 1.0, 2.0, 0.5, 1.0])
    dly = torch.tensor([[1e8, 1.0, 0.0, 4.0], [1.0, 2.0, 0.0, 4.0],
                        [-1e8, 3.0, 0.0, 4.0], [0.5, 0.0, -1.0, 4.0]])
    G, urows = ts.coalesce_rows(r_s, seg, bag, w, dly, 100)
    assert urows.tolist() == [2, 5, 9, 103, 104, 105]
    # (1e8 + 1) + -1e8 = 0 in fp32 (1e8 + 1 rounds to 1e8)
    assert G[0].tolist() == [0.0, 6.0, 0.0, 12.0]
    assert G[1].tolist() == [1.0, 0.0, -2.0, 8.0]
    assert G[2].tolist() == [1e8, 2.0, 0.0, 6.0]  # 1e8 + 0.5 rounds to 1e8
    assert not G[3:].any()


def test_row_scatter_add_plain_skips_rows_outside_the_table():
    """row_scatter_add_'s plain version skips indices outside [0, rows),
    as the card kernel does (csrc/probe_rows.cu) and JAX's FILL_OR_DROP
    scatter (dlrm_tpu/ops/sparse_update.py) does."""
    table = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([4, 6, 1, -1, 1000], dtype=torch.int32)
    delta = torch.ones((5, 4))
    want = table.clone()
    want[4] += 1
    want[1] += 1
    got = pk.row_scatter_add_(table, idx, delta)
    assert got is table
    assert torch.equal(table, want)
    # JAX wraps a negative index before dropping: hold the rows past the
    # table only (the fused step's urows are never negative)
    keep = [0, 1, 2, 4]
    jt = jnp.asarray(np.arange(24, dtype=np.float32).reshape(6, 4)).at[
        jnp.asarray(idx.numpy()[keep])].add(jnp.ones((4, 4)), mode="drop")
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
