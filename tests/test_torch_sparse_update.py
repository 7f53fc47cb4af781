"""The port's sparse embedding update (dlrm_tpu_torch/ops/sparse_update.py)
against dlrm_tpu/ops/sparse_update.py on the same numpy inputs: the
coalescing (rows, validity and sums), the three appliers, the legacy
(rows, grads) API and per_hit_gradients. Both sides sort the rows and add
each row's hits in hit order from zero, so the coalesced grads are
bit-equal; the appliers are held to the fused-step tests' atol 3e-6 (the
row means of G^2 are reduced in another order). Plus the flat per-hit
layout against the padded one, and row_scatter_add_'s plain version
skipping rows outside the table, as the card kernel does.

A run of more than COALESCE_CHUNK (C) hits is summed in a fixed two-level
order: chunks of C hits in slot order, then the chunks in order. The plain
version equals a numpy loop written out in that order, bit for bit; against
JAX's slot-order segment_sum, runs of up to C hits stay bit-equal and the
longer runs are held to the bound of two recursive fp32 sums."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.ops import sparse_update as js
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import sparse_update as ts


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions run thousands of tiny ops,
    and with several test processes on one machine the threads of each op
    only contend (the bits do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


C = ts.COALESCE_CHUNK


def test_coalesce_chunk_matches_the_kernel_source():
    """COALESCE_CHUNK is the kernel's compile-time kChunk, a power of two."""
    src = os.path.join(os.path.dirname(ts.__file__), os.pardir, "csrc",
                       "coalesce_rows.cu")
    with open(src) as f:
        m = re.search(r"constexpr int kChunk = (\d+);", f.read())
    assert m is not None and int(m.group(1)) == C
    assert C & (C - 1) == 0 and 128 <= C <= 1024


def _two_level(r_s, bag_s, w_s, dly, total_rows):
    """coalesce_rows' contract written out in numpy float32: each run cut
    into chunks of C slots from its head, each chunk summed from zero in
    slot order, the chunk sums added from zero in chunk order."""
    n, d = len(r_s), dly.shape[1]
    G = np.zeros((n, d), np.float32)
    urows = (total_rows + np.arange(n)).astype(np.int32)
    run, k = 0, 0
    while k < n:
        e = k
        while e < n and r_s[e] == r_s[k]:
            e += 1
        urows[run] = r_s[k]
        total = np.zeros(d, np.float32)
        for c0 in range(k, e, C):
            part = np.zeros(d, np.float32)
            for j in range(c0, min(c0 + C, e)):
                t = dly[bag_s[j]]
                part = part + (t if w_s is None else t * w_s[j])
            total = total + part
        G[run] = total
        run, k = run + 1, e
    return G, urows


def _long_runs(length, d, weighted, seed):
    """Sorted hits with short runs around two runs of `length` hits, one
    starting at slot C (a multiple of C) and one at an odd slot; their bag
    rows in a [64, d] dly, and weights."""
    rng = np.random.default_rng(seed)
    rows = np.sort(np.concatenate([
        rng.integers(0, 90, C), np.full(length, 100),
        rng.integers(200, 290, 37), np.full(length, 300),
        rng.integers(400, 490, 50)])).astype(np.int32)
    n = rows.size
    head = np.ones(n, bool)
    head[1:] = rows[1:] != rows[:-1]
    seg = (np.cumsum(head) - 1).astype(np.int32)
    bag = rng.integers(0, 64, n).astype(np.int32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32) if weighted else None
    dly = rng.normal(size=(64, d)).astype(np.float32)
    return rows, seg, bag, w, dly


@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("length", [C - 1, C, C + 1, 2 * C, 3 * C + 17, 5000])
def test_coalesce_rows_plain_two_level_order(length, weighted, d):
    """coalesce_rows_plain equals the two-level order written out in numpy,
    bit for bit; past 2C hits that order is not the slot order's."""
    r_s, seg, bag, w, dly = _long_runs(length, d, weighted, seed=length + d)
    G, urows = ts.coalesce_rows_plain(
        _t(r_s), _t(seg), _t(bag), None if w is None else _t(w), _t(dly),
        500)
    want_G, want_u = _two_level(r_s, bag, w, dly, 500)
    np.testing.assert_array_equal(urows.numpy(), want_u)
    np.testing.assert_array_equal(G.numpy(), want_G)
    if length > 2 * C and d == 128:
        one = r_s == 100
        t = dly[bag[one]] * (1.0 if w is None else w[one][:, None])
        flat = np.zeros(d, np.float32)
        for row in t:
            flat = flat + row
        assert not np.array_equal(G.numpy()[seg[one][0]], flat)


@pytest.mark.parametrize("weights", ["random", "none", "padded"])
def test_coalesce_hits_long_runs_against_jax(weights):
    """A 2-row table takes ~1,000 hits a row, past C; the others' runs stay
    short. Runs of up to C hits are bit-equal to JAX's segment_sum; each
    element of a longer run of L hits is within (L - 1) * 2^-23 * sum|t_j|
    of it: two recursive fp32 sums of the same L terms t_j, each within
    (L - 1) * 2^-24 * sum|t_j| of the exact sum, in whatever order."""
    rng = np.random.default_rng(13)
    sizes, b, h, d = (2, 40, 1000), 400, 5, 16
    offs = np.array([0, 2, 42], np.int32)
    idx = np.stack([rng.integers(0, n, (b, h)) for n in sizes]
                   ).astype(np.int32)
    wt = None
    if weights == "random":
        wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    elif weights == "padded":
        wt = np.ones(idx.shape, np.float32)
        wt[:, :, 3:] = 0.0
    dp = rng.normal(size=(b, len(sizes), d)).astype(np.float32)
    ju, jg, jv = js.coalesce_hits(
        jnp.asarray(dp), jnp.asarray(idx),
        None if wt is None else jnp.asarray(wt), jnp.asarray(offs),
        sum(sizes))
    tu, tg, tv = ts.coalesce_hits(_t(dp), _t(idx),
                                  None if wt is None else _t(wt), _t(offs),
                                  sum(sizes))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # per touched row: its hit count L and sum |t_j| per column
    rows = (idx + offs[:, None, None]).reshape(len(sizes), -1)
    w = np.ones(idx.shape, np.float32) if wt is None else wt
    t = (dp.transpose(1, 0, 2)[:, :, None, :] * w[..., None]).reshape(
        len(sizes), -1, d)
    jg, tg = np.asarray(jg), tg.numpy()
    long_runs = 0
    for i, row in enumerate(tu.numpy()[:int(tv.sum())]):
        tbl = int(np.searchsorted(offs, row, side="right")) - 1
        hit = rows[tbl] == row
        L = int(hit.sum())
        if L <= C:
            np.testing.assert_array_equal(tg[i], jg[i])
        else:
            long_runs += 1
            bound = (L - 1) * 2.0**-23 * np.abs(t[tbl][hit]).sum(0)
            assert (np.abs(tg[i] - jg[i]) <= bound).all(), row
    assert long_runs == 2
