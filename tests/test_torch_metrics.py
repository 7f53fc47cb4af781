"""The port's metrics (dlrm_tpu_torch/ops/metrics.py) against the JAX
package's on seeded scores: ties, label -1 pad rows and single-class sets
(nan) included. Counts must be equal (tolerance 0), floats within 1e-12;
auc_update_torch equals auc_update exactly, and auc_update_jax exactly at
power-of-two bucket counts (the default), where its float32 buckets are
the float64 ones."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.ops import metrics as jm
from dlrm_tpu_torch.ops import metrics as tm

FLOAT = dict(rtol=0, atol=1e-12)


def _case(name):
    """(scores float32, labels float32) for each kind of set."""
    rng = np.random.default_rng(7)
    n = 2000
    s = rng.random(n).astype(np.float32)
    lbl = (rng.random(n) < 0.3).astype(np.float32)
    if name == "ties":  # scores on a grid of 20 values: many tied groups
        s = np.round(s * 20) / 20
    elif name == "pad":  # the last 300 rows are padding (label -1)
        lbl[-300:] = -1.0
    elif name == "one class":
        lbl[:] = 1.0
    elif name == "no positive":
        lbl[:] = 0.0
    elif name == "edges":  # scores at and beyond [0, 1]
        s[:10] = [0.0, 1.0, -0.5, 1.5, 0.5, 0.25, 1 - 1e-7, 1e-8, 0.75, 1.0]
    return s, lbl


CASES = ["random", "ties", "pad", "one class", "no positive", "edges"]


def _close(a, b):
    if math.isnan(b):
        assert math.isnan(a)
    else:
        np.testing.assert_allclose(a, b, **FLOAT)


@pytest.mark.parametrize("case", CASES)
def test_exact_metrics_equal(case):
    s, lbl = _case(case)
    _close(tm.roc_auc_exact(s, lbl), jm.roc_auc_exact(s, lbl))
    _close(tm.average_precision(s, lbl), jm.average_precision(s, lbl))
    for thr in (0.5, 0.3):
        t, j = tm.binary_metrics(s, lbl, thr), jm.binary_metrics(s, lbl, thr)
        assert t.keys() == j.keys()
        for k in j:
            _close(t[k], j[k])
    if case in ("one class", "no positive"):
        assert math.isnan(tm.roc_auc_exact(s, lbl))


@pytest.mark.parametrize("case", CASES)
def test_histogram_metrics_equal(case):
    s, lbl = _case(case)
    w = np.random.default_rng(8).uniform(0.5, 2.0, s.size)
    for weights in (None, w):
        t = tm.auc_update(tm.AucState.create(), s, lbl, weights)
        j = jm.auc_update(jm.AucState.create(), s, lbl, weights)
        if weights is None:  # counts
            np.testing.assert_array_equal(t.pos, j.pos)
            np.testing.assert_array_equal(t.neg, j.neg)
        else:
            np.testing.assert_allclose(t.pos, j.pos, **FLOAT)
            np.testing.assert_allclose(t.neg, j.neg, **FLOAT)
        _close(tm.auc_compute(t), jm.auc_compute(j))
        for thr in (0.5, 0.3):
            a = tm.binary_metrics_from_hist(t, thr)
            b = jm.binary_metrics_from_hist(j, thr)
            assert a.keys() == b.keys()
            for k in b:
                _close(a[k], b[k])
    # merge adds the states, as JAX's does
    t2 = tm.AucState.create(64).merge(tm.auc_update(tm.AucState.create(64),
                                                    s, lbl))
    j2 = jm.AucState.create(64).merge(jm.auc_update(jm.AucState.create(64),
                                                    s, lbl))
    np.testing.assert_array_equal(t2.pos, j2.pos)
    np.testing.assert_array_equal(t2.neg, j2.neg)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("num_buckets", [1 << 14, 100])
def test_auc_update_torch_equals_numpy_and_jax(case, num_buckets):
    s, lbl = _case(case)
    state = tm.auc_update(tm.AucState.create(num_buckets), s, lbl)
    # twice, in two batches: the update accumulates into its inputs' counts
    pos = torch.zeros(num_buckets, dtype=torch.float64)
    neg = torch.zeros(num_buckets, dtype=torch.float64)
    half = s.size // 2
    for sl in (slice(0, half), slice(half, None)):
        pos, neg = tm.auc_update_torch(pos, neg, torch.from_numpy(s[sl]),
                                       torch.from_numpy(lbl[sl]).view(-1, 1))
    np.testing.assert_array_equal(pos.numpy(), state.pos)
    np.testing.assert_array_equal(neg.numpy(), state.neg)
    if num_buckets & (num_buckets - 1):
        return  # auc_update_jax buckets in float32: equal for powers of two
    jp, jn = jm.auc_update_jax(jnp.zeros(num_buckets), jnp.zeros(num_buckets),
                               jnp.asarray(s), jnp.asarray(lbl))
    p32, n32 = tm.auc_update_torch(torch.zeros(num_buckets),
                                   torch.zeros(num_buckets),
                                   torch.from_numpy(s), torch.from_numpy(lbl))
    assert p32.dtype == torch.float32
    np.testing.assert_array_equal(p32.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(n32.numpy(), np.asarray(jn))


def test_allreduce_auc_state(monkeypatch):
    s, lbl = _case("random")
    st = tm.auc_update(tm.AucState.create(), s, lbl)
    assert tm.allreduce_auc_state(st) is st  # one process: the input
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        tm.allreduce_auc_state(st)
