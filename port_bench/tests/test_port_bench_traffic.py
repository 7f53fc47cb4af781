"""The traffic generator: the same seed gives the same pool, every seed
the same sizes, and the draws follow the mix's distribution."""

import numpy as np
import pytest

from port_bench.generators import multihot

SIZES = [40_000_000, 7, 1000, 3]
HOT = [3, 1, 100, 2]
UNIFORM = {"batch": 4096, "pool": 2, "hot_dist": "uniform",
           "click_rate": 0.25}
PARETO = dict(UNIFORM, hot_dist="pareto", pareto_a=0.25)


@pytest.mark.parametrize("mix", [UNIFORM, PARETO], ids=["uniform", "pareto"])
@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_same_seed_same_pool_and_fixed_sizes(mix, seed):
    a = multihot.pool(mix, SIZES, HOT, 13, seed)
    b = multihot.pool(mix, SIZES, HOT, 13, seed)
    c = multihot.pool(mix, SIZES, HOT, 13, seed + 1)
    assert len(a) == mix["pool"]
    for x, y, z in zip(a, b, c):
        assert x["idx"].shape == (4096, sum(HOT))
        assert x["idx"].dtype == np.int32
        assert x["dense"].shape == (4096, 13)
        assert x["dense"].dtype == np.float32
        assert x["labels"].shape == (4096, 1)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
            assert x[k].shape == z[k].shape
        assert not np.array_equal(x["idx"], z["idx"])
    # the batches of one pool differ
    assert not np.array_equal(a[0]["idx"], a[1]["idx"])


def _table(batch, t):
    c0 = np.concatenate([[0], np.cumsum(HOT)[:-1]])
    return batch["idx"][:, c0[t]: c0[t] + HOT[t]]


def test_uniform_hits_cover_each_table_evenly():
    batch = multihot.pool(UNIFORM, SIZES, HOT, 13, 5)[0]
    for t, n in enumerate(SIZES):
        x = _table(batch, t)
        assert x.min() >= 0 and x.max() < n
    big = _table(batch, 0).astype(np.float64) / SIZES[0]
    assert abs(big.mean() - 0.5) < 0.01
    counts = np.bincount(_table(batch, 2).ravel(), minlength=1000)
    # 409,600 hits over 1,000 rows: each row about 410 +- 20
    assert counts.min() > 300 and counts.max() < 530
    assert abs(batch["labels"].mean() - 0.25) < 0.03


def test_pareto_extra_hits_pile_on_row_zero():
    batch = multihot.pool(PARETO, SIZES, HOT, 13, 7)[0]
    t = 2  # 100 hot over 1,000 rows
    x = _table(batch, t)
    assert x.min() >= 0 and x.max() < SIZES[t]
    # first hit uniform; the extra hits int(Pareto(0.25)) % rows: row 0
    # takes P(X < 1) = 1 - 2 ** -0.25 of them, plus the wrapped draws
    extra = x[:, 1:].ravel()
    share = np.mean(extra == 0)
    assert 1 - 2 ** -0.25 - 0.01 < share < 1 - 2 ** -0.25 + 0.02
    assert np.mean(x[:, 0] == 0) < 0.01
    # a table with hot 1 is uniform
    assert np.mean(_table(batch, 1) == 0) < 0.2


def test_unknown_distribution_is_refused():
    with pytest.raises(ValueError):
        multihot.pool(dict(UNIFORM, hot_dist="zipf"), SIZES, HOT, 13, 0)
