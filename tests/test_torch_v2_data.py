"""The port's v2 data and configuration modules against the JAX package's,
bit for bit (exact equality throughout): configs/presets.py,
optim/lr_policy.py, config.py::TrainConfig, data/random_data.py's
RandomDataset, data/multi_hot.py and data/multi_hot_criteo.py."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

from dlrm_tpu.config import DLRMConfig as JaxDLRMConfig
from dlrm_tpu.config import TrainConfig as JaxTrainConfig
from dlrm_tpu.configs import presets as jpresets
from dlrm_tpu.data import criteo
from dlrm_tpu.data import multi_hot as jmh
from dlrm_tpu.data import multi_hot_criteo as jmhc
from dlrm_tpu.data.random_data import RandomDataset as JaxRandomDataset
from dlrm_tpu.optim.lr_policy import LRPolicy as JaxLRPolicy
from dlrm_tpu_torch.config import DLRMConfig, TrainConfig
from dlrm_tpu_torch.configs import presets as tpresets
from dlrm_tpu_torch.data import multi_hot as tmh
from dlrm_tpu_torch.data import multi_hot_criteo as tmhc
from dlrm_tpu_torch.data.random_data import RandomDataset
from dlrm_tpu_torch.optim import lr_policy as tlr
from dlrm_tpu.optim import lr_policy as jlr


def _assert_batches_equal(a, b):
    for f in ("dense", "idx", "wt", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


# ------------------------------------------------------------ configuration


def test_presets_constants_equal():
    for name in ("CRITEO_1TB_COUNTS", "MULTI_HOT_SIZES",
                 "CRITEO_KAGGLE_COUNTS"):
        assert getattr(tpresets, name) == getattr(jpresets, name)
    assert tpresets.PRESETS.keys() == jpresets.PRESETS.keys()


@pytest.mark.parametrize("name", sorted(jpresets.PRESETS))
def test_presets_configs_equal(name):
    (tm, tt), (jm, jt) = tpresets.PRESETS[name](), jpresets.PRESETS[name]()
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    assert tm.ln_top == jm.ln_top


def test_train_config_fields_and_defaults_equal():
    tf = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    jf = [(f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)]
    assert tf == jf
    for kw in (dict(), dict(mini_batch_size=4, data_size=10),
               dict(num_batches=7, test_mini_batch_size=16)):
        t, j = TrainConfig(**kw), JaxTrainConfig(**kw)
        assert (t.num_train_batches, t.eval_batch_size) == (
            j.num_train_batches, j.eval_batch_size)


@pytest.mark.parametrize("warmup,decay_start,decay_steps", [
    (0, 0, 0), (4, 4, 0), (3, 5, 6), (0, 2, 10), (5, 5, 5), (2, 9, 3),
])
def test_lr_policy_sequences_equal(warmup, decay_start, decay_steps):
    assert tlr.MIN_LR == jlr.MIN_LR
    t = tlr.LRPolicy(0.7, warmup, decay_start, decay_steps)
    j = JaxLRPolicy(0.7, warmup, decay_start, decay_steps)
    ts, js = [], []
    for _ in range(decay_start + decay_steps + 5):
        ts.append(t.lr)
        js.append(j.lr)
        assert t.step() == j.step()
    assert ts == js
    # the state_dict round trip resumes the same sequence
    sd = t.state_dict()
    assert sd == j.state_dict()
    r = tlr.LRPolicy(0.7, warmup, decay_start, decay_steps)
    r.load_state_dict(sd)
    assert r.lr == t.lr
    assert [r.step() for _ in range(4)] == [j.step() for _ in range(4)]


def test_lr_policy_rejects_decay_before_warmup():
    for cls in (tlr.LRPolicy, JaxLRPolicy):
        with pytest.raises(ValueError, match="warmup"):
            cls(1.0, num_warmup_steps=4, decay_start_step=2)


# --------------------------------------------------------------- random data

MODEL = dict(embedding_dim=4, table_sizes=(50, 7, 300), mlp_bot=(5, 4),
             mlp_top=(8, 1), num_indices_per_lookup=6)


@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "unfixed"])
@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
@pytest.mark.parametrize("pad", [True, False], ids=["padded", "short"])
def test_random_dataset_batches_equal(fixed, dist, pad):
    """3 batches of 8, 8 and 4 samples (data_size 20): the last one short,
    or padded to 8 with label -1 rows; each bag's draws from the numpy
    global RNG in the reference's order."""
    tkw = dict(mini_batch_size=8, data_size=20, numpy_rand_seed=11,
               num_indices_per_lookup_fixed=fixed, round_targets=True,
               rand_data_dist=dist, rand_data_max=40.0, rand_data_sigma=6.0)
    tds = RandomDataset(DLRMConfig(**MODEL), TrainConfig(**tkw),
                        pad_last_batch=pad)
    jds = JaxRandomDataset(JaxDLRMConfig(**MODEL), JaxTrainConfig(**tkw),
                           pad_last_batch=pad)
    assert len(tds) == len(jds) == 3
    tb, jb = list(tds), list(jds)  # each reseeds on batch 0
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
    assert tb[-1].dense.shape[0] == (8 if pad else 4)
    if pad:
        assert (tb[-1].labels[4:] == -1).all()
    # a second pass reseeds on access to batch 0: the same batches
    for a, b in zip(tds, tb):
        _assert_batches_equal(a, b)


def test_random_dataset_synthetic_is_not_ported():
    ds = RandomDataset(DLRMConfig(**MODEL),
                       TrainConfig(mini_batch_size=4, num_batches=1,
                                   data_generation="synthetic"))
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        ds[0]


# ------------------------------------------------------------------ Multihot


@pytest.mark.parametrize("dist_type", ["uniform", "pareto"])
def test_multihot_lookups_batches_and_stats_equal(dist_type):
    hots, sizes, b = [3, 1, 5], [20, 30, 2000], 16
    t = tmh.Multihot(hots, sizes, b, collect_freqs_stats=True,
                     dist_type=dist_type, seed=5)
    j = jmh.Multihot(hots, sizes, b, collect_freqs_stats=True,
                     dist_type=dist_type, seed=5)
    for x, y in zip(t.lookups, j.lookups):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(3)
    one_hot = tmh.HostBatch(
        dense=rng.random((b, 13), dtype=np.float32),
        idx=np.stack([rng.integers(0, n, (b, 1)) for n in sizes]).astype(
            np.int32),
        wt=None,
        labels=rng.integers(0, 2, (b, 1)).astype(np.float32),
    )
    for _ in range(2):  # the stats accumulate over conversions
        _assert_batches_equal(t.convert_to_multi_hot(one_hot),
                              j.convert_to_multi_hot(one_hot))
    for x, y in zip(t.freqs_pre + t.freqs_post, j.freqs_pre + j.freqs_post):
        np.testing.assert_array_equal(x, y)
    # the restartable wrapper iterates twice, as JAX's does
    wrapped = t.convert_dataloader([one_hot, one_hot])
    assert len(wrapped) == 2 and len(list(wrapped)) == len(list(wrapped)) == 2


def test_multihot_save_freqs_stats_equal(tmp_path):
    hots, sizes = [2, 4], [10, 40]
    one_hot = tmh.HostBatch(np.zeros((4, 13), np.float32),
                            np.array([[[1], [2], [3], [1]],
                                      [[5], [9], [0], [5]]], np.int32),
                            None, np.zeros((4, 1), np.float32))
    outs = []
    for mod in (tmh, jmh):
        mh = mod.Multihot(hots, sizes, 4, collect_freqs_stats=True)
        mh.convert_to_multi_hot(one_hot)
        path = str(tmp_path / f"{mod.__name__}.npz")
        mh.save_freqs_stats(path)
        with np.load(path) as z:
            outs.append({k: z[k] for k in z.files})
        with pytest.raises(ValueError, match="no frequency stats"):
            mod.Multihot(hots, sizes, 4).save_freqs_stats(path)
    assert outs[0].keys() == outs[1].keys()
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


# -------------------------------------------------- materialized multi-hot


@pytest.fixture(scope="module")
def processed_days(tmp_path_factory):
    """Two raw Criteo days of 60 rows, processed by the JAX package's
    preprocess_raw (as tests/test_v2_main.py makes them)."""
    tmp = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    raws = []
    for d in range(2):
        p = str(tmp / f"day_{d}")
        with open(p, "wb") as f:
            for _ in range(60):
                label = rng.integers(0, 2)
                dense = [str(rng.integers(0, 100)).encode() for _ in range(13)]
                cats = [format(rng.integers(0, 500), "x").encode()
                        for _ in range(26)]
                f.write(str(label).encode() + b"\t"
                        + b"\t".join(dense + cats) + b"\n")
        raws.append(p)
    art = criteo.preprocess_raw(raws, str(tmp / "proc"), randomize="none")
    return art.day_files, [int(c) for c in art.counts], tmp


HOTS = [2, 3] + [1] * 23 + [4]


@pytest.fixture(scope="module")
def materialized(processed_days):
    days, counts, tmp = processed_days
    out = {}
    for name, mod in (("port", tmhc), ("jax", jmhc)):
        out[name] = mod.materialize_multihot_dataset(
            days, str(tmp / f"mh_{name}"), counts, HOTS,
            dist_type="pareto", seed=2)
    return out


def test_materialize_writes_identical_files(materialized):
    port, jax_dir = materialized["port"], materialized["jax"]
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port)) == names
    assert len(names) == 3 * 2 + 1
    for n in names:
        if n == "meta.json":
            continue
        assert filecmp.cmp(os.path.join(port, n), os.path.join(jax_dir, n),
                           shallow=False), n
    with open(os.path.join(port, "meta.json")) as f, open(
            os.path.join(jax_dir, "meta.json")) as g:
        assert json.load(f) == json.load(g)


def test_materialize_cli_writes_identical_files(processed_days, tmp_path):
    days, counts, _ = processed_days
    outs = []
    for mod in (tmhc, jmhc):
        out = str(tmp_path / mod.__name__)
        assert mod.main([
            "--in-processed-days", *days, "--output-path", out,
            "--num-embeddings-per-feature", ",".join(map(str, counts)),
            "--multi-hot-sizes", ",".join(map(str, HOTS)),
        ]) == 0
        outs.append(out)
    for n in sorted(os.listdir(outs[1])):
        assert filecmp.cmp(os.path.join(outs[0], n),
                           os.path.join(outs[1], n), shallow=False), n


@pytest.mark.parametrize("kw", [
    dict(batch_size=16),
    dict(batch_size=16, drop_last=True),
    dict(batch_size=7, days=[1]),
    dict(batch_size=16, split="first_half", days=[1]),
    dict(batch_size=16, split="second_half", days=[1]),
    dict(batch_size=16, rank=0, world_size=3),
    dict(batch_size=16, rank=2, world_size=3),
    dict(batch_size=32, days=[0, 1], split="second_half"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_multihot_criteo_dataset_batches_equal(materialized, kw):
    """read_batch flat and padded, splits, rank striding, the day stitching
    (batches of 16 and 32 cross the 60-row day boundary) and the padded
    last batch."""
    path = materialized["jax"]
    t = tmhc.MultiHotCriteoDataset(path, **kw)
    j = jmhc.MultiHotCriteoDataset(path, **kw)
    assert (len(t), t.num_batches, t.base, t.total) == (
        len(j), j.num_batches, j.base, j.total)
    tb, jb = list(t), list(j)
    assert len(tb) == len(jb) == len(t)
    for a, b in zip(tb, jb):
        _assert_batches_equal(a, b)
    for i in range(t.num_batches):
        _assert_batches_equal(t.read_batch(i, flat=True),
                              j.read_batch(i, flat=True))
    last = t.read_batch(t.num_batches - 1)
    n_real = int((last.labels >= 0).sum())
    assert last.dense.shape[0] == kw["batch_size"]
    assert (last.wt[:, n_real:] == 0).all()


def test_multihot_criteo_dataset_contents(materialized):
    """Both packages' files load in the port and give the same batches; the
    padded layout carries each table's hot size; real rows add up."""
    ds = tmhc.MultiHotCriteoDataset(materialized["port"], batch_size=16)
    other = tmhc.MultiHotCriteoDataset(materialized["jax"], batch_size=16)
    batches = list(ds)
    assert len(batches) == int(np.ceil(120 / 16))
    for a, b in zip(batches, other):
        _assert_batches_equal(a, b)
    assert batches[0].idx.shape == (26, 16, 4)
    assert (batches[0].wt[1].sum(axis=1) == 3).all()
    assert sum(int((b.labels >= 0).sum()) for b in batches) == 120
    with pytest.raises(ValueError, match="split"):
        tmhc.MultiHotCriteoDataset(materialized["port"], 16, split="middle")


def test_mmap_npz_member_equal(tmp_path):
    path = str(tmp_path / "x.npz")
    a = np.arange(60, dtype=np.int32).reshape(12, 5)
    b = np.asfortranarray(np.linspace(0, 1, 24, dtype=np.float32).reshape(4, 6))
    np.savez(path, a=a, b=b)
    for member in ("a", "b.npy"):
        t, j = tmhc.mmap_npz_member(path, member), jmhc.mmap_npz_member(path, member)
        assert isinstance(t, np.memmap)
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tmhc.mmap_npz_member(path, "b"), b)
    comp = str(tmp_path / "c.npz")
    np.savez_compressed(comp, a=a)
    for mod in (tmhc, jmhc):
        with pytest.raises(ValueError, match="compressed"):
            mod.mmap_npz_member(comp, "a")
