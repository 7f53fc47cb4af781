"""The port's Criteo pipeline and synthetic traces against the JAX
package's, bit for bit: the numpy and native parsers (native/criteo_preproc.cc
built with g++ into dlrm_tpu_torch/build/), hashing and counts, the
preprocessed days, the bins byte for byte, CriteoBinFile's batches (padding,
hashing, batch and sample shuffles, epochs), the streaming preprocessing
(bit-equal to the in-RAM one and to JAX's), CriteoDayDataset, the
make_criteo_datasets glue, and data/synthetic.py's profiles, dist files,
LRU traces and batches. Exact equality throughout."""

import argparse
import filecmp
import os
import unittest.mock as mock

import numpy as np
import pytest

from dlrm_tpu.data import criteo as jcriteo
from dlrm_tpu.data import criteo_stream as jstream
from dlrm_tpu.data import synthetic as jsyn
from dlrm_tpu.native import criteo_native as jnative
from dlrm_tpu_torch.data import criteo as tcriteo
from dlrm_tpu_torch.data import criteo_stream as tstream
from dlrm_tpu_torch.data import synthetic as tsyn
from dlrm_tpu_torch.native import criteo_native as tnative


def _write_raw_day(path, n, rng, missing_rate=0.2, long_rows=False):
    """Criteo-format tsv: label, 13 ints, 26 hex, some fields empty; with
    long_rows, some rows short of fields, some with extra fields and a
    last line without its newline."""
    with open(path, "wb") as f:
        lines = []
        for _ in range(n):
            dense = [b"" if rng.random() < missing_rate
                     else str(rng.integers(-2, 1000)).encode()
                     for _ in range(13)]
            cats = [b"" if rng.random() < missing_rate
                    else format(rng.integers(0, 1 << 32), "x").encode()
                    for _ in range(26)]
            cols = [str(rng.integers(0, 2)).encode()] + dense + cats
            if long_rows and rng.random() < 0.1:
                cols = cols[: rng.integers(1, 40)]
            elif long_rows and rng.random() < 0.1:
                cols = cols + [b"ff", b"7"]
            lines.append(b"\t".join(cols))
        f.write(b"\n".join(lines) + (b"" if long_rows else b"\n"))


@pytest.fixture
def raw_days(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for d in range(3):
        p = str(tmp_path / f"day_{d}")
        _write_raw_day(p, 40 + d * 7, rng, long_rows=d == 2)
        paths.append(p)
    return paths


def _assert_dicts_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _numpy_parse(module, native, *args):
    with mock.patch.object(native, "available", return_value=False):
        return module.parse_raw_day(*args)


@pytest.mark.parametrize("max_ind_range", [-1, 1000])
def test_parsers_equal_jax(raw_days, max_ind_range, capsys):
    """The port's native parser, its numpy parser and JAX's numpy parser
    give the same arrays; the port prints which parser ran."""
    assert tnative.available()
    for p in raw_days:
        ref = _numpy_parse(jcriteo, jnative, p, max_ind_range, 0.0, 123)
        _assert_dicts_equal(tnative.parse_raw_day(p, max_ind_range), ref)
        _assert_dicts_equal(tcriteo.parse_raw_day(p, max_ind_range), ref)
        assert "with the native parser" in capsys.readouterr().out
        _assert_dicts_equal(
            _numpy_parse(tcriteo, tnative, p, max_ind_range, 0.0, 123), ref)
        assert "with the numpy parser" in capsys.readouterr().out


def test_subsampling_equals_jax_per_parser(raw_days):
    """Zero-label rows dropped at sub_sample_rate: each parser keeps the
    rows JAX's same parser keeps (numpy: MT19937; native: xorshift64*)."""
    for p in raw_days:
        ref = _numpy_parse(jcriteo, jnative, p, -1, 0.5, 7)
        got = _numpy_parse(tcriteo, tnative, p, -1, 0.5, 7)
        _assert_dicts_equal(got, ref)
        assert 0 < len(got["y"]) < len(
            _numpy_parse(tcriteo, tnative, p)["y"])
        if jnative.available():
            _assert_dicts_equal(tnative.parse_raw_day(p, -1, 0.5, 7),
                                jnative.parse_raw_day(p, -1, 0.5, 7))


def test_native_parser_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.parse_raw_day(str(tmp_path / "absent"))


def test_native_write_bin_equals_numpy_to_binary(raw_days, tmp_path):
    art = tcriteo.preprocess_raw(raw_days, str(tmp_path / "p"),
                                 randomize="none")
    ref = str(tmp_path / "ref.bin")
    tcriteo.numpy_to_binary(art.day_files, ref)
    got = str(tmp_path / "got.bin")
    for f in art.day_files:
        with np.load(f) as z:
            n = tnative.write_bin(got, z["y"], z["X_int"], z["X_cat"])
            assert n == z["y"].shape[0]
    assert filecmp.cmp(ref, got, shallow=False)


@pytest.mark.parametrize("randomize", ["total", "day", "none"])
@pytest.mark.parametrize("max_ind_range", [-1, 50])
def test_preprocess_raw_equals_jax(raw_days, tmp_path, randomize,
                                   max_ind_range):
    """Hashing, per-column dictionaries and counts, the shuffles and the
    processed day files: JAX's, array for array."""
    ta = tcriteo.preprocess_raw(raw_days, str(tmp_path / "t"),
                                max_ind_range, randomize=randomize, seed=5)
    ja = jcriteo.preprocess_raw(raw_days, str(tmp_path / "j"),
                                max_ind_range, randomize=randomize, seed=5)
    np.testing.assert_array_equal(ta.counts, ja.counts)
    if max_ind_range > 0:
        assert (ta.counts <= max_ind_range).all()
    for a, b in zip(ta.day_files, ja.day_files):
        with np.load(a) as x, np.load(b) as y:
            _assert_dicts_equal(dict(x), dict(y))
    for split, files in (("train", ta.day_files[:-1]),
                         ("test", ta.day_files[-1:]),
                         ("val", ta.day_files[-1:])):
        tcriteo.numpy_to_binary(files, str(tmp_path / f"t_{split}.bin"),
                                split)
        jcriteo.numpy_to_binary(files, str(tmp_path / f"j_{split}.bin"),
                                split)
        assert filecmp.cmp(tmp_path / f"t_{split}.bin",
                           tmp_path / f"j_{split}.bin", shallow=False)


def test_split_kaggle_train_equals_jax(tmp_path):
    src = str(tmp_path / "train.txt")
    _write_raw_day(src, 50, np.random.default_rng(1))
    tf = tcriteo.split_kaggle_train(src, str(tmp_path / "t"), 7)
    jf = jcriteo.split_kaggle_train(src, str(tmp_path / "j"), 7)
    assert len(tf) == 7
    for a, b in zip(tf, jf):
        assert filecmp.cmp(a, b, shallow=False)


def _bins(raw_days, tmp_path):
    art = tcriteo.preprocess_raw(raw_days, str(tmp_path / "p"))
    train = str(tmp_path / "train.bin")
    test = str(tmp_path / "test.bin")
    tcriteo.numpy_to_binary(art.day_files[:-1], train)
    tcriteo.numpy_to_binary(art.day_files[-1:], test, "test")
    return train, test, art.counts_file


def _assert_batches_equal(a, b):
    for f in ("dense", "idx", "wt", "labels"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kw", [
    dict(batch_size=16),
    dict(batch_size=16, drop_last=True),
    dict(batch_size=16, pad_last=False),
    dict(batch_size=7, max_ind_range=13),
    dict(batch_size=8, shuffle_batches=True, seed=4),
    dict(batch_size=8, shuffle_samples=True, seed=4),
], ids=["pad", "drop-last", "short-last", "hash", "shuffle-batches",
        "shuffle-samples"])
def test_criteo_bin_file_batches_equal_jax(raw_days, tmp_path, kw):
    """CriteoBinFile: the same batches as JAX's, in the same order, over
    two epochs (set_epoch) and by position."""
    train, _, counts = _bins(raw_days, tmp_path)
    t = tcriteo.CriteoBinFile(train, counts, **kw)
    j = jcriteo.CriteoBinFile(train, counts, **kw)
    assert len(t) == len(j) and t.num_samples == j.num_samples
    np.testing.assert_array_equal(t.counts, j.counts)
    for epoch in (0, 3):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        tb, jb = list(t), list(j)
        assert len(tb) == len(t)
        for a, b in zip(tb, jb):
            _assert_batches_equal(a, b)
    _assert_batches_equal(t[len(t) - 1], j[len(j) - 1])
    t.close()
    j.close()


def test_rank_strided_read_raises(raw_days, tmp_path):
    train, _, counts = _bins(raw_days, tmp_path)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        tcriteo.CriteoBinFile(train, counts, 8, rank=1, world_size=2)


@pytest.mark.parametrize("randomize", ["total", "day"])
def test_streaming_preprocess_bit_equal(raw_days, tmp_path, randomize):
    """The out-of-core preprocessing (small chunks) gives the in-RAM
    path's days bit for bit (the in-RAM days are JAX's, above)."""
    ram = tcriteo.preprocess_raw(raw_days, str(tmp_path / "ram"),
                                 randomize=randomize, seed=9)
    st = tstream.preprocess_raw_streaming(raw_days, str(tmp_path / "st"),
                                          randomize=randomize, seed=9,
                                          chunk_rows=11)
    np.testing.assert_array_equal(st.counts, ram.counts)
    for d, (f, pre) in enumerate(zip(ram.day_files, st.day_prefixes)):
        with np.load(f) as z:
            for k in ("y", "X_int", "X_cat"):
                np.testing.assert_array_equal(np.load(f"{pre}.{k}.npy"),
                                              z[k], err_msg=k)
            assert st.day_rows(d) == z["y"].shape[0]
    # the intermediates are gone
    assert not [f for f in os.listdir(tmp_path / "st") if "_raw" in f]


def test_streaming_parallel_workers_equal(raw_days, tmp_path):
    """Day parsing in 2 spawned worker processes gives the 1-worker days."""
    one = tstream.preprocess_raw_streaming(raw_days, str(tmp_path / "a"))
    two = tstream.preprocess_raw_streaming(raw_days, str(tmp_path / "b"),
                                           num_workers=2)
    np.testing.assert_array_equal(one.counts, two.counts)
    for a, b in zip(one.day_prefixes, two.day_prefixes):
        for k in ("y", "X_int", "X_cat"):
            np.testing.assert_array_equal(np.load(f"{a}.{k}.npy"),
                                          np.load(f"{b}.{k}.npy"))


def test_streaming_bins_and_day_dataset(raw_days, tmp_path):
    """days_to_binary_streaming is byte-identical to numpy_to_binary on the
    same rows, and CriteoDayDataset yields JAX's batches (train, test and
    val splits, the last batch padded)."""
    st = tstream.preprocess_raw_streaming(raw_days, str(tmp_path / "st"))
    ram = tcriteo.preprocess_raw(raw_days, str(tmp_path / "ram"))
    for split, pre, files in (
            ("train", st.day_prefixes[:-1], ram.day_files[:-1]),
            ("test", st.day_prefixes[-1:], ram.day_files[-1:]),
            ("val", st.day_prefixes[-1:], ram.day_files[-1:])):
        a, b = str(tmp_path / f"s_{split}.bin"), str(tmp_path / f"r_{split}.bin")
        tstream.days_to_binary_streaming(pre, a, split, chunk_rows=9)
        tcriteo.numpy_to_binary(files, b, split)
        assert filecmp.cmp(a, b, shallow=False)
        t = tstream.CriteoDayDataset(st.day_prefixes, st.counts_file, 6,
                                     split, max_ind_range=20)
        j = jstream.CriteoDayDataset(st.day_prefixes, st.counts_file, 6,
                                     split, max_ind_range=20)
        assert len(t) == len(j) > 1
        for x, y in zip(t, j):
            _assert_batches_equal(x, y)


def test_stream_preprocess_main_equals_jax(raw_days, tmp_path):
    """The standalone preprocessing CLI (criteo_stream.main --make-bins)
    writes JAX's files."""
    for mod, out in ((tstream, "t"), (jstream, "j")):
        assert mod.main(["--input-dir", os.path.dirname(raw_days[0]),
                         "--output-dir", str(tmp_path / out), "--days", "3",
                         "--make-bins", "--chunk-rows", "17"]) == 0
    for name in ("train_data.bin", "test_data.bin", "val_data.bin"):
        assert filecmp.cmp(tmp_path / "t" / name, tmp_path / "j" / name,
                           shallow=False)


def _args(out, raw, **kw):
    base = dict(processed_data_file=f"{out}/x", raw_data_file=raw,
                data_set="kaggle", max_ind_range=-1,
                data_sub_sample_rate=0.0, data_randomize="total",
                numpy_rand_seed=123, memory_map=False,
                dataset_multiprocessing=False, mlperf_bin_shuffle=False)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("kw", [
    dict(), dict(mlperf_bin_shuffle=True, max_ind_range=40),
], ids=["bins", "bin-shuffle"])
def test_make_criteo_datasets_equal_jax(tmp_path, kw):
    """The CLI glue from a Kaggle-style train.txt (split into 7 days,
    preprocessed in RAM, binned): JAX's loaders, their counts and batches."""
    from dlrm_tpu.config import DLRMConfig as JaxDLRM
    from dlrm_tpu.config import TrainConfig as JaxTC
    from dlrm_tpu_torch.config import DLRMConfig, TrainConfig

    raw = str(tmp_path / "train.txt")
    _write_raw_day(raw, 70, np.random.default_rng(3))
    tc = dict(mini_batch_size=8, test_mini_batch_size=5)
    t_tr, t_te = tcriteo.make_criteo_datasets(
        DLRMConfig(), TrainConfig(**tc), _args(tmp_path / "t", raw, **kw))
    j_tr, j_te = jcriteo.make_criteo_datasets(
        JaxDLRM(), JaxTC(**tc), _args(tmp_path / "j", raw, **kw))
    np.testing.assert_array_equal(t_tr.counts, j_tr.counts)
    for t, j in ((t_tr, j_tr), (t_te, j_te)):
        assert type(t).__name__ == type(j).__name__ == "CriteoBinFile"
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) > 0
        for a, b in zip(tb, jb):
            _assert_batches_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(memory_map=True), dict(dataset_multiprocessing=True),
], ids=["memory-map", "multiprocessing"])
def test_make_criteo_datasets_streaming_equal_bins(tmp_path, kw):
    """--memory-map (CriteoDayDataset over the out-of-core days) and
    --dataset-multiprocessing (days parsed by worker processes, then bins)
    give the batches of the in-RAM bins path, which the test above holds
    to JAX's."""
    from dlrm_tpu_torch.config import DLRMConfig, TrainConfig

    raw = str(tmp_path / "train.txt")
    _write_raw_day(raw, 70, np.random.default_rng(3))
    tc = TrainConfig(mini_batch_size=8, test_mini_batch_size=5)
    ref = tcriteo.make_criteo_datasets(DLRMConfig(), tc,
                                       _args(tmp_path / "ref", raw))
    got = tcriteo.make_criteo_datasets(DLRMConfig(), tc,
                                       _args(tmp_path / "got", raw, **kw))
    np.testing.assert_array_equal(got[0].counts, ref[0].counts)
    kind = "CriteoDayDataset" if kw.get("memory_map") else "CriteoBinFile"
    for g, r in zip(got, ref):
        assert type(g).__name__ == kind
        gb, rb = list(g), list(r)
        assert len(gb) == len(rb) > 0
        for a, b in zip(gb, rb):
            _assert_batches_equal(a, b)


# ---------------------------------------------------------------- synthetic


def test_trace_profile_and_dist_file_equal_jax(tmp_path):
    rng = np.random.default_rng(2)
    trace = rng.zipf(1.3, 400) % 60
    assert tsyn.trace_profile(trace) == jsyn.trace_profile(trace)
    t = tsyn.distribution_from_trace(trace.tolist())
    assert t == jsyn.distribution_from_trace(trace.tolist())
    tsyn.write_dist_file(str(tmp_path / "t.log"), *t)
    jsyn.write_dist_file(str(tmp_path / "j.log"), *t)
    assert filecmp.cmp(tmp_path / "t.log", tmp_path / "j.log", shallow=False)
    assert tsyn.read_dist_file(str(tmp_path / "t.log")) == \
        jsyn.read_dist_file(str(tmp_path / "j.log"))
    tsyn.synthesize_dist_fixture(str(tmp_path / "tf.log"), 77, seed=4)
    jsyn.synthesize_dist_fixture(str(tmp_path / "jf.log"), 77, seed=4)
    assert filecmp.cmp(tmp_path / "tf.log", tmp_path / "jf.log",
                       shallow=False)


@pytest.mark.parametrize("padding", [False, True])
def test_lru_trace_equals_jax(tmp_path, padding):
    jsyn.synthesize_dist_fixture(str(tmp_path / "d.log"), 50, seed=1)
    lines, sd, cumm = jsyn.read_dist_file(str(tmp_path / "d.log"))
    np.random.seed(11)
    a = tsyn.lru_trace(list(lines), sd, cumm, 300, padding)
    np.random.seed(11)
    b = jsyn.lru_trace(list(lines), sd, cumm, 300, padding)
    assert a == b


@pytest.mark.parametrize("fixed", [False, True])
def test_synthetic_batches_equal_jax(tmp_path_factory, fixed):
    # every "j" of the template names the table: the directory has none
    tmp = tmp_path_factory.mktemp("dist")
    sizes = (50, 7, 300)
    for k, n in enumerate(sizes):
        jsyn.synthesize_dist_fixture(str(tmp / f"d_{k}.log"), n, seed=k)
    out = []
    for mod in (tsyn, jsyn):
        np.random.seed(3)
        out.append([mod.generate_synthetic_batch(
            5, sizes, 6, 4, str(tmp / "d_j.log"), fixed,
            enable_padding=True, round_targets=True, pad_batch_to=8)
            for _ in range(2)])
    for a, b in zip(*out):
        _assert_batches_equal(a, b)
    assert (out[0][0].idx < np.asarray(sizes)[:, None, None]).all()


def test_synthetic_main_equals_jax(tmp_path):
    """The standalone trace-synthesis CLI writes JAX's files."""
    trace = tmp_path / "trace.log"
    trace.write_text(", ".join(str(x) for x in
                               np.random.default_rng(5).integers(0, 30, 200)))
    for mod, tag in ((tsyn, "t"), (jsyn, "j")):
        mod.main(["--trace-file", str(trace),
                  "--dist-file", str(tmp_path / f"{tag}_dist.log"),
                  "--synthetic-file", str(tmp_path / f"{tag}_syn.log")])
    for name in ("dist.log", "syn.log"):
        assert filecmp.cmp(tmp_path / f"t_{name}", tmp_path / f"j_{name}",
                           shallow=False)
