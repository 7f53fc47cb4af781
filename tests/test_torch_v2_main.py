"""The port's DLRM-v2 trainer (dlrm_tpu_torch/v2_main.py) on the CPU: the
single-device cases of tests/test_v2_main.py through main(..., device="cpu"),
parity with dlrm_tpu's main on the stream path (the same argv, the JAX
init carried across with bridge.py; final loss within rtol 0.02, the
bf16-tower tolerance of test_torch_stream_step.py; AUROC within atol 0.02,
a few dozen of the eval sets' 2,500-4,000 positive-negative pairs ranked
the other way, since the two bf16 towers round differently; the LR
sequence and sample counts exact) on every single-device branch (stream,
fused, dense; the dot, dcn and projection interactions; weighted pooling
on the auto and stream paths), the flag surface, the auto cost model, and
the branches that are not ported. The parity runs keep the learning
rate small: on random labels a model barely moves off its init, and
Adagrad's first steps or a large SGD rate amplify the towers' rounding
differences until AUROC, which ranks near-equal scores, says nothing."""

import contextlib
import dataclasses
import io
import json
import re

import jax
import numpy as np
import pytest

from dlrm_tpu import v2_main as jmain
from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.data import criteo
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu_torch import v2_main as tmain
from dlrm_tpu_torch.bridge import params_from_jax
from dlrm_tpu_torch.configs.presets import MULTI_HOT_SIZES
from dlrm_tpu_torch.data.multi_hot_criteo import (
    MultiHotCriteoDataset,
    materialize_multihot_dataset,
)
from dlrm_tpu_torch.models.dlrm import DLRMModel

SMALL = [
    "--embedding_dim", "8",
    "--dense_arch_layer_sizes", "16,8",
    "--over_arch_layer_sizes", "16,8,1",
]
AUROC_ATOL = 0.02


def _run(argv, main=None):
    """main(argv) with its stdout captured: (return code, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (main or (lambda a: tmain.main(a, device="cpu")))(argv)
    return rc, buf.getvalue()


# ------------------------------------ the single-device cases of test_v2_main


def test_main_random_data():
    rc, out = _run([
        "--limit_train_batches", "6", "--limit_val_batches", "3",
        "--limit_test_batches", "3", "--batch_size", "16",
        "--num_embeddings", "64", *SMALL, "--adagrad",
        "--learning_rate", "0.05",
    ])
    assert rc == 0
    assert "Epoch 0: 96 samples" in out
    assert "Number of val samples: 48" in out


def test_main_random_data_stream_bf16():
    rc, out = _run([
        "--limit_train_batches", "4", "--limit_val_batches", "2",
        "--limit_test_batches", "2", "--batch_size", "16",
        "--embedding_dim", "128", "--num_embeddings", "640",
        "--dense_arch_layer_sizes", "16,128",
        "--over_arch_layer_sizes", "16,8,1", "--adagrad",
        "--learning_rate", "0.05", "--embedding_impl", "stream",
        "--embedding_dtype", "bfloat16",
    ])
    assert rc == 0
    assert np.isfinite(float(re.search(r"final loss (\S+)", out).group(1)))


def _raw_days(tmp, days=2, rows=60):
    rng = np.random.default_rng(0)
    raws = []
    for d in range(days):
        p = str(tmp / f"day_{d}")
        with open(p, "wb") as f:
            for _ in range(rows):
                label = rng.integers(0, 2)
                dense = [str(rng.integers(0, 100)).encode() for _ in range(13)]
                cats = [format(rng.integers(0, 500), "x").encode()
                        for _ in range(26)]
                f.write(str(label).encode() + b"\t"
                        + b"\t".join(dense + cats) + b"\n")
        raws.append(p)
    return raws


@pytest.fixture(scope="module")
def multihot_dir(tmp_path_factory):
    """tests/test_v2_main.py's dataset, materialized by the port."""
    tmp = tmp_path_factory.mktemp("v2")
    art = criteo.preprocess_raw(_raw_days(tmp), str(tmp / "proc"),
                                randomize="none")
    return materialize_multihot_dataset(
        art.day_files, str(tmp / "mh"), [int(c) for c in art.counts],
        hot_sizes=[2, 3] + [1] * 24)


def _meta_flags(path):
    with open(path + "/meta.json") as f:
        meta = json.load(f)
    return ["--num_embeddings_per_feature",
            ",".join(str(s) for s in meta["table_sizes"]),
            "--multi_hot_sizes", ",".join(str(h) for h in meta["hot_sizes"])]


def test_materialized_multihot_loader(multihot_dir):
    ds = MultiHotCriteoDataset(multihot_dir, batch_size=16)
    batches = list(ds)
    assert len(ds) == len(batches) == int(np.ceil(120 / 16))
    hb = batches[0]
    assert hb.idx.shape == (26, 16, 3)
    assert (hb.wt[0].sum(axis=1) == 2).all()  # table 0: 2-hot
    assert (hb.wt[1].sum(axis=1) == 3).all()  # table 1: 3-hot
    real = sum(int((b.labels >= 0).sum()) for b in batches)
    assert real == 120  # day stitching
    r0 = MultiHotCriteoDataset(multihot_dir, 16, rank=0, world_size=2)
    r1 = MultiHotCriteoDataset(multihot_dir, 16, rank=1, world_size=2)
    assert len(r0) + len(r1) == len(ds)


def test_main_on_materialized_multihot(multihot_dir):
    rc, out = _run(["--synthetic_multi_hot_criteo_path", multihot_dir,
                    "--batch_size", "16", *_meta_flags(multihot_dir), *SMALL,
                    "--adagrad"])
    assert rc == 0
    # train on day 0 (60 rows, 4 batches), val/test halves of day 1
    assert "Epoch 0: 64 samples" in out
    assert "Number of val samples: 30" in out
    assert "Number of test samples: 30" in out


def test_main_random_data_multi_hot_conversion():
    rc, _ = _run([
        "--limit_train_batches", "4", "--limit_val_batches", "2",
        "--limit_test_batches", "2", "--batch_size", "16", *SMALL,
        "--num_embeddings_per_feature", "64,32,48",
        "--multi_hot_sizes", "3,1,5", "--adagrad",
    ])
    assert rc == 0


def test_materialized_geometry_mismatch_exits(multihot_dir):
    flags = _meta_flags(multihot_dir)
    for i in (1, 3):  # table sizes, then hot sizes
        bad = list(flags)
        bad[i] = "7," + bad[i].split(",", 1)[1]
        with pytest.raises(SystemExit, match="materialized"):
            _run(["--synthetic_multi_hot_criteo_path", multihot_dir,
                  "--batch_size", "16", *bad, *SMALL])


# ----------------------------------------------------------- parity with JAX


@pytest.fixture
def jax_init(monkeypatch):
    """The port's DLRMModel.init_params returns the JAX package's init for
    the same config and seed, carried across with bridge.py."""
    def init_params(self, seed=0, device="cuda"):
        kw = {f.name: getattr(self.cfg, f.name)
              for f in dataclasses.fields(self.cfg)}
        p = JaxModel(JaxConfig(**kw)).init_params(jax.random.PRNGKey(seed))
        return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                               device=device)

    monkeypatch.setattr(DLRMModel, "init_params", init_params)


def _parsed(out):
    loss = re.search(r"final loss (\S+)", out)
    return {
        "loss": None if loss is None else float(loss.group(1)),
        "auroc": [(m.group(1), float(m.group(2))) for m in re.finditer(
            r"AUROC over (\w+) set: (\S+)", out)],
        "lr": re.findall(r"^lr: .*$", out, re.M),
        "counts": re.findall(r"^(?:Number of .*|Epoch \d+: \d+ samples)", out,
                             re.M),
        "stop": "stop early" in out,
    }


def _both(argv):
    rc_j, out_j = _run(argv, jmain.main)
    rc_t, out_t = _run(argv)
    assert rc_j == rc_t == 0
    return _parsed(out_j), _parsed(out_t)


def _assert_parity(j, t):
    assert t["counts"] == j["counts"] and t["lr"] == j["lr"]
    assert t["stop"] == j["stop"]
    if j["loss"] is not None:
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=0.02)
    assert [k for k, _ in t["auroc"]] == [k for k, _ in j["auroc"]]
    for (k, a), (_, b) in zip(t["auroc"], j["auroc"]):
        np.testing.assert_allclose(a, b, atol=AUROC_ATOL, err_msg=k)


def test_parity_random_multihot_stream(jax_init):
    """Random data through Multihot (the numpy global RNG on both sides),
    the stream path with fp32 tables, warmup and decay printed by
    --print_lr."""
    j, t = _both([
        "--limit_train_batches", "4", "--limit_val_batches", "2",
        "--limit_test_batches", "2", "--batch_size", "64", *SMALL,
        "--num_embeddings_per_feature", "64,32,48",
        "--multi_hot_sizes", "3,1,5", "--adagrad", "--learning_rate", "0.05",
        "--embedding_impl", "stream", "--print_lr", "--lr_warmup_steps", "2",
        "--lr_decay_start", "2", "--lr_decay_steps", "2",
    ])
    assert len(t["lr"]) == 4
    assert [k for k, _ in t["auroc"]] == ["val", "test"]
    _assert_parity(j, t)


@pytest.fixture(scope="module")
def parity_dir(tmp_path_factory):
    """Three days of 200 rows: train on 400, val and test 100 each."""
    tmp = tmp_path_factory.mktemp("parity")
    art = criteo.preprocess_raw(_raw_days(tmp, days=3, rows=200),
                                str(tmp / "proc"), randomize="none")
    return materialize_multihot_dataset(
        art.day_files, str(tmp / "mh"), [int(c) for c in art.counts],
        hot_sizes=[3, 1, 2] + [1] * 23)


def test_parity_materialized_stream(jax_init, parity_dir):
    """The materialized loader (the padded read), validation within the
    epoch, a padded last train batch (400 = 6 x 64 + 16), sgd."""
    j, t = _both([
        "--synthetic_multi_hot_criteo_path", parity_dir, "--batch_size", "64",
        *_meta_flags(parity_dir), *SMALL, "--learning_rate", "0.05",
        "--embedding_impl", "stream", "--validation_freq_within_epoch", "3",
        "--test_batch_size", "50",
    ])
    # validation after steps 3 and 6, at the epoch's end, then the test set
    assert [k for k, _ in t["auroc"]] == ["val", "val", "val", "test"]
    assert t["counts"][0] == "Number of val samples: 100"
    _assert_parity(j, t)


def test_parity_auroc_target_stops_early(jax_init, parity_dir):
    argv = ["--synthetic_multi_hot_criteo_path", parity_dir,
            "--batch_size", "64", *_meta_flags(parity_dir), *SMALL,
            "--embedding_impl", "stream", "--learning_rate", "0.05",
            "--validation_freq_within_epoch", "2", "--auroc_target", "0.01",
            "--limit_train_batches", "5"]
    j, t = _both(argv)
    assert t["stop"] and t["loss"] is None  # stopped before the epoch's end
    _assert_parity(j, t)


# ------------------------------------------------------------- flag surface


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                 a.nargs, a.const, a.required, type(a).__name__)
        for a in parser._actions
    }


def test_every_jax_flag_with_its_default_and_choices():
    assert _actions(tmain.build_parser()) == _actions(jmain.build_parser())


# ----------------------------------------------------------------- the path


def _args(**kw):
    base = dict(embedding_impl="auto", embedding_dtype="bfloat16",
                batch_size=16384)
    base.update(kw)
    return tmain.build_parser().parse_args(
        [x for k, v in base.items() for x in (f"--{k}", str(v))])


def test_pick_stream_uses_the_cards_figures():
    from dlrm_tpu_torch.config import DLRMConfig

    bench = DLRMConfig(embedding_dim=128, table_sizes=(200_000,) * 26,
                       mlp_bot=(13, 512, 256, 128),
                       mlp_top=(1024, 1024, 512, 256, 1),
                       num_indices_per_lookup=100)
    # bench.py's shape: the stream (~0.94 ms) beats ~3.5 ms of index_add_
    stream_ms = 2 * 26 * 200_000 * 128 * 2 / tmain.STREAM_BYTES_PER_S * 1e3
    scatter_ms = 16384 * sum(MULTI_HOT_SIZES) * tmain.SCATTER_S_PER_HIT * 1e3
    assert 0.9 < stream_ms < 1.0 and 3.4 < scatter_ms < 3.6
    assert tmain._pick_stream(_args(), bench, list(MULTI_HOT_SIZES))
    # huge tables at a small batch: streaming the table every step loses
    huge = bench.replace(table_sizes=(500_000,) * 4, num_indices_per_lookup=1)
    assert not tmain._pick_stream(_args(batch_size=16, embedding_dtype="float32"),
                                  huge, [1] * 4)
    assert tmain._pick_stream(_args(batch_size=16, embedding_impl="stream"),
                              huge, [1] * 4)
    # weighted pooling has no fused path
    assert not tmain._pick_stream(
        _args(), bench.replace(weighted_pooling="learned"))
    # the TPU's constants are gone
    assert (tmain.STREAM_BYTES_PER_S, tmain.SCATTER_S_PER_HIT) != (200e9,
                                                                  36.5e-9)


BASE = ["--limit_train_batches", "1", "--batch_size", "16", *SMALL,
        "--num_embeddings", "64"]


@pytest.mark.parametrize("extra,error", [
    (["--in_memory_binary_criteo_path", "/nonexistent"], FileNotFoundError),
], ids=["binary-criteo"])
def test_unported_branches_raise(extra, error):
    """The binary Criteo loader, which raised NotImplementedError here until
    it was ported, now opens its bins: a missing directory is a missing
    file, as in JAX."""
    with pytest.raises(error):
        _run(BASE + extra, jmain.main)
    with pytest.raises(error):
        _run(BASE + extra)


def test_parity_binary_criteo_loader(jax_init, tmp_path):
    """--in_memory_binary_criteo_path on the bins of the port's
    data/criteo.py, against the JAX trainer on the same bins: the fused
    path and the stream path with --shuffle_batches, Multihot expanding
    the one-hot rows."""
    from dlrm_tpu_torch.data import criteo as tcriteo

    raws = _raw_days(tmp_path, days=3, rows=200)
    out = str(tmp_path / "bins")
    art = tcriteo.preprocess_raw(raws, out, randomize="none")
    tcriteo.numpy_to_binary(art.day_files[:-1], f"{out}/train_data.bin")
    for split in ("val", "test"):
        tcriteo.numpy_to_binary(art.day_files[-1:],
                                f"{out}/{split}_data.bin", split)
    counts = ",".join(str(int(c)) for c in art.counts)
    argv = ["--in_memory_binary_criteo_path", out, "--batch_size", "64",
            *SMALL, "--num_embeddings_per_feature", counts,
            "--learning_rate", "0.05"]
    for extra in (["--embedding_impl", "fused"],
                  ["--embedding_impl", "stream", "--shuffle_batches",
                   "--multi_hot_sizes", ",".join(["2"] * 26)]):
        j, t = _both(argv + extra)
        # 400 train rows in 7 batches of 64, the last padded
        assert t["counts"][0].startswith("Epoch 0: 448 samples")
        _assert_parity(j, t)


PARITY = ["--limit_train_batches", "4", "--limit_val_batches", "2",
          "--limit_test_batches", "2", "--batch_size", "64", *SMALL,
          "--num_embeddings_per_feature", "64,32,48",
          "--multi_hot_sizes", "3,1,5", "--learning_rate", "0.05"]


@pytest.mark.parametrize("extra,path", [
    (["--embedding_impl", "fused", "--adagrad"], "fused"),
    (["--embedding_impl", "dense", "--adagrad"], "dense"),
    (["--interaction_type", "dcn", "--dcn_num_layers", "2",
      "--dcn_low_rank_dim", "8", "--adagrad"], None),
    (["--interaction_type", "projection",
      "--interaction_branch1_layer_sizes", "16,16"], None),
    (["--weighted_pooling", "learned", "--adagrad"], "dense"),
    (["--weighted_pooling", "fixed", "--embedding_impl", "stream"], None),
    (["--weighted_pooling", "fixed"], "dense"),
    (["--weighted_pooling", "learned", "--embedding_impl", "stream",
      "--adagrad"], None),
    (["--interaction_type", "dcn", "--dcn_num_layers", "1",
      "--dcn_low_rank_dim", "4", "--embedding_impl", "fused"], "fused"),
], ids=["fused", "dense", "dcn", "projection", "wp-auto", "wp-stream",
        "wp-fixed-auto", "wp-learned-stream", "dcn-fused"])
def test_parity_single_device_branches(jax_init, extra, path):
    """Each branch that used to raise NotImplementedError, against the JAX
    trainer on the same argv: random data through Multihot, 4 steps, val
    and test. auto takes the stream path on these small tables (path None:
    no line names a fused or dense step) and the dense step under weighted
    pooling, as in JAX."""
    j, t = _both(PARITY + extra)
    _assert_parity(j, t)
    _, out = _run(PARITY + extra)
    named = re.findall(r"^embedding update: (\w+)", out, re.M)
    assert named == ([] if path is None else [path])


def test_auto_on_huge_tables_takes_the_fused_path(jax_init):
    """auto picks fused where streaming the table every step costs more
    than the batch's scatter (both trainers' cost models agree on these
    4 x 2,000-row tables at batch 16), and matches the JAX trainer."""
    argv = ["--limit_train_batches", "3", "--limit_val_batches", "2",
            "--limit_test_batches", "2", "--batch_size", "16", *SMALL,
            "--num_embeddings_per_feature", "2000,2000,2000,2000",
            "--multi_hot_sizes", "1,1,1,1", "--adagrad",
            "--learning_rate", "0.05"]
    j, t = _both(argv)
    _assert_parity(j, t)
    _, out = _run(argv)
    assert "embedding update: fused coalesce+scatter step" in out


def test_multi_process_and_multi_device_raise(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        _run(BASE)
    monkeypatch.delenv("WORLD_SIZE")
    # --sharded over two cards, before anything touches them
    import torch

    monkeypatch.setattr(tmain, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        tmain.main(BASE + ["--sharded"])


def test_flag_rejections_as_in_jax(capsys):
    with pytest.raises(SystemExit, match="undersampling_rate"):
        _run(BASE + ["--undersampling_rate", "0.5"])
    with pytest.raises(SystemExit, match="multi-device mesh"):
        _run(BASE + ["--rw_bucket", "on"])
    with pytest.raises(SystemExit, match="multi-device mesh"):
        _run(BASE + ["--column_wise_tables", "0"])


def test_cuda_flags_and_sharded_on_one_device():
    """--sharded on one device trains the single-device path (as in JAX);
    --pin_memory and --mmap_mode say what the port already does;
    --allow_tf32 sets torch's TF32 switches, which stay off otherwise."""
    import torch

    rc, out = _run(BASE + ["--sharded", "--pin_memory", "--mmap_mode",
                           "--allow_tf32"])
    assert rc == 0
    assert "--pin_memory" in out and "--mmap_mode" in out
    assert torch.backends.cuda.matmul.allow_tf32
    _run(BASE)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
