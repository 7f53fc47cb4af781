"""The port's v1 trainer entry point (dlrm_tpu_torch/cli.py) on the CPU
through main(argv, device="cpu"): the four golden logs of
test_scripts/dlrm_tpu_test.sh (text equal, every number within 5e-6), the
README smoke losses, the single-device cases of tests/test_flags.py, the
flag surface against dlrm_tpu/cli.py, quantized --inference-only (emb 4/8,
MLP 8/16, group-16), --save-onnx and --plot-compute-graph against the JAX
CLI.

Where the JAX CLI and the port's run the same argv, the printed losses are
compared within 5e-6 (the goldens' own tolerance): both draw their init and
data from the same numpy stream, and only the order of fp32 sums differs.
QR tables have no numpy init (the reference draws them from the torch RNG),
so their parity runs carry the JAX init across with bridge.py.
"""

import contextlib
import dataclasses
import glob
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from dlrm_tpu import cli as jcli
from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu_torch import cli as tcli
from dlrm_tpu_torch.bridge import params_from_jax
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.scripts import golden_compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = {  # test_scripts/dlrm_tpu_test.sh
    "tiny1": ["--mini-batch-size=1", "--data-size=1"],
    "tiny2": ["--mini-batch-size=2", "--data-size=4", "--nepochs=2"],
    "tiny3": ["--mini-batch-size=2", "--data-size=5", "--nepochs=3",
              "--debug-mode"],
    "tiny4": ["--mini-batch-size=2", "--data-size=6", "--loss-function=bce",
              "--round-targets=True"],
}
README_LOSSES = [0.025266, 0.180494, 0.083240]
TOL = golden_compare.TOL


def _run(argv, main=None):
    """main(argv) with its stdout captured: (return code, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = (main or (lambda a: tcli.main(a, device="cpu")))(argv)
    return rc, buf.getvalue()


def _losses(out):
    return [float(x) for x in re.findall(r"loss (\d+\.\d+)", out)]


def _assert_text_close(got, want):
    """The same text with every number within TOL (the golden rule of
    scripts/golden_compare.py)."""
    diff = golden_compare.differences(got, want)
    assert not diff, "\n".join(diff[:20])


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_logs(name):
    rc, out = _run(GOLDEN[name])
    assert rc == 0
    with open(os.path.join(ROOT, "test_scripts", "golden",
                           f"{name}.log")) as f:
        _assert_text_close(out, f.read())


def test_readme_smoke_losses():
    rc, out = _run(["--mini-batch-size=2", "--data-size=6"])
    assert rc == 0
    np.testing.assert_allclose(_losses(out), README_LOSSES, rtol=0, atol=TOL)


@pytest.fixture
def jax_init(monkeypatch):
    """The port's DLRMModel.init_params returns the JAX package's
    init_params for the same config and seed, carried across."""
    def init_params(self, seed=0, device="cuda"):
        assert not self.cfg.proj_branches  # the JAX package has no such form
        kw = {f.name: getattr(self.cfg, f.name)
              for f in dataclasses.fields(JaxConfig)}
        p = JaxModel(JaxConfig(**kw)).init_params(jax.random.PRNGKey(seed))
        return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                               device=device)

    monkeypatch.setattr(DLRMModel, "init_params", init_params)


SMALL = ["--mini-batch-size=4", "--data-size=24", "--print-freq=2",
         "--arch-embedding-size=40-9-30"]


@pytest.mark.parametrize("extra", [
    ["--optimizer=adagrad"],
    ["--optimizer=rwsadagrad", "--loss-function=bce"],
    ["--loss-function=wbce", "--loss-weights=0.3-1.7", "--round-targets=True"],
    ["--arch-interaction-op=cat", "--arch-mlp-top=12-2-1"],
    ["--arch-interaction-itself"],
    ["--weighted-pooling=fixed", "--optimizer=adagrad"],
    ["--weighted-pooling=learned", "--optimizer=rwsadagrad"],
    ["--md-flag", "--md-threshold=5", "--arch-sparse-feature-size=4",
     "--arch-mlp-bot=4-8-4", "--optimizer=rwsadagrad"],
    ["--md-flag", "--md-threshold=5", "--md-round-dims",
     "--arch-sparse-feature-size=4", "--arch-mlp-bot=4-8-4"],
    ["--mlperf-grad-accum-iter=2", "--optimizer=rwsadagrad"],
    ["--mlperf-grad-accum-iter=3", "--weighted-pooling=learned"],
    ["--num-indices-per-lookup=3", "--num-indices-per-lookup-fixed=True"],
    ["--rand-data-dist=gaussian", "--rand-data-min=0",
     "--rand-data-max=8", "--rand-data-sigma=2"],
], ids=["adagrad", "rwsadagrad-bce", "wbce", "cat", "itself", "wp-fixed",
        "wp-learned", "md", "md-round", "accum2-fused", "accum3-dense",
        "fixed-hot", "gaussian"])
def test_cli_matches_jax(extra):
    """The same argv through both CLIs: the same printed text, every number
    within 5e-6 (numpy-stream init and data on both sides)."""
    argv = SMALL + extra
    rc_j, out_j = _run(argv, jcli.main)
    rc_t, out_t = _run(argv)
    assert rc_j == rc_t == 0
    assert _losses(out_t)
    _assert_text_close(out_t, out_j)


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
def test_cli_qr_matches_jax(jax_init, op):
    """QR tables (the JAX init carried across): the same losses."""
    argv = SMALL + ["--qr-flag", "--qr-threshold=5", "--qr-collisions=3",
                    f"--qr-operation={op}", "--optimizer=rwsadagrad"]
    _, out_j = _run(argv, jcli.main)
    _, out_t = _run(argv)
    assert len(_losses(out_t)) == 3
    _assert_text_close(out_t, out_j)


def test_cli_synthetic_data_matches_jax(tmp_path_factory):
    """--data-generation=synthetic with a dist-file template and
    --data-trace-enable-padding, against the JAX CLI."""
    from dlrm_tpu.data import synthetic as jsyn

    tmp_path = tmp_path_factory.mktemp("dist")  # no "j" but the template's
    for k, n in enumerate((40, 9, 30)):
        jsyn.synthesize_dist_fixture(str(tmp_path / f"dist_{k}.log"), n,
                                     seed=k)
    argv = SMALL + ["--data-generation=synthetic",
                    f"--data-trace-file={tmp_path}/dist_j.log",
                    "--data-trace-enable-padding=True"]
    _, out_j = _run(argv, jcli.main)
    _, out_t = _run(argv)
    assert len(_losses(out_t)) == 3
    _assert_text_close(out_t, out_j)


# ------------------------------------------ the single-device test_flags cases


CFG = dict(embedding_dim=4, table_sizes=(40, 9, 30), mlp_bot=(13, 8, 4),
           mlp_top=(8, 4, 1), interaction="dot", loss="bce",
           num_indices_per_lookup=4)


@pytest.mark.parametrize("mode", ["fixed", "learned"])
def test_weighted_pooling_fixed_freezes_v_w(mode):
    """--weighted-pooling fixed keeps v_w at init under every optimizer;
    learned moves them."""
    from dlrm_tpu_torch.config import DLRMConfig, TrainConfig
    from dlrm_tpu_torch.data.random_data import RandomDataset
    from dlrm_tpu_torch.optim.optimizers import init_opt_state
    from dlrm_tpu_torch.train.step import make_train_step

    cfg = DLRMConfig(**CFG, weighted_pooling=mode)
    model = DLRMModel(cfg)
    params = model.init_params(seed=0, device="cpu")
    tc = TrainConfig(mini_batch_size=8, num_batches=3, numpy_rand_seed=3)
    step = make_train_step(model, "adagrad")
    s = init_opt_state("adagrad", params)
    for hb in RandomDataset(cfg, tc):
        params, s, _, _ = step(params, s, hb.to_device("cpu"), 0.1)
    vw = params["v_w"]
    if mode == "fixed":
        assert torch.equal(vw, torch.ones_like(vw))
    else:
        assert float((vw - 1.0).abs().max()) > 1e-6


def test_print_wall_time():
    rc, out = _run(["--mini-batch-size=2", "--data-size=4",
                    "--print-wall-time"])
    assert rc == 0
    assert re.search(r"loss \d+\.\d+ \(\d\d:\d\d\)", out), out


def test_print_time_prints_host_ms_per_it():
    rc, out = _run(["--mini-batch-size=2", "--data-size=4", "--print-time"])
    assert rc == 0
    ms = [float(x) for x in re.findall(r", (\S+) ms/it", out)]
    assert len(ms) == 2 and all(x > 0 for x in ms)


def test_activation_function_rejected():
    with pytest.raises(SystemExit):
        _run(["--mini-batch-size=2", "--data-size=2",
              "--activation-function=tanh"])


def test_tensor_board_filename_writes_scalars_and_event_files(tmp_path):
    """--tensor-board-filename writes the JSONL scalars and TensorBoard
    event files in the flag's directory, the same scalars as the JAX CLI."""
    from dlrm_tpu_torch.utils import tfevents

    prefix = str(tmp_path / "run_tb")
    rc, _ = _run(["--mini-batch-size=2", "--data-size=4",
                  "--mlperf-logging", f"--tensor-board-filename={prefix}"])
    assert rc == 0
    rows = [json.loads(x) for x in open(prefix + ".scalars.jsonl")]
    assert any(r["tag"] == "Train/Loss" for r in rows)
    assert any(r["tag"] == "mlperf-metrics-test/roc_auc" for r in rows)
    files = glob.glob(prefix + "/events.out.tfevents.*")
    assert len(files) == 1
    # every record's CRC holds, the first is the version event, and one
    # record per scalar follows it
    data = open(files[0], "rb").read()
    pos, records = 0, []
    while pos < len(data):
        (n,) = np.frombuffer(data[pos:pos + 8], np.uint64)
        n = int(n)
        body = data[pos + 12:pos + 12 + n]
        (crc,) = np.frombuffer(data[pos + 12 + n:pos + 16 + n], np.uint32)
        assert int(crc) == tfevents._masked_crc(body)
        records.append(body)
        pos += 16 + n
    assert b"brain.Event:2" in records[0]
    assert len(records) == 1 + len(rows)
    jprefix = str(tmp_path / "jax_tb")
    _run(["--mini-batch-size=2", "--data-size=4", "--mlperf-logging",
          f"--tensor-board-filename={jprefix}"], jcli.main)
    jrows = [json.loads(x) for x in open(jprefix + ".scalars.jsonl")]
    assert [(r["tag"], r["step"]) for r in rows] == [
        (r["tag"], r["step"]) for r in jrows]
    np.testing.assert_allclose([r["value"] for r in rows],
                               [r["value"] for r in jrows], atol=1e-5)


def test_unwritable_tb_dir_degrades_to_jsonl(tmp_path, monkeypatch):
    """An unwritable TB directory degrades to the JSONL alone with a
    warning (the failure is injected: this image runs as root)."""
    import warnings

    from dlrm_tpu_torch.utils import tfevents
    from dlrm_tpu_torch.utils.logging import ScalarLogger

    class _DeniedWriter:
        def __init__(self, logdir):
            raise PermissionError(13, "Permission denied", str(logdir))

    monkeypatch.setattr(tfevents, "TFEventsWriter", _DeniedWriter)
    jsonl = str(tmp_path / "s.jsonl")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        lg = ScalarLogger(jsonl, tb_dir=str(tmp_path / "ro" / "tb"))
    assert lg._tb is None
    assert any("JSONL scalars only" in str(x.message) for x in w)
    lg.add_scalar("Train/Loss", 0.5, 1)
    lg.close()
    assert '"Train/Loss"' in open(jsonl).read()


def test_num_workers_same_goldens():
    _, out0 = _run(["--mini-batch-size=2", "--data-size=6"])
    _, out1 = _run(["--mini-batch-size=2", "--data-size=6",
                    "--num-workers=2", "--test-num-workers=1"])
    assert _losses(out0) == _losses(out1) and len(_losses(out0)) == 3


def _mlperf_events(out):
    return [json.loads(line.split(":::MLLOG ", 1)[1])
            for line in out.splitlines() if line.startswith(":::MLLOG")]


def test_mlperf_event_sequence():
    """--mlperf-logging: the same event sequence as the JAX CLI (keys,
    event types, values, metadata), apart from the time stamps; the run
    ends ABORTED below its AUC threshold."""
    argv = ["--mini-batch-size=2", "--data-size=8", "--mlperf-logging",
            "--test-freq=2", "--learning-rate=0.05",
            "--mlperf-auc-threshold=0.999"]
    _, out_t = _run(argv)
    _, out_j = _run(argv, jcli.main)
    ev_t, ev_j = _mlperf_events(out_t), _mlperf_events(out_j)
    for e in ev_t + ev_j:
        assert isinstance(e.pop("time_ms"), int)
    assert ev_t == ev_j
    keys = [e["key"] for e in ev_t]
    assert keys[:4] == ["cache_clear", "init_start", "init_stop",
                        "run_start"]
    assert keys.count("eval_start") == keys.count("eval_stop") == 2
    assert keys[-3:] == ["epoch_stop", "block_stop", "run_stop"]
    assert ev_t[-1]["metadata"]["status"] == "aborted"


def test_mlperf_auc_threshold_stops_with_success():
    _, out = _run(["--mini-batch-size=2", "--data-size=8",
                   "--mlperf-logging", "--test-freq=2",
                   "--mlperf-auc-threshold=0.01"])
    assert "MLPerf testing auc threshold 0.01 reached" in out
    events = _mlperf_events(out)
    stops = [e for e in events if e["key"] == "run_stop"]
    assert len(stops) == 1 and stops[0]["metadata"]["status"] == "success"


def test_mlperf_logger_rank_gating(monkeypatch):
    """Rank 0 logs; another rank of an initialized process group does not;
    without a group the rank is 0."""
    import torch.distributed as dist

    from dlrm_tpu_torch.utils.logging import MLPerfLogger, process_rank

    assert process_rank() == 0
    buf = io.StringIO()
    MLPerfLogger(enabled=True, stream=buf).event("seed", 1)
    assert buf.getvalue().startswith(":::MLLOG ")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    buf = io.StringIO()
    MLPerfLogger(enabled=True, stream=buf).event("seed", 1)
    assert buf.getvalue() == ""


def _write_raw(path, n, rng):
    with open(path, "wb") as f:
        for _ in range(n):
            dense = [b"" if rng.random() < 0.2 else
                     str(rng.integers(-2, 1000)).encode() for _ in range(13)]
            cats = [b"" if rng.random() < 0.2 else
                    format(rng.integers(0, 1 << 32), "x").encode()
                    for _ in range(26)]
            f.write(str(rng.integers(0, 2)).encode() + b"\t"
                    + b"\t".join(dense + cats) + b"\n")


def _dataset_run(tmp_path, sub, raw, extra, main=None):
    out = tmp_path / sub
    out.mkdir()
    return _run(["--data-generation=dataset", "--data-set=kaggle",
                 f"--raw-data-file={raw}",
                 f"--processed-data-file={out}/proc",
                 "--mini-batch-size=4", "--nepochs=1"] + extra, main)


def test_memory_map_and_dataset_multiprocessing(tmp_path):
    """--memory-map trains from the memmap day files, with the days parsed
    by worker processes under --dataset-multiprocessing: the losses of the
    bin-file path, and the JAX CLI's losses on the same raw file."""
    raw = str(tmp_path / "train.txt")
    _write_raw(raw, 60, np.random.default_rng(0))
    rc_b, out_b = _dataset_run(tmp_path, "bin", raw, [])
    rc_m, out_m = _dataset_run(tmp_path, "mm", raw,
                               ["--memory-map", "--dataset-multiprocessing"])
    rc_j, out_j = _dataset_run(tmp_path, "jax", raw, [], jcli.main)
    assert rc_b == rc_m == rc_j == 0
    assert _losses(out_b) and _losses(out_b) == _losses(out_m)
    np.testing.assert_allclose(_losses(out_b), _losses(out_j), atol=TOL)
    assert "with the native parser" in out_b


def test_dataset_mlperf_run_matches_jax(tmp_path):
    """The MLPerf flags on a dataset (bins, bin shuffle, a test batch size,
    --max-ind-range hashing, periodic AUC): the JAX CLI's text, every
    number within 5e-6."""
    raw = str(tmp_path / "train.txt")
    _write_raw(raw, 90, np.random.default_rng(1))
    extra = ["--mlperf-logging", "--mlperf-bin-loader",
             "--mlperf-bin-shuffle", "--test-freq=5",
             "--test-mini-batch-size=8", "--max-ind-range=50",
             "--loss-function=bce", "--round-targets=True",
             "--learning-rate=0.1", "--arch-mlp-bot=13-8-2"]
    _, out_t = _dataset_run(tmp_path, "t", raw, extra)
    _, out_j = _dataset_run(tmp_path, "j", raw, extra, jcli.main)
    keep = lambda s: "\n".join(  # noqa: E731
        x for x in s.splitlines()
        if not x.startswith((":::MLLOG", "criteo:")))
    assert "auc" in keep(out_t)
    _assert_text_close(keep(out_t), keep(out_j))


def test_mlperf_bin_shuffle_batch_order(tmp_path):
    from dlrm_tpu_torch.data import criteo

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 100, size=(64, 40), dtype=np.int32)
    arr[:, 0] = rng.integers(0, 2, 64)
    bin_path = str(tmp_path / "t.bin")
    arr.tofile(bin_path)
    counts = str(tmp_path / "c.npz")
    np.savez(counts, counts=np.full(26, 100, np.int64))

    def by_content(bf):
        return [tuple(hb.idx.reshape(-1)[:8]) for hb in bf]

    plain = criteo.CriteoBinFile(bin_path, counts, batch_size=8)
    shuf = criteo.CriteoBinFile(bin_path, counts, batch_size=8,
                                shuffle_batches=True, seed=1)
    c_plain, c_shuf = by_content(plain), by_content(shuf)
    assert sorted(c_plain) == sorted(c_shuf)
    assert c_plain != c_shuf
    assert by_content(shuf) != c_shuf  # a new permutation each epoch
    np.testing.assert_array_equal(shuf[0].idx, plain[0].idx)


def test_shuffle_samples_vs_shuffle_batches(tmp_path):
    """shuffle_samples permutes samples across batches (the multiset
    kept); shuffle_batches permutes whole batches."""
    from dlrm_tpu_torch.data import criteo

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 100, size=(64, 40), dtype=np.int32)
    arr[:, 1] = np.arange(64)
    bin_path = str(tmp_path / "t.bin")
    arr.tofile(bin_path)
    counts = str(tmp_path / "c.npz")
    np.savez(counts, counts=np.full(26, 100, np.int64))

    def ids(bf):
        return [np.expm1(hb.dense[:, 0]).round().astype(int) for hb in bf]

    plain = ids(criteo.CriteoBinFile(bin_path, counts, 8))
    samp = ids(criteo.CriteoBinFile(bin_path, counts, 8,
                                    shuffle_samples=True, seed=3))
    assert sorted(np.concatenate(plain)) == sorted(np.concatenate(samp))
    assert any(sorted(a) != sorted(b) for a, b in zip(plain, samp))
    border = ids(criteo.CriteoBinFile(bin_path, counts, 8,
                                      shuffle_batches=True, seed=3))
    assert sorted(map(tuple, border)) == sorted(map(tuple, plain))


def test_lr_policy_flags_change_training():
    _, out0 = _run(["--mini-batch-size=2", "--data-size=6"])
    argv = ["--mini-batch-size=2", "--data-size=6",
            "--lr-num-warmup-steps=2", "--lr-decay-start-step=2",
            "--lr-num-decay-steps=2"]
    _, out1 = _run(argv)
    l0, l1 = _losses(out0), _losses(out1)
    assert l0[0] == l1[0]
    assert l0[1:] != l1[1:]
    _, out_j = _run(argv, jcli.main)
    _assert_text_close(out1, out_j)


def test_enable_profiling_writes_trace(tmp_path):
    """--enable-profiling writes a chrome trace (torch.profiler) holding
    the reference's region labels (the embedding forward's from the
    evaluation; the fused train step pools outside the model)."""
    prefix = str(tmp_path / "prof")
    rc, out = _run(["--mini-batch-size=2", "--data-size=4", "--test-freq=2",
                    "--enable-profiling", f"--tensor-board-filename={prefix}"])
    assert rc == 0
    assert "profiler trace written" in out
    trace = json.load(open(os.path.join(prefix, "trace.json")))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"DLRM embedding forward", "DLRM bottom nlp forward",
            "DLRM interaction forward", "DLRM top nlp forward"} <= names


def test_region_labels_only_inside_profile(tmp_path):
    """The region labels are recorded inside profile() and nowhere else: a
    torch.profiler trace of a forward taken outside it holds none of them,
    so they never stand among a trace's kernels."""
    from dlrm_tpu_torch.utils import profiling as prof

    cfg = tcli.configs_from_args(tcli.build_parser().parse_args([]))[0]
    model = DLRMModel(cfg)
    params = model.init_params(seed=0, device="cpu")
    dense = torch.zeros((2, cfg.mlp_bot[0]))
    ly = torch.zeros((2, len(cfg.table_sizes), cfg.embedding_dim))
    labels = {prof.BOT_FWD, prof.INT_FWD, prof.TOP_FWD}

    def names():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            model.forward_from_pooled(params, dense, ly)
        return {e.name for e in p.events()}

    assert not labels & names()
    with prof.profile(True, str(tmp_path)):
        assert isinstance(prof.scope(prof.FWD),
                          torch.profiler.record_function)
    assert isinstance(prof.scope(prof.FWD), contextlib.nullcontext)
    assert not labels & names()


def test_debug_mode_dumps_in_jax_order():
    """--debug-mode dumps every parameter in the JAX package's order (dict
    keys sorted: bot/0/b before bot/0/w), MD projections and per-table
    pooling weights included."""
    argv = ["--mini-batch-size=2", "--data-size=2", "--debug-mode",
            "--weighted-pooling=learned", "--md-flag", "--md-threshold=2",
            "--arch-embedding-size=4-30-200"]
    _, out = _run(argv)
    _, out_j = _run(argv, jcli.main)
    keys = [x for x in out.splitlines() if re.fullmatch(r"[a-z_]+(/\w+)+", x)]
    assert keys[:4] == ["bot/0/b", "bot/0/w", "bot/1/b", "bot/1/w"]
    assert "emb/tables/1/proj" in keys and "v_w/2" in keys
    _assert_text_close(out, out_j)


def test_inference_only_evaluates():
    rc, out = _run(["--mini-batch-size=2", "--data-size=6",
                    "--inference-only"])
    _, out_j = _run(["--mini-batch-size=2", "--data-size=6",
                     "--inference-only"], jcli.main)
    assert rc == 0 and "Finished training" not in out
    assert re.search(r"Testing at - 0/0 of epoch 0, accuracy \S+ %", out)
    _assert_text_close(out, out_j)


def test_load_model_resumes(tmp_path):
    """--save-model at each new best test accuracy, then --load-model:
    the resumed run starts from the saved position."""
    ck = str(tmp_path / "ck")
    base = ["--mini-batch-size=2", "--data-size=8", "--test-freq=2",
            "--round-targets=True", "--loss-function=bce"]
    rc, out = _run(base + [f"--save-model={ck}"])
    assert rc == 0 and "Saved model to" in out
    meta = json.load(open(os.path.join(ck, "meta.json")))
    rc, out2 = _run(base + [f"--load-model={ck}"])
    assert rc == 0
    assert (f"Loaded model from {ck}: epoch {meta['epoch']} iteration "
            f"{meta['iteration']}") in out2


# --------------------------------------------------------------- flag surface


def _actions(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs,
                 a.const, a.required, type(a).__name__,
                 getattr(a.type, "__name__", a.type))
        for a in parser._actions
    }


def test_parser_matches_jax():
    """Every flag of dlrm_tpu/cli.py, with the same names, defaults,
    choices and parsers."""
    assert _actions(tcli.build_parser()) == _actions(jcli.build_parser())
    argv = ["--arch-embedding-size=5-6", "--qr-flag", "--md-flag"]
    jargs = jcli.build_parser().parse_args(argv[:1] + ["--md-flag"])
    targs = tcli.build_parser().parse_args(argv[:1] + ["--md-flag"])
    jm, jt = jcli.configs_from_args(jargs)
    tm, tt = tcli.configs_from_args(targs)
    # the port's one addition, torchrec's projection branches, unset
    port = dataclasses.asdict(tm)
    assert port.pop("interaction_branch1_layer_sizes") is None
    assert port.pop("interaction_branch2_layer_sizes") is None
    assert port == dataclasses.asdict(jm)
    assert dataclasses.asdict(tt) == dataclasses.asdict(jt)


def test_v1_planner_flags_require_sharded():
    for extra in (["--sharding-strategy=mixed"], ["--column-wise-tables=0"],
                  ["--rw-bucket=on"]):
        with pytest.raises(SystemExit):
            _run(["--mini-batch-size=2", "--data-size=2"] + extra)


def test_capacity_flags_require_auto_plan():
    for extra in (["--allow-capacity-overflow"], ["--hbm-gb=8"]):
        with pytest.raises(SystemExit):
            _run(["--mini-batch-size=2", "--data-size=2"] + extra)


def test_quantize_group16_needs_quantized_inference():
    with pytest.raises(SystemExit, match="group16"):
        _run(["--mini-batch-size=2", "--data-size=2", "--quantize-group16"])


QUANT = ["--mini-batch-size=4", "--data-size=24",
         "--arch-embedding-size=40-9-30", "--inference-only"]
WIDE8 = ["--arch-sparse-feature-size=8", "--arch-mlp-bot=4-8-8"]
# group-16 lines are 16 rows of d / 2 + 8 bytes (int4): a multiple of 128
WIDE16 = ["--arch-sparse-feature-size=16", "--arch-mlp-bot=4-8-16"]
MLLOG_TIME = re.compile(r'"time_ms": \d+')


@pytest.mark.parametrize("extra", [
    ["--quantize-emb-with-bit=4"],
    ["--quantize-emb-with-bit=8"],
    ["--quantize-mlp-with-bit=8"],
    ["--quantize-mlp-with-bit=16", "--debug-mode"],
    ["--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8",
     "--debug-mode"],
    ["--quantize-emb-with-bit=8", "--quantize-mlp-with-bit=16",
     "--weighted-pooling=learned"] + WIDE8,
    ["--quantize-emb-with-bit=4", "--quantize-group16"] + WIDE16,
    ["--quantize-emb-with-bit=8", "--quantize-group16",
     "--quantize-mlp-with-bit=8", "--mlperf-logging"] + WIDE8,
    ["--quantize-emb-with-bit=8", "--md-flag", "--md-threshold=5",
     "--arch-sparse-feature-size=4", "--arch-mlp-bot=4-8-4"],
    ["--quantize-emb-with-bit=4", "--quantize-mlp-with-bit=8",
     "--arch-interaction-op=cat", "--arch-mlp-top=26-2-1"] + WIDE8,
], ids=["emb4", "emb8", "mlp8", "mlp16-debug", "emb4-mlp8-debug",
        "emb8-mlp16-v_w", "group16-emb4", "group16-emb8-mlp8-mlperf",
        "emb8-md", "emb4-mlp8-cat"])
def test_quantized_inference_matches_jax(extra):
    """Quantized --inference-only against dlrm_tpu.cli.main on the same
    argv: the same text (the accuracy, AUC and --debug-mode's dump of the
    packed and quantized leaves), every number within 5e-6."""
    argv = QUANT + extra
    rc_j, out_j = _run(argv, jcli.main)
    rc_t, out_t = _run(argv)
    assert rc_j == rc_t == 0
    assert "Testing at - 0/0 of epoch 0, accuracy" in out_t
    _assert_text_close(MLLOG_TIME.sub("", out_t), MLLOG_TIME.sub("", out_j))
    if "--debug-mode" in extra:
        assert "emb/quantized/packed" in out_t or "qw" in out_t


def test_group16_accuracy_equals_rowwise():
    rows = _run(QUANT + WIDE16 + ["--quantize-emb-with-bit=4"])[1]
    g16 = _run(QUANT + WIDE16 + ["--quantize-emb-with-bit=4",
                                 "--quantize-group16"])[1]
    assert rows == g16


def _capture_export(monkeypatch):
    """Record the (model, params, batch_size) each export is given."""
    from dlrm_tpu_torch.tools import export

    seen = []
    real = export.export_forward

    def export_forward(model, params, batch_size, path, wt=True):
        seen.append((model, params, batch_size))
        return real(model, params, batch_size, path, wt)

    monkeypatch.setattr(export, "export_forward", export_forward)
    return seen


@pytest.mark.parametrize("extra", [[], ["--inference-only",
                                        "--quantize-emb-with-bit=4",
                                        "--quantize-mlp-with-bit=8"]],
                         ids=["trained", "quantized"])
def test_save_onnx_writes_a_forward_that_loads(tmp_path, monkeypatch, extra):
    """--save-onnx prints the JAX CLI's text (its .stablehlo name is the
    port's .pt2) and the archive, loaded back, gives the run's final
    params' probabilities bit for bit."""
    from dlrm_tpu_torch.data.batch import Batch
    from dlrm_tpu_torch.tools.export import load_forward

    seen = _capture_export(monkeypatch)
    argv = SMALL + ["--save-onnx"] + extra
    rc_j, out_j = _run(argv + [f"--tensor-board-filename={tmp_path}/j"],
                       jcli.main)
    rc_t, out_t = _run(argv + [f"--tensor-board-filename={tmp_path}/t"])
    assert rc_j == rc_t == 0
    assert f"exported serialized forward to {tmp_path}/t.pt2" in out_t
    _assert_text_close(out_t.replace(f"{tmp_path}/t.pt2", "F"),
                       out_j.replace(f"{tmp_path}/j.stablehlo", "F"))
    (model, params, b), = seen
    assert b == 4
    h = model.cfg.num_indices_per_lookup
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.integers(0, n, (b, h)) for n in (
        40, 9, 30)]).astype(np.int32))
    wt = torch.from_numpy(rng.random(idx.shape).astype(np.float32))
    dense = torch.from_numpy(rng.normal(size=(b, 4)).astype(np.float32))
    fwd = load_forward(f"{tmp_path}/t.pt2")
    with torch.no_grad():
        want = model.apply(params, Batch(dense, idx, wt, None))
    got = fwd(params, dense, idx, wt)
    assert torch.equal(got, want)


def test_plot_compute_graph_writes_the_program(tmp_path):
    argv = SMALL + ["--plot-compute-graph"]
    rc_j, out_j = _run(argv + [f"--tensor-board-filename={tmp_path}/j"],
                       jcli.main)
    rc_t, out_t = _run(argv + [f"--tensor-board-filename={tmp_path}/t"])
    assert rc_j == rc_t == 0
    path = f"{tmp_path}/t_graph.pt2.txt"
    assert out_t.startswith(f"compute graph written to {path}\n")
    _assert_text_close(
        out_t.replace(path, "F"),
        out_j.replace(f"{tmp_path}/j_graph.stablehlo.txt", "F"))
    text = open(path).read()
    for op in ("embedding_bag", "aten.mm", "aten.relu", "aten.sigmoid",
               "aten.bmm"):
        assert op in text, op


@pytest.mark.parametrize("extra", [
    ["--sharding-strategy=table_wise"], ["--column-wise-tables=1"],
    ["--rw-bucket=on", "--sharding-strategy=mixed"]],
    ids=["strategy", "column-wise", "rw-bucket"])
def test_sharded_quantized_serving_refuses_planner_flags(extra):
    with pytest.raises(SystemExit, match="quantized serving replicates"):
        _run(QUANT + ["--sharded", "--quantize-emb-with-bit=4"] + extra)


def test_multi_process_launch_raises(monkeypatch):
    """A multi-process launch without --sharded would train one
    unsynchronized replica per process, which ROADMAP.md leaves out; with
    --sharded it trains (tests/test_torch_cli_sharded.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="pass --sharded"):
        _run(["--mini-batch-size=2", "--data-size=2"])


def test_sync_dense_params_false_notes():
    _, out = _run(["--mini-batch-size=2", "--data-size=2",
                   "--sync-dense-params=False"])
    assert out.startswith("NOTE: --sync-dense-params=False")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--mini-batch-size=2", "--data-size=2"])


def test_tfevents_copy_writes_the_jax_packages_records(tmp_path):
    """The port's copy of the event-file writer encodes the same records
    (CRC32C, protobuf fields, TFRecord framing) as dlrm_tpu/utils/
    tfevents.py, and a whole file equals the JAX writer's once the wall
    times are fixed."""
    from dlrm_tpu.utils import tfevents as jtf
    from dlrm_tpu_torch.utils import tfevents as ttf

    for data in (b"", b"a", bytes(range(256)) * 3):
        assert ttf._masked_crc(data) == jtf._masked_crc(data)
    for args in (("Train/Loss", 0.25, 3, 1.5e9), ("x", -7.0, 2**40, 0.0)):
        assert ttf._scalar_event(*args) == jtf._scalar_event(*args)
    assert ttf._version_event(12.5) == jtf._version_event(12.5)
    files = []
    for mod, d in ((ttf, "t"), (jtf, "j")):
        orig = mod.time.time
        mod.time.time = lambda: 1700000000.0
        try:
            w = mod.TFEventsWriter(str(tmp_path / d))
            w.add_scalar("Test/Acc", 0.5, 7)
            w.close()
        finally:
            mod.time.time = orig
        files += glob.glob(str(tmp_path / d / "events.out.tfevents.*"))
    assert open(files[0], "rb").read() == open(files[1], "rb").read()
