"""The port's v1 Trainer (dlrm_tpu_torch/train/harness.py) against the JAX
package's on the CPU, from the same params (the JAX init carried across
with bridge.py) and the same data: the printed losses, accuracies and AUCs
within 5e-6 (numbers as the trainers print them, 6 decimals; the fp32 sums
differ in order only), on each train step the Trainer picks (the fused
step with sgd, adagrad and rwsadagrad; the dense step for weighted, QR and
MD tables), with gradient accumulation, early stop on accuracy and on AUC,
save-on-best and the resume fast-forward; and the port's fused step on
padded v1 batches (weight-0 slots) against JAX's make_fused_train_step.
"""

import contextlib
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.config import MDConfig as JaxMD
from dlrm_tpu.config import QRConfig as JaxQR
from dlrm_tpu.config import TrainConfig as JaxTC
from dlrm_tpu.data import criteo as jcriteo
from dlrm_tpu.data.random_data import RandomDataset as JaxRandomDataset
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.optim.optimizers import init_opt_state as jax_init_opt_state
from dlrm_tpu.train import harness as jharness
from dlrm_tpu.train.fused_step import make_fused_train_step as jax_fused
from dlrm_tpu_torch.bridge import params_from_jax
from dlrm_tpu_torch.config import DLRMConfig, MDConfig, QRConfig, TrainConfig
from dlrm_tpu_torch.data import criteo as tcriteo
from dlrm_tpu_torch.data.random_data import RandomDataset
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.train import harness
from dlrm_tpu_torch.train.fused_step import make_fused_train_step

NUM = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+")
KW = dict(embedding_dim=4, table_sizes=(40, 9, 300), mlp_bot=(13, 8, 4),
          mlp_top=(8, 4, 1), loss="bce", num_indices_per_lookup=5)
MODELS = {
    "plain": ({}, {}),
    "dcn": ({"interaction": "dcn"}, {"interaction": "dcn"}),
    "weighted": ({"weighted_pooling": "learned"},
                 {"weighted_pooling": "learned"}),
    "qr": ({"qr": QRConfig(threshold=20, operation="add")},
           {"qr": JaxQR(threshold=20, operation="add")}),
    "md": ({"md": MDConfig(threshold=20)}, {"md": JaxMD(threshold=20)}),
}


def _pair(name, **kw):
    t, j = MODELS[name]
    return (DLRMModel(DLRMConfig(**{**KW, **t, **kw})),
            JaxModel(JaxConfig(**{**KW, **j, **kw})))


def _states(tmodel, jmodel, optimizer, seed=0):
    jp = jmodel.init_params(jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (harness.TrainState(tp, init_opt_state(optimizer, tp)),
            jharness.TrainState(jp, jax_init_opt_state(optimizer, jp)))


def _train(trainer, state):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = trainer.train(state)
    return state, buf.getvalue()


def _assert_text_close(got, want, tol=5e-6):
    assert NUM.sub("#", got) == NUM.sub("#", want)
    a = [float(x) for x in NUM.findall(got)]
    b = [float(x) for x in NUM.findall(want)]
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _run_both(name, tc_kw, data=None, model_kw=None):
    """Both Trainers on the same params and data; their printed output."""
    tmodel, jmodel = _pair(name, **(model_kw or {}))
    tc, jtc = TrainConfig(**tc_kw), JaxTC(**tc_kw)
    if data is None:
        t_data = (RandomDataset(tmodel.cfg, tc),
                  RandomDataset(tmodel.cfg, tc, pad_last_batch=True))
        j_data = (JaxRandomDataset(jmodel.cfg, jtc),
                  JaxRandomDataset(jmodel.cfg, jtc, pad_last_batch=True))
    else:
        t_data, j_data = data(tcriteo), data(jcriteo)
    ts, js = _states(tmodel, jmodel, tc.optimizer)
    tt = harness.Trainer(tmodel, tc, *t_data, device="cpu")
    jt = jharness.Trainer(jmodel, jtc, *j_data)
    (ts, out_t), (js, out_j) = _train(tt, ts), _train(jt, js)
    return ts, out_t, js, out_j


@pytest.mark.parametrize("name,optimizer,step", [
    ("plain", "sgd", "make_fused_train_step"),
    ("plain", "adagrad", "make_fused_train_step"),
    ("plain", "rwsadagrad", "make_fused_train_step"),
    ("dcn", "sgd", "make_fused_train_step"),
    ("weighted", "rwsadagrad", "make_train_step"),
    ("qr", "adagrad", "make_train_step"),
    ("md", "rwsadagrad", "make_train_step"),
])
def test_trainer_matches_jax(name, optimizer, step):
    """Two epochs with the MLPerf metrics at the end: the same losses,
    accuracy and AUC, on the step the JAX Trainer picks."""
    tc = dict(mini_batch_size=8, num_batches=4, nepochs=2, optimizer=optimizer,
              learning_rate=0.1, mlperf_logging=True, round_targets=True)
    tmodel, _ = _pair(name)
    assert harness.pick_train_step(
        tmodel, TrainConfig(**tc)).__qualname__.startswith(step)
    ts, out_t, js, out_j = _run_both(name, tc)
    assert len(re.findall(r", loss ", out_t)) == 8 and "auc" in out_t
    _assert_text_close(out_t, out_j)
    assert (ts.epoch, ts.total_iter) == (js.epoch, js.total_iter) == (2, 8)
    assert ts.best_auc == pytest.approx(js.best_auc, abs=1e-6)


@pytest.mark.parametrize("name,step", [
    ("plain", "make_fused_grad_accum_train_step"),
    ("weighted", "make_grad_accum_train_step"),
    ("md", "make_grad_accum_train_step"),
])
def test_grad_accumulation_matches_jax(name, step):
    """--mlperf-grad-accum-iter 3: 7 batches make 2 groups (the short one
    dropped), each one optimizer step."""
    tc = dict(mini_batch_size=4, num_batches=7, optimizer="rwsadagrad",
              learning_rate=0.1, grad_accum_iter=3, print_freq=1)
    tmodel, _ = _pair(name)
    assert harness.pick_train_step(
        tmodel, TrainConfig(**tc)).__qualname__.startswith(step)
    ts, out_t, js, out_j = _run_both(name, tc)
    assert re.findall(r"it (\d)/2", out_t) == ["1", "2"]
    _assert_text_close(out_t, out_j)


def _bin_data(tmp_path, rows=96, seed=0):
    """A train and a test bin of packed Criteo records with a learnable
    label, and their counts: loaders without a random stream, so that a
    mid-epoch evaluation is deterministic."""
    rng = np.random.default_rng(seed)
    paths = []
    for split, n in (("train", rows), ("test", rows // 3)):
        arr = rng.integers(0, 40, size=(n, 40)).astype(np.int32)
        arr[:, 14:] %= 9
        arr[:, 0] = (arr[:, 1] > 20).astype(np.int32)
        p = str(tmp_path / f"{split}.bin")
        arr.tofile(p)
        paths.append(p)
    counts = str(tmp_path / "counts.npz")
    np.savez(counts, counts=np.full(26, 9, np.int64))

    def data(module, batch=8):
        return (module.CriteoBinFile(paths[0], counts, batch),
                module.CriteoBinFile(paths[1], counts, batch))

    return data


BIN_MODEL = dict(table_sizes=(9,) * 26, mlp_bot=(13, 8, 4))


@pytest.mark.parametrize("threshold", [
    dict(mlperf_acc_threshold=0.01),
    dict(mlperf_auc_threshold=0.01, mlperf_logging=True),
], ids=["accuracy", "auc"])
def test_early_stop_matches_jax(tmp_path, threshold):
    """A threshold cleared at the first evaluation (after step 3 of 12)
    stops both trainers there, with the same lines."""
    tc = dict(mini_batch_size=8, optimizer="sgd", learning_rate=0.1,
              test_freq=3, **threshold)
    ts, out_t, js, out_j = _run_both("plain", tc, _bin_data(tmp_path),
                                     BIN_MODEL)
    assert "threshold" in out_t and "reached, stop training" in out_t
    assert ts.total_iter == js.total_iter == 3
    _assert_text_close(out_t, out_j)


def test_save_on_best_and_resume_fast_forward(tmp_path):
    """Save-on-best at each evaluation that improves the accuracy; a
    Trainer resumed from the checkpoint skips the trained batches at the
    index level and prints the uninterrupted run's losses for the rest,
    to the bit."""
    data = _bin_data(tmp_path)
    ck = str(tmp_path / "best")
    tc = dict(mini_batch_size=8, optimizer="adagrad", learning_rate=0.1,
              test_freq=4, save_model=ck, print_freq=1)
    ts, out_t, js, out_j = _run_both("plain", tc, data, BIN_MODEL)
    _assert_text_close(out_t, out_j)
    saves = re.findall(r"Testing at - (\d+)/12", out_t)
    assert saves == ["4", "8", "12"] and "Saved model" in out_t
    meta = __import__("json").load(open(os.path.join(ck, "meta.json")))
    done = meta["iteration"]
    tmodel, _ = _pair("plain", **BIN_MODEL)
    train, test = data(tcriteo)
    reads = []
    real_read = train.read_batch
    train.read_batch = lambda i: reads.append(i) or real_read(i)
    tr = harness.Trainer(tmodel, TrainConfig(**{**tc, "load_model": ck,
                                                "save_model": ""}),
                         train, test, device="cpu")
    state = tr.init_state()
    assert (state.epoch, state.iteration) == (0, done)
    _, out_r = _train(tr, state)
    assert reads == list(range(done, 12))  # the trained batches never read
    first = dict(re.findall(r"it (\d+)/12 of epoch 0, \S+ ms/it, loss (\S+)",
                            out_t))
    again = dict(re.findall(r"it (\d+)/12 of epoch 0, \S+ ms/it, loss (\S+)",
                            out_r))
    assert list(again) == [str(i) for i in range(done + 1, 13)]
    assert all(first[k] == v for k, v in again.items())


def test_inference_only_matches_jax():
    tc = dict(mini_batch_size=8, num_batches=3, inference_only=True,
              mlperf_logging=True)
    ts, out_t, js, out_j = _run_both("plain", tc)
    assert "Finished training" not in out_t and "auc" in out_t
    _assert_text_close(out_t, out_j)


def test_evaluate_drops_padded_rows():
    """A short last test batch is padded with label -1 rows, which the
    accuracy does not count."""
    tmodel, _ = _pair("plain")
    tc = TrainConfig(mini_batch_size=8, data_size=20)
    test = RandomDataset(tmodel.cfg, tc, pad_last_batch=True)
    tr = harness.Trainer(tmodel, tc, [], test, device="cpu")
    state = harness.TrainState(tmodel.init_params(device="cpu"), {})
    probs = []
    real = tr.eval_step
    tr.eval_step = lambda p, b: probs.append(real(p, b)) or probs[-1]
    acc = tr.evaluate(state)["accuracy"]
    labels = np.concatenate([b.labels.ravel() for b in test])
    s = torch.cat(probs).ravel().numpy()
    keep = labels >= 0
    assert labels.size == 24 and keep.sum() == 20
    assert acc == float(np.mean(np.round(s[keep]) == labels[keep]))


def test_multi_process_evaluate_raises(monkeypatch):
    tmodel, _ = _pair("plain")
    tr = harness.Trainer(tmodel, TrainConfig(), [], [], device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        tr.evaluate(harness.TrainState({}, {}))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_fused_step_on_padded_v1_batches_matches_jax(optimizer):
    """The v1 batches are padded [T, B, H] with weight-0 slots (index 0)
    and hits unique and sorted within a bag; those slots reach
    coalesce_rows. Four steps of the port's fused step against JAX's
    make_fused_train_step: every parameter and accumulator within rtol
    1e-4 / atol 1e-5, the losses within 1e-6."""
    tmodel, jmodel = _pair("plain", num_indices_per_lookup=10)
    tc = dict(mini_batch_size=16, num_batches=4)
    batches = list(RandomDataset(tmodel.cfg, TrainConfig(**tc)))
    jbatches = list(JaxRandomDataset(jmodel.cfg, JaxTC(**tc)))
    assert any((hb.wt == 0).any() for hb in batches)
    ts, js = _states(tmodel, jmodel, optimizer)
    tstep = make_fused_train_step(tmodel, optimizer)
    jstep = jax.jit(jax_fused(jmodel, optimizer))
    jp, jo = js.params, js.opt_state
    for hb, jhb in zip(batches, jbatches):
        _, _, tl, _ = tstep(ts.params, ts.opt_state, hb.to_device("cpu"), 0.1)
        jp, jo, jl, _ = jstep(jp, jo, jhb.to_device(), 0.1)
        assert float(tl) == pytest.approx(float(jl), abs=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves((jp, jo.get("accum", {}))),
                    [*harness.ckpt.flatten_with_paths(ts.params).values(),
                     *harness.ckpt.flatten_with_paths(
                         ts.opt_state.get("accum", {})).values()]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-4,
                                   atol=1e-5)
