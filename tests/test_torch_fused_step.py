"""The port's fused sparse train step (dlrm_tpu_torch/train/fused_step.py):
the five tests of tests/test_fused_step.py mirrored on the port (the fused
step equals the port's dense autograd step at fp32 roundoff, params and
accumulators atol 3e-6, loss rtol 1e-5, heavy duplicates included), each
also held against dlrm_tpu's fused step on the same numpy batches and the
same params (bridge.py) at the same tolerances; and the flat per-hit
layout giving the padded layout's parameters bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig, TrainConfig
from dlrm_tpu.data.batch import Batch as JaxBatch
from dlrm_tpu.data.random_data import RandomDataset, fixed_multihot_batch
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.optim.optimizers import init_opt_state as jax_init_opt_state
from dlrm_tpu.train import fused_step as jfused
from dlrm_tpu.train import step as jstep
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.train import fused_step as tfused
from dlrm_tpu_torch.train import step as tstep


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain versions run thousands of tiny ops,
    and with several test processes on one machine the threads of each op
    only contend (the bits do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(
    embedding_dim=8,
    table_sizes=(40, 7, 100),  # tiny table 7 -> guaranteed duplicate hits
    mlp_bot=(4, 8, 8),
    mlp_top=(8, 4, 1),
    loss="bce",
    num_indices_per_lookup=5,
)
JMODEL = JaxModel(JaxConfig(**KW))
TMODEL = DLRMModel(DLRMConfig(**KW))
TOL = dict(atol=3e-6, rtol=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params(seed=1):
    return _np(JMODEL.init_params(jax.random.PRNGKey(seed)))


def _batches(n=4, mb=12):
    tc = TrainConfig(mini_batch_size=mb, num_batches=n, numpy_rand_seed=11)
    return list(RandomDataset(JaxConfig(**KW), tc))


def _port(hb, flat_hots=None):
    return HostBatch(hb.dense, hb.idx, hb.wt, hb.labels).to_device(
        "cpu", flat_hots=flat_hots)


def _run_port(make, optimizer, params0, batches, lr=0.05, **kw):
    p = params_from_jax(params0, device="cpu")
    s = init_opt_state(optimizer, p)
    step = make(TMODEL, optimizer, **kw)
    for b in batches:
        p2, s2, loss, _ = step(p, s, b, lr)
        assert p2 is p and s2 is s  # in place
    assert s["step"] == len(batches)
    return params_to_jax(p), params_to_jax(s), float(loss)


def _run_jax(make, optimizer, params0, batches, lr=0.05):
    p = jax.tree_util.tree_map(jnp.asarray, params0)
    s = jax_init_opt_state(optimizer, p)
    step = make(JMODEL, optimizer)
    for b in batches:
        p, s, loss, _ = step(p, s, b, lr)
    return _np(p), _np(s), float(loss)


def _assert_trees(a, b, tol=TOL, accum=None, max_move=0.0):
    """a and b leaf by leaf within tol. With `accum` (an Adagrad state's
    accumulators for a's params), the dense elements whose squared grads
    sum below 1e-12 are held only to |a - b| <= max_move: Adagrad divides
    their rounding-level grads by themselves (lr * g / sqrt(g^2)), so two
    frameworks' last-bit differences there move them by up to lr a step
    (as in tests/test_torch_stream_step.py)."""
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    acc = ({} if accum is None else
           dict(jax.tree_util.tree_flatten_with_path(accum)[0]))
    for (k, x), (_, y) in zip(la, lb):
        x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
        a_k = acc.get(k)
        noise = (np.zeros(x.shape, bool) if a_k is None or a_k.shape != x.shape
                 else np.asarray(a_k) < 1e-12)
        np.testing.assert_allclose(x[~noise], y[~noise], **tol,
                                   err_msg=str(k))
        assert (np.abs(x - y)[noise] <= max_move).all(), k


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_fused_matches_plain(optimizer):
    """The port's fused step == its dense step; both == JAX's fused step."""
    params0 = _params()
    assert tfused.supports_fused(TMODEL)
    hbs = _batches()
    tb = [_port(hb) for hb in hbs]
    fp, fs, fl = _run_port(tfused.make_fused_train_step, optimizer, params0,
                           tb)
    dp, ds, dl = _run_port(tstep.make_train_step, optimizer, params0, tb)
    np.testing.assert_allclose(fl, dl, rtol=1e-5)
    _assert_trees(fp, dp)
    _assert_trees(fs, ds)
    jp, js, jl = _run_jax(jfused.make_fused_train_step, optimizer, params0,
                          [hb.to_device() for hb in hbs])
    np.testing.assert_allclose(fl, jl, rtol=1e-5)
    _assert_trees(fp, jp)
    _assert_trees(fs, js)


def test_fused_heavy_duplicates():
    """All hits on a handful of rows: coalescing must sum before
    squaring."""
    params0 = _params()
    rng = np.random.default_rng(0)
    hb = fixed_multihot_batch(rng, 4, KW["table_sizes"], 16, 5)
    hb = dataclasses.replace(hb, idx=(hb.idx % 2).astype(np.int32))
    kw = dict(lr=0.1)
    fp, fs, _ = _run_port(tfused.make_fused_train_step, "rwsadagrad",
                          params0, [_port(hb)], **kw)
    dp, ds, _ = _run_port(tstep.make_train_step, "rwsadagrad", params0,
                          [_port(hb)], **kw)
    jp, js, _ = _run_jax(jfused.make_fused_train_step, "rwsadagrad", params0,
                         [hb.to_device()], **kw)
    for other_p, other_s in ((dp, ds), (jp, js)):
        np.testing.assert_allclose(fp["emb"]["stacked"],
                                   other_p["emb"]["stacked"], **TOL)
        np.testing.assert_allclose(fs["accum"]["emb"]["stacked"],
                                   other_s["accum"]["emb"]["stacked"], **TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
def test_fused_runs_longer_than_a_chunk_match_jax(optimizer):
    """Table 1's hits all on two rows, about 1,280 hits a row at batch 512:
    runs longer than twice the coalescing chunk (COALESCE_CHUNK hits),
    which the port sums in chunks and JAX in slot order. The port's fused
    step holds to JAX's and to its own dense step at TOL."""
    from dlrm_tpu_torch.ops.sparse_update import COALESCE_CHUNK
    params0 = _params(6)
    rng = np.random.default_rng(7)
    hb = fixed_multihot_batch(rng, 4, KW["table_sizes"], 512, 5)
    idx = hb.idx.copy()
    idx[1] %= 2
    hb = dataclasses.replace(hb, idx=idx)
    assert np.bincount(idx[1].ravel()).min() > 2 * COALESCE_CHUNK
    fp, fs, fl = _run_port(tfused.make_fused_train_step, optimizer, params0,
                           [_port(hb)])
    dp, ds, dl = _run_port(tstep.make_train_step, optimizer, params0,
                           [_port(hb)])
    jp, js, jl = _run_jax(jfused.make_fused_train_step, optimizer, params0,
                          [hb.to_device()])
    for other_p, other_s, other_l in ((dp, ds, dl), (jp, js, jl)):
        np.testing.assert_allclose(fl, other_l, rtol=1e-5)
        _assert_trees(fp, other_p)
        _assert_trees(fs, other_s)


def _stacked(hbs):
    """Micro-batches stacked on a leading axis, for both sides."""
    fields = ("dense", "idx", "wt", "labels")
    j = JaxBatch(*(None if getattr(hbs[0], f) is None else
                   jnp.stack([jnp.asarray(getattr(h, f)) for h in hbs])
                   for f in fields))
    t = Batch(*(None if getattr(hbs[0], f) is None else
                torch.stack([torch.from_numpy(np.array(getattr(h, f)))
                             for h in hbs])
                for f in fields))
    return j, t


def test_grad_accum_steps_per_group():
    """The grad-accum step (the v1 trainer's --mlperf-grad-accum-iter, whose
    CLI wiring is ROADMAP A10): six micro-batches in two groups of three
    take two optimizer steps, each loss the mean of its group's, and the
    dense grad-accum step equals JAX's."""
    rng = np.random.default_rng(0)
    hbs = [fixed_multihot_batch(rng, 4, KW["table_sizes"], 8, 5)
           for _ in range(6)]
    params0 = _params(2)
    p = params_from_jax(params0, device="cpu")
    s = init_opt_state("sgd", p)
    step = tstep.make_grad_accum_train_step(TMODEL, "sgd", 3)
    jp = jax.tree_util.tree_map(jnp.asarray, params0)
    js = jax_init_opt_state("sgd", jp)
    jstep_ = jstep.make_grad_accum_train_step(JMODEL, "sgd", 3)
    for g in range(2):
        group = hbs[3 * g: 3 * g + 3]
        want = np.mean([float(TMODEL.loss(p, _port(h))) for h in group])
        jb, tb = _stacked(group)
        _, _, loss, probs = step(p, s, tb, 0.05)
        jp, js, jl, _ = jstep_(jp, js, jb, 0.05)
        assert probs is None
        np.testing.assert_allclose(float(loss), want, rtol=1e-6)
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    assert s["step"] == 2
    _assert_trees(params_to_jax(p), _np(jp))


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad"])
def test_fused_grad_accum_matches_plain_accum(optimizer):
    """Grad accumulation composed with the fused sparse update equals the
    dense accumulation step (the same mean-over-accum scaling, one
    optimizer advance per step), on the port and against JAX's."""
    params0 = _params(4)
    tc = TrainConfig(mini_batch_size=8, num_batches=4, numpy_rand_seed=9)
    hbs = list(RandomDataset(JaxConfig(**KW), tc))
    jb, tb = _stacked(hbs)
    accum = len(hbs)
    out = {}
    for name, make in (("dense", tstep.make_grad_accum_train_step),
                       ("fused", tfused.make_fused_grad_accum_train_step)):
        p = params_from_jax(params0, device="cpu")
        s = init_opt_state(optimizer, p)
        _, _, loss, _ = make(TMODEL, optimizer, accum)(p, s, tb, 0.05)
        out[name] = (params_to_jax(p), float(loss), params_to_jax(s))
    tol = dict(atol=2e-6, rtol=0)
    acc = out["fused"][2].get("accum")
    np.testing.assert_allclose(out["dense"][1], out["fused"][1], rtol=1e-6)
    _assert_trees(out["dense"][0], out["fused"][0], tol, acc, 0.05)
    jp, _, jl, _ = jfused.make_fused_grad_accum_train_step(
        JMODEL, optimizer, accum)(
        jax.tree_util.tree_map(jnp.asarray, params0),
        jax_init_opt_state(optimizer, params0), jb, 0.05)
    np.testing.assert_allclose(out["fused"][1], float(jl), rtol=1e-6)
    _assert_trees(out["fused"][0], _np(jp), tol, acc, 0.05)


def test_padded_last_batch_loss_masks_pad_rows():
    """Pad rows (label -1, weight-0 hits) add nothing to the loss or its
    gradients: training on the padded batch equals training on its real
    rows, on the dense and the fused step."""
    params0 = _params()
    rng = np.random.default_rng(3)
    b_real, b_pad = 5, 8
    dense = rng.normal(size=(b_pad, 4)).astype(np.float32)
    dense[b_real:] = 0.0
    idx = np.stack([rng.integers(0, n, (b_pad, 5))
                    for n in KW["table_sizes"]]).astype(np.int32)
    idx[:, b_real:, :] = 0
    wt = np.ones((3, b_pad, 5), np.float32)
    wt[:, b_real:, :] = 0.0
    labels = (rng.random((b_pad, 1)) < 0.5).astype(np.float32)
    labels[b_real:] = -1.0
    padded = HostBatch(dense, idx, wt, labels)
    real = HostBatch(dense[:b_real], idx[:, :b_real], wt[:, :b_real],
                     labels[:b_real])
    for make in (tstep.make_train_step, tfused.make_fused_train_step):
        outs = [_run_port(make, "rwsadagrad", params0,
                          [hb.to_device("cpu")], lr=0.1)
                for hb in (padded, real)]
        # the masked mean sums 8 terms against 5: another association
        np.testing.assert_allclose(outs[0][2], outs[1][2], rtol=1e-6,
                                   err_msg=make.__name__)
        np.testing.assert_allclose(outs[0][0]["emb"]["stacked"],
                                   outs[1][0]["emb"]["stacked"], atol=1e-7)
        np.testing.assert_allclose(outs[0][0]["top"][0]["w"],
                                   outs[1][0]["top"][0]["w"], atol=1e-7)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_flat_layout_gives_the_padded_bits(optimizer):
    """Ragged hot sizes: the flat per-hit layout (what the trainer ships)
    and the padded one with weight-0 padding give the same parameters,
    accumulators and losses to the bit."""
    hots = (3, 1, 5)
    rng = np.random.default_rng(21)
    hbs = []
    for _ in range(3):
        hb = fixed_multihot_batch(rng, 4, KW["table_sizes"], 12, 5)
        wt = rng.uniform(0.5, 1.5, hb.idx.shape).astype(np.float32)
        for t, h in enumerate(hots):
            wt[t, :, h:] = 0.0
        hbs.append(dataclasses.replace(hb, wt=wt))
    params0 = _params(5)
    outs = []
    for flat in (None, hots):
        outs.append(_run_port(tfused.make_fused_train_step, optimizer,
                              params0, [_port(hb, flat) for hb in hbs],
                              hot_sizes=hots))
    assert outs[0][2] == outs[1][2]
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][:2]),
                    jax.tree_util.tree_leaves(outs[1][:2])):
        np.testing.assert_array_equal(a, b)


def test_fused_step_refuses_what_it_does_not_cover():
    weighted = DLRMModel(DLRMConfig(**dict(KW, weighted_pooling="learned")))
    assert not tfused.supports_fused(weighted)
    with pytest.raises(ValueError, match="make_train_step"):
        tfused.make_fused_train_step(weighted, "sgd")
    with pytest.raises(ValueError, match="not supported"):
        tfused.make_fused_train_step(TMODEL, "adam")
    step = tfused.make_fused_train_step(TMODEL, "sgd")
    p = TMODEL.init_params(seed=0, device="cpu")
    hb = fixed_multihot_batch(np.random.default_rng(0), 4,
                              KW["table_sizes"], 4, 5)
    flat = HostBatch(hb.dense, hb.idx, hb.wt, hb.labels).to_device(
        "cpu", flat_hots=(5, 5, 5))
    with pytest.raises(ValueError, match="hot_sizes"):
        step(p, init_opt_state("sgd", p), flat, 0.1)
