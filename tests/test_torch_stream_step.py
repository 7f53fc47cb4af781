"""The port's streamed train step (dlrm_tpu_torch/train/stream_step.py)
against dlrm_tpu's make_stream_train_step (Pallas kernels in interpret
mode), over 3 steps with identical parameters (bridge.py) and identical
batches, for every fwd_impl/grad_impl combination of
tests/test_stream_step.py. Mirrors its cases with their tolerances: loss
rtol 1e-5 / atol 1e-6 at every step, params and accumulators rtol 1e-4 /
atol 1e-5 after the last (dense elements whose Adagrad grads are all at
rounding level excepted, see _assert_params_close); bf16 tables (round to
nearest on both sides) loss rtol 0.02 and table rtol 0.05 / atol 0.02."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.data.random_data import HostBatch as JaxHostBatch
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.ops.stream_plan import make_stream_plan as jax_make_plan
from dlrm_tpu.train import stream_step as jstep
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops.stream_plan import StreamWork, make_stream_plan
from dlrm_tpu_torch.train import stream_step as tstep

KW = dict(
    embedding_dim=128, table_sizes=(1500, 300, 2200), mlp_bot=(8, 16, 128),
    mlp_top=(64, 8, 1), interaction="dot", loss="bce",
    num_indices_per_lookup=4,
)
B = 32
STEPS = 3
LR = 0.05
LOSS = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _arrays(seed, hot=4, weights="ones", concentrate=None):
    """(dense, idx [T,B,Hmax], wt, labels) numpy arrays. hot: int or
    per-table; weights: "none" (wt=None), "ones" (unit weights on real
    hits, 0 on padding) or "random"."""
    rng = np.random.default_rng(seed)
    hots = hot if isinstance(hot, tuple) else (hot,) * len(KW["table_sizes"])
    hmax = max(hots)
    idx = np.stack([rng.integers(0, n, (B, hmax)) for n in KW["table_sizes"]]
                   ).astype(np.int32)
    if concentrate is not None:
        idx %= concentrate
    wt = np.zeros(idx.shape, np.float32)
    for t, h in enumerate(hots):
        wt[t, :, :h] = (1.0 if weights != "random"
                        else rng.uniform(0.5, 1.5, (B, h)))
    dense = rng.random((B, KW["mlp_bot"][0]), dtype=np.float32)
    labels = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return dense, idx, None if weights == "none" else wt, labels


class Pair:
    """The same model, params and optimizer state on both sides."""

    def __init__(self, optimizer, hot=None, emb_bf16=False, seed=0):
        self.optimizer = optimizer
        self.jmodel = JaxModel(JaxConfig(**KW))
        self.tmodel = DLRMModel(DLRMConfig(**KW))
        if hot is None:
            self.jplan = jstep.plan_for_model(self.jmodel, B, block_rows=1024)
            self.tplan = tstep.plan_for_model(self.tmodel, B, block_rows=1024)
        else:
            args = (KW["table_sizes"], KW["embedding_dim"], B, hot)
            self.jplan = jax_make_plan(*args, block_rows=1024)
            self.tplan = make_stream_plan(*args, block_rows=1024)
        p = jstep.pad_params(
            self.jmodel.init_params(jax.random.PRNGKey(seed)), self.jmodel,
            self.jplan)
        if emb_bf16:
            p = jstep.cast_emb(p, jnp.bfloat16)
        self.jp = _np(p)
        self.js = _np(jstep.init_stream_opt_state(optimizer, p, self.jplan))

    def port_state(self):
        return (params_from_jax(self.jp, device="cpu"),
                params_from_jax(self.js, device="cpu"))

    def jax_state(self):
        return (jax.tree_util.tree_map(jnp.asarray, self.jp),
                jax.tree_util.tree_map(jnp.asarray, self.js))

    def jax_step(self, fwd_impl="gather", grad_impl="gather", **kw):
        return jstep.make_stream_train_step(
            self.jmodel, self.optimizer, self.jplan, fwd_impl=fwd_impl,
            grad_impl=grad_impl, interpret=True, **kw)

    def port_step(self, fwd_impl="gather", grad_impl="gather", **kw):
        return tstep.make_stream_train_step(
            self.tmodel, self.optimizer, self.tplan, fwd_impl=fwd_impl,
            grad_impl=grad_impl, device="cpu", **kw)

    def batches(self, arrays, flat=False, unit=False, touched=False):
        """Device batches for both sides from the same numpy arrays and one
        U-layout: dlrm_tpu's builder's, handed to the port as it is. Any
        order of a block's hits is a valid plan for dlrm_tpu's kernels and
        the port's plain versions; the port's own builder sorts them by row
        (its CUDA K2 needs that), which tests/test_torch_stream_plan.py
        holds equal to both numpy builders."""
        jb, tb = [], []
        fh = self.tplan.hot if flat else None
        for dense, idx, wt, labels in arrays:
            j = JaxHostBatch(dense, idx, wt, labels).with_stream_work(
                self.jplan, unit_weights=unit, update_touched_only=touched)
            t = dataclasses.replace(
                HostBatch(dense, idx, wt, labels),
                stream=StreamWork(**vars(j.stream), touched_only=touched))
            jb.append(j.to_device(flat_hots=fh))
            tb.append(t.to_device("cpu", flat_hots=fh))
        return jb, tb


def _run_both(pair, jbatches, tbatches, jkw=None, tkw=None, loss_tol=LOSS):
    jp, js = pair.jax_state()
    tp, ts = pair.port_state()
    jf, tf = pair.jax_step(**(jkw or {})), pair.port_step(**(tkw or {}))
    for i, (jb, tb) in enumerate(zip(jbatches, tbatches)):
        jp, js, jl, _ = jf(jp, js, jb, LR)
        tp2, ts2, tl, _ = tf(tp, ts, tb, LR)
        assert tp2 is tp and ts2 is ts  # updated in place
        np.testing.assert_allclose(float(tl), float(jl), **loss_tol,
                                   err_msg=f"loss at step {i}")
    assert ts["step"] == len(tbatches)
    return (_np(jp), _np(js)), (params_to_jax(tp), params_to_jax(ts))


def _assert_close_trees(a, b, tol):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), **tol)


def _assert_params_close(tp, jp, js):
    """PARAM tolerance, except for one class of dense-param elements under
    Adagrad: an element whose squared grads sum below 1e-12 has only
    rounding-level grads (|g| < 1e-6, e.g. a unit that one sample barely
    activates), and Adagrad's step lr*g/sqrt(sum g^2) divides that rounding
    noise by itself. Those elements are held to |dw| <= STEPS*lr, the most
    any Adagrad step sequence can move them."""
    accum = js.get("accum")
    for key in tp:
        if accum is None or key == "emb":
            _assert_close_trees(tp[key], jp[key], PARAM)
            continue
        for x, y, a in zip(jax.tree_util.tree_leaves(tp[key]),
                           jax.tree_util.tree_leaves(jp[key]),
                           jax.tree_util.tree_leaves(accum[key])):
            x, y = np.asarray(x, np.float32), np.asarray(y, np.float32)
            noise = np.asarray(a) < 1e-12
            np.testing.assert_allclose(x[~noise], y[~noise], **PARAM)
            assert (np.abs(x - y)[noise] <= STEPS * LR).all()


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_stream_step_matches_jax(optimizer):
    """("gather", "gather"), the padded layout, explicit unit weights."""
    pair = Pair(optimizer)
    jb, tb = pair.batches([_arrays(s, weights="none") for s in range(STEPS)])
    (jp, js), (tp, ts) = _run_both(pair, jb, tb)
    _assert_params_close(tp, jp, js)
    _assert_close_trees(ts, js, PARAM)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("touched", [False, True], ids=["full", "touched"])
def test_port_built_batches_give_the_same_step(optimizer, touched):
    """The port's own builder (each block's hits sorted by row, stably)
    against dlrm_tpu's (scan order), through the port's gather-path step:
    K2 adds each row's hits in the same order under both layouts, so the
    params, accumulators and losses agree to the bit."""
    pair = Pair(optimizer)
    arrays = [_arrays(s) for s in range(STEPS)]
    _, jax_built = pair.batches(arrays, touched=touched)
    port_built = [HostBatch(*a).with_stream_work(
        pair.tplan, update_touched_only=touched).to_device("cpu")
        for a in arrays]
    outs = []
    for batches in (jax_built, port_built):
        tp, ts = pair.port_state()
        step = pair.port_step()
        losses = [float(step(tp, ts, b, LR)[2]) for b in batches]
        outs.append((losses, jax.tree_util.tree_leaves((tp, ts))))
    (la, xa), (lb, xb) = outs
    assert la == lb
    assert len(xa) == len(xb)
    for x, y in zip(xa, xb):
        assert torch.equal(torch.as_tensor(x), torch.as_tensor(y))


def test_stream_step_ragged_hot_sizes():
    """Per-table hot sizes: zero-weight padding columns, the U-space sized
    per table."""
    hot = (4, 1, 3)
    pair = Pair("rwsadagrad", hot=hot)
    jb, tb = pair.batches([_arrays(10 + s, hot=hot) for s in range(STEPS)])
    (jp, js), (tp, ts) = _run_both(pair, jb, tb)
    _assert_params_close(tp, jp, js)
    _assert_close_trees(ts, js, PARAM)


def test_stream_step_flat_per_hit_layout():
    """The flat per-hit device layout with random weights matches JAX's, is
    bit-identical to the port's padded layout, and the eval step's probs
    match JAX's make_stream_eval_step in both layouts."""
    hot = (4, 1, 3)
    pair = Pair("rwsadagrad", hot=hot)
    arrays = [_arrays(20 + s, hot=hot, weights="random") for s in range(STEPS)]
    jb, tb = pair.batches(arrays, flat=True)
    assert tb[0].idx.dim() == 1 and tb[0].idx.shape[0] == B * sum(hot)
    (jp, js), (tp, ts) = _run_both(pair, jb, tb)
    _assert_params_close(tp, jp, js)

    _, tb_pad = pair.batches(arrays)
    outs = []
    for batches in (tb, tb_pad):
        p, s = pair.port_state()
        f = pair.port_step()
        for b in batches:
            _, _, loss, _ = f(p, s, b, LR)
        outs.append((p["emb"]["stacked"].clone(), float(loss)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert outs[0][1] == outs[1][1]

    jev = jstep.make_stream_eval_step(pair.jmodel, pair.jplan)
    tev = tstep.make_stream_eval_step(pair.tmodel, pair.tplan, device="cpu")
    tparams = params_from_jax(tp, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    jb_pad, _ = pair.batches(arrays)
    for j, t in ((jb[0], tb[0]), (jb_pad[0], tb_pad[0])):
        np.testing.assert_allclose(tev(tparams, t).numpy(),
                                   np.asarray(jev(jparams, j)), **LOSS)


@pytest.mark.parametrize("optimizer", ["rwsadagrad"])
def test_unit_weights_batch_matches_full_wts(optimizer):
    """A unit_weights batch (no host wts_u; the step derives it from
    rows_u != -1) trains bit-identically to the full-wts build, and
    matches JAX's unit-weights step."""
    pair = Pair(optimizer)
    arrays = [_arrays(30 + s, weights="none") for s in range(STEPS)]
    jb_u, tb_u = pair.batches(arrays, unit=True)
    assert tb_u[0].stream.wts_u is None
    _, tb_f = pair.batches(arrays)
    outs = []
    for batches in (tb_f, tb_u):
        p, s = pair.port_state()
        f = pair.port_step()
        for b in batches:
            _, _, loss, _ = f(p, s, b, LR)
        outs.append((p["emb"]["stacked"].clone(), float(loss)))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    assert outs[0][1] == outs[1][1]
    (jp, js), (tp, _) = _run_both(pair, jb_u, tb_u)
    _assert_params_close(tp, jp, js)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_touched_only_update_matches_full_revolve(optimizer):
    """Hits concentrated in rows < 80 (one block per table touched): the
    touched-only worklist is shorter and trains bit-identically to the full
    one (untouched blocks survive the in-place update), and matches JAX."""
    pair = Pair(optimizer, seed=3)
    arrays = [_arrays(40 + s, weights="none", concentrate=80)
              for s in range(STEPS)]
    _, tb_full = pair.batches(arrays)
    jb, tb_slim = pair.batches(arrays, touched=True)
    n_full = [b.stream.item_block for b in tb_full]
    assert all(
        int((s.stream.item_block < pair.tplan.pad_block).sum())
        < int((f < pair.tplan.pad_block).sum())
        for s, f in zip(tb_slim, n_full))
    outs = []
    for batches in (tb_full, tb_slim):
        p, s = pair.port_state()
        f = pair.port_step()
        for b in batches:
            _, _, loss, _ = f(p, s, b, LR)
        outs.append((p, s, float(loss)))
    torch.testing.assert_close(outs[0][0]["emb"]["stacked"],
                               outs[1][0]["emb"]["stacked"], rtol=0, atol=0)
    if optimizer != "sgd":
        torch.testing.assert_close(outs[0][1]["accum"]["emb"]["stacked"],
                                   outs[1][1]["accum"]["emb"]["stacked"],
                                   rtol=0, atol=0)
    assert outs[0][2] == outs[1][2]
    (jp, js), (tp, ts) = _run_both(pair, jb, tb_slim)
    _assert_params_close(tp, jp, js)
    _assert_close_trees(ts, js, PARAM)


def test_stream_step_bf16_tables_tracks_jax():
    """bf16 tables and bf16 K2 sums, stochastic rounding off on both sides
    (JAX interpret mode always rounds to nearest): the port tracks JAX over
    3 steps within bf16 tolerance, and after one step tracks the port's own
    fp32 step."""
    pair = Pair("rwsadagrad", emb_bf16=True)
    arrays = [_arrays(50 + s, weights="none") for s in range(STEPS)]
    jb, tb = pair.batches(arrays)
    (jp, _), (tp, _) = _run_both(
        pair, jb, tb,
        jkw=dict(mm_dtype=jnp.bfloat16, stochastic_round=False),
        tkw=dict(mm_dtype=torch.bfloat16, stochastic_round=False),
        loss_tol=dict(rtol=0.02),
    )
    assert tp["emb"]["stacked"].dtype == jp["emb"]["stacked"].dtype
    np.testing.assert_allclose(
        np.asarray(tp["emb"]["stacked"], np.float32),
        np.asarray(jp["emb"]["stacked"], np.float32), rtol=0.05, atol=0.02)

    p16, s16 = pair.port_state()
    pair32 = Pair("rwsadagrad")
    p32, s32 = pair32.port_state()
    _, _, l16, _ = pair.port_step(mm_dtype=torch.bfloat16)(p16, s16, tb[0], LR)
    _, _, l32, _ = pair32.port_step()(p32, s32, tb[0], LR)
    assert p16["emb"]["stacked"].dtype == torch.bfloat16
    np.testing.assert_allclose(float(l16), float(l32), rtol=0.02)
    torch.testing.assert_close(p16["emb"]["stacked"].float(),
                               p32["emb"]["stacked"], rtol=0.05, atol=0.02)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("fwd_impl,grad_impl",
                         [("stream", "onehot"), ("gather", "onehot")])
def test_kernel_paths_match_jax(optimizer, fwd_impl, grad_impl):
    """The streamed forward (K3 + K4) and the one-hot grads (K1) on the
    full item list, the padded layout, unit weights: the batches of
    test_stream_step_matches_jax, so only the kernels differ."""
    pair = Pair(optimizer)
    jb, tb = pair.batches([_arrays(s, weights="none") for s in range(STEPS)])
    impl = dict(fwd_impl=fwd_impl, grad_impl=grad_impl)
    (jp, js), (tp, ts) = _run_both(pair, jb, tb, jkw=impl, tkw=impl)
    _assert_params_close(tp, jp, js)
    _assert_close_trees(ts, js, PARAM)


def test_stream_fwd_ragged_hot_sizes_random_weights():
    """("stream", "onehot") with per-table hot sizes, random weights (K4
    and K1 weigh every slot) and the flat device layout."""
    hot = (4, 1, 3)
    pair = Pair("rwsadagrad", hot=hot)
    arrays = [_arrays(70 + s, hot=hot, weights="random") for s in range(STEPS)]
    jb, tb = pair.batches(arrays, flat=True)
    impl = dict(fwd_impl="stream", grad_impl="onehot")
    (jp, js), (tp, ts) = _run_both(pair, jb, tb, jkw=impl, tkw=impl)
    _assert_params_close(tp, jp, js)
    _assert_close_trees(ts, js, PARAM)


def test_grad_impl_defaults_to_onehot_as_in_jax():
    import inspect

    for fn in (tstep.make_stream_train_step, jstep.make_stream_train_step):
        params = inspect.signature(fn).parameters
        assert params["grad_impl"].default == "onehot"
        assert params["fwd_impl"].default == "gather"


def test_stream_step_rejects_unported_paths():
    pair = Pair("sgd")
    # an unknown option is refused, as JAX's step refuses it
    for kw in (dict(fwd_impl="scatter"), dict(grad_impl="dense")):
        with pytest.raises(ValueError, match="_impl must be"):
            pair.port_step(**kw)
    # the streamed forward needs the full cover list: K3 would leave the
    # tail slots of a touched-only list unwritten
    _, tb = pair.batches([_arrays(0, weights="none")], touched=True)
    assert tb[0].stream.touched_only
    p, s = pair.port_state()
    with pytest.raises(ValueError, match="full item list"):
        pair.port_step(fwd_impl="stream")(p, s, tb[0], LR)
    model = DLRMModel(DLRMConfig(**dict(KW, weighted_pooling="learned")))
    for fwd_impl in ("gather", "stream"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tstep.make_stream_train_step(model, "sgd", pair.tplan,
                                         fwd_impl=fwd_impl, device="cpu")
    model = DLRMModel(DLRMConfig(**dict(KW, interaction="cat")))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.make_stream_train_step(model, "sgd", pair.tplan, device="cpu")
