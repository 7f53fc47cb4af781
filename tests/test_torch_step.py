"""The port's dense autograd train and eval steps (dlrm_tpu_torch/train/
step.py) against dlrm_tpu/train/step.py: the same numpy batches and params
(bridge.py), 3 steps of every optimizer, with the dot, dcn and projection
interactions and weighted pooling (v_w learned, or fixed and exactly kept).
Loss rtol 1e-5 at every step; params and accumulators rtol 1e-4 /
atol 1e-5 after the last (tests/test_torch_stream_step.py's tolerances,
with its rule for Adagrad's rounding-level elements); eval probs
rtol 1e-5 / atol 1e-6. The flat per-hit layout trains as the padded one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DCNConfig as JaxDCN, DLRMConfig as JaxConfig
from dlrm_tpu.data.random_data import HostBatch as JaxHostBatch
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.optim.optimizers import init_opt_state as jax_init_opt_state
from dlrm_tpu.train import step as jstep
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DCNConfig, DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import init_opt_state
from dlrm_tpu_torch.train import step as tstep

KW = dict(embedding_dim=8, table_sizes=(40, 9, 70), mlp_bot=(6, 16, 8),
          mlp_top=(16, 4, 1), loss="bce", num_indices_per_lookup=4)
B = 16
STEPS = 3
LR = 0.05
LOSS = dict(rtol=1e-5, atol=1e-6)
PARAM = dict(rtol=1e-4, atol=1e-5)


def _models(interaction="dot", weighted=None):
    kw = dict(KW, interaction=interaction, weighted_pooling=weighted)
    jextra, textra = {}, {}
    if interaction == "dcn":
        jextra, textra = {"dcn": JaxDCN(2, 6)}, {"dcn": DCNConfig(2, 6)}
    elif interaction == "projection":
        jextra = textra = {"proj_interaction_dims": (3,)}
    return (JaxModel(JaxConfig(**kw, **jextra)),
            DLRMModel(DLRMConfig(**kw, **textra)))


def _arrays(seed, hots=(4, 4, 4)):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, n, (B, 4)) for n in KW["table_sizes"]]
                   ).astype(np.int32)
    wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    for t, h in enumerate(hots):
        wt[t, :, h:] = 0.0
    dense = rng.random((B, KW["mlp_bot"][0]), dtype=np.float32)
    labels = (rng.random((B, 1)) < 0.5).astype(np.float32)
    return dense, idx, wt, labels


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_params_close(tp, jp, accum):
    """PARAM, except for Adagrad's rounding-level dense elements (squared
    grads summing below 1e-12), held to |dw| <= STEPS * LR."""
    acc = ({} if accum is None else
           dict(jax.tree_util.tree_flatten_with_path(accum)[0]))
    for (k, x), (_, y) in zip(jax.tree_util.tree_flatten_with_path(tp)[0],
                              jax.tree_util.tree_flatten_with_path(jp)[0]):
        x, y = np.asarray(x), np.asarray(y)
        a = acc.get(k)
        noise = (np.zeros(x.shape, bool) if a is None or a.shape != x.shape
                 or k[0].key == "emb" else np.asarray(a) < 1e-12)
        np.testing.assert_allclose(x[~noise], y[~noise], **PARAM,
                                   err_msg=str(k))
        assert (np.abs(x - y)[noise] <= STEPS * LR).all()


def _run_both(optimizer, interaction="dot", weighted=None, seed=0):
    jmodel, tmodel = _models(interaction, weighted)
    params = _np(jmodel.init_params(jax.random.PRNGKey(seed)))
    if weighted:
        params["v_w"] = np.random.default_rng(1).uniform(
            0.5, 1.5, params["v_w"].shape).astype(np.float32)
    arrays = [_arrays(10 + s) for s in range(STEPS)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax_init_opt_state(optimizer, jp)
    tp = params_from_jax(params, device="cpu")
    ts = init_opt_state(optimizer, tp)
    assert (jax.tree_util.tree_structure(params_to_jax(ts))
            == jax.tree_util.tree_structure(_np(js)))
    jf = jstep.make_train_step(jmodel, optimizer)
    tf = tstep.make_train_step(tmodel, optimizer)
    for i, a in enumerate(arrays):
        jp, js, jl, _ = jf(jp, js, JaxHostBatch(*a).to_device(), LR)
        tp2, ts2, tl, _ = tf(tp, ts, HostBatch(*a).to_device("cpu"), LR)
        assert tp2 is tp and ts2 is ts
        np.testing.assert_allclose(float(tl), float(jl), **LOSS,
                                   err_msg=f"loss at step {i}")
    assert ts["step"] == STEPS
    return (jmodel, tmodel, params, arrays, _np(jp), _np(js),
            params_to_jax(tp), params_to_jax(ts))


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("interaction", ["dot", "dcn", "projection"])
def test_dense_step_matches_jax(optimizer, interaction):
    *_, jp, js, tp, ts = _run_both(optimizer, interaction)
    _assert_params_close(tp, jp, ts.get("accum"))
    for x, y in zip(jax.tree_util.tree_leaves(ts),
                    jax.tree_util.tree_leaves(js)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), **PARAM)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
@pytest.mark.parametrize("mode", ["learned", "fixed"])
def test_dense_step_weighted_pooling_matches_jax(optimizer, mode):
    """learned: v_w moves and matches JAX's; fixed: v_w keeps every bit
    (a zero grad: sgd subtracts lr * 0, Adagrad adds 0 and subtracts
    lr * 0 / (0 + eps)), while the table trains."""
    _, _, params, _, jp, js, tp, ts = _run_both(optimizer, weighted=mode)
    _assert_params_close(tp, jp, ts.get("accum"))
    if mode == "fixed":
        np.testing.assert_array_equal(tp["v_w"], params["v_w"])
    else:
        assert np.abs(tp["v_w"] - params["v_w"]).max() > 0
    assert np.abs(tp["emb"]["stacked"] - params["emb"]["stacked"]).max() > 0


@pytest.mark.parametrize("weighted", [None, "learned"])
def test_eval_step_matches_jax(weighted):
    jmodel, tmodel, _, arrays, jp, _, tp, _ = _run_both(
        "rwsadagrad", "projection", weighted)
    jev = jstep.make_eval_step(jmodel)
    tev = tstep.make_eval_step(tmodel)
    tparams = params_from_jax(tp, device="cpu")
    for a in arrays:
        np.testing.assert_allclose(
            tev(tparams, HostBatch(*a).to_device("cpu")).numpy(),
            np.asarray(jev(jax.tree_util.tree_map(jnp.asarray, tp),
                           JaxHostBatch(*a).to_device())), **LOSS)


@pytest.mark.parametrize("weighted", [None, "learned"])
def test_flat_layout_trains_as_padded(weighted):
    """Ragged hot sizes: the flat per-hit layout and the padded one with
    weight-0 padding give the same loss and params (the padding's terms
    are zero; the sums of the dense grads may associate differently)."""
    hots = (3, 1, 4)
    _, tmodel = _models("dcn", weighted)
    params = tmodel.init_params(seed=3, device="cpu")
    arrays = [_arrays(30 + s, hots) for s in range(STEPS)]
    outs = []
    for flat in (None, hots):
        p = params_from_jax(params_to_jax(params), device="cpu")
        s = init_opt_state("rwsadagrad", p)
        step = tstep.make_train_step(tmodel, "rwsadagrad", hot_sizes=hots)
        losses = [float(step(p, s, HostBatch(*a).to_device(
            "cpu", flat_hots=flat), LR)[2]) for a in arrays]
        outs.append((losses, params_to_jax(p)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=1e-6)
    for x, y in zip(jax.tree_util.tree_leaves(outs[0][1]),
                    jax.tree_util.tree_leaves(outs[1][1])):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6)


def test_grad_accum_step_matches_jax():
    """make_grad_accum_train_step against JAX's: rwsadagrad (the table
    row-wise) over 3 stacked micro-batches."""
    from dlrm_tpu.data.batch import Batch as JBatch
    from dlrm_tpu_torch.data.batch import Batch as TBatch

    jmodel, tmodel = _models("dot", "learned")
    params = _np(jmodel.init_params(jax.random.PRNGKey(4)))
    arrays = [_arrays(40 + s) for s in range(3)]
    stack = [np.stack([a[i] for a in arrays]) for i in range(4)]
    jp, js, jl, _ = jstep.make_grad_accum_train_step(
        jmodel, "rwsadagrad", 3)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax_init_opt_state("rwsadagrad", params),
        JBatch(*(jnp.asarray(x) for x in stack)), LR)
    tp = params_from_jax(params, device="cpu")
    ts = init_opt_state("rwsadagrad", tp)
    _, _, tl, probs = tstep.make_grad_accum_train_step(
        tmodel, "rwsadagrad", 3)(
        tp, ts, TBatch(*(torch.from_numpy(x) for x in stack)), LR)
    assert probs is None and ts["step"] == 1
    np.testing.assert_allclose(float(tl), float(jl), **LOSS)
    _assert_params_close(params_to_jax(tp), _np(jp),
                         params_to_jax(ts)["accum"])


def test_optimizer_state_table_branch():
    """init_opt_state's rwsadagrad tree: one accumulator per table row
    under "emb", element-wise elsewhere (v_w, towers, dcn); adagrad
    element-wise everywhere; the step kept."""
    _, tmodel = _models("dcn", "learned")
    p = tmodel.init_params(seed=0, device="cpu")
    s = init_opt_state("rwsadagrad", p)
    assert s["step"] == 0
    assert s["accum"]["emb"]["stacked"].shape == (sum(KW["table_sizes"]),)
    assert s["accum"]["v_w"].shape == p["v_w"].shape
    assert s["accum"]["dcn"][0]["v"].shape == p["dcn"][0]["v"].shape
    s = init_opt_state("adagrad", p)
    assert s["accum"]["emb"]["stacked"].shape == p["emb"]["stacked"].shape
    assert init_opt_state("sgd", p) == {"step": 0}
    with pytest.raises(ValueError, match="not supported"):
        init_opt_state("adam", p)
    md = {"emb": {"tables": [{"w": torch.ones(5, 4),
                              "proj": torch.ones(4, 8)}]}}
    s = init_opt_state("rwsadagrad", md)
    assert s["accum"]["emb"]["tables"][0]["w"].shape == (5,)
    assert s["accum"]["emb"]["tables"][0]["proj"].shape == (4, 8)
