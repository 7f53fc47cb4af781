"""The port's dense model and embedding pooling against dlrm_tpu's, on the
same numpy inputs and the same parameters (carried with bridge.py).

Tolerances: fp32 values rtol 1e-5 / atol 1e-6 and grads rtol 1e-4 /
atol 1e-5 (the two frameworks sum in different orders); bf16 compute
rtol/atol 2e-2 (one bf16 rounding is 2^-8 relative, and the port rounds the
matmul product before adding the fp32 bias where JAX rounds once after it,
see dlrm_tpu_torch/ops/mlp.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.models import dlrm as jdlrm
from dlrm_tpu.ops import embedding as jemb
from dlrm_tpu.ops import interaction as jint
from dlrm_tpu.ops import mlp as jmlp
from dlrm_tpu_torch.bridge import params_from_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.models import dlrm as tdlrm
from dlrm_tpu_torch.ops import embedding as temb
from dlrm_tpu_torch.ops import interaction as tint
from dlrm_tpu_torch.ops import mlp as tmlp

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a))
    return t.requires_grad_() if grad else t


def _close(t, j, tol):
    np.testing.assert_allclose(
        t.detach().float().numpy(), np.asarray(j, np.float32), **tol
    )


@pytest.mark.parametrize("sigmoid_layer", [-1, 1])
def test_apply_mlp_values_and_grads(sigmoid_layer):
    rng = np.random.default_rng(0)
    layers = _np(jmlp.init_mlp(jax.random.PRNGKey(1), (8, 32, 16, 4)))
    x = rng.normal(size=(24, 8)).astype(np.float32)
    cot = rng.normal(size=(24, 4)).astype(np.float32)

    def jf(ls, xx):
        return jnp.sum(jmlp.apply_mlp(ls, xx, sigmoid_layer) * cot)

    jout = jmlp.apply_mlp(layers, x, sigmoid_layer)
    jgl, jgx = jax.grad(jf, argnums=(0, 1))(layers, x)
    tl = params_from_jax(layers, device="cpu")
    for layer in tl:
        for v in layer.values():
            v.requires_grad_()
    tx = _t(x, grad=True)
    tout = tmlp.apply_mlp(tl, tx, sigmoid_layer)
    _close(tout, jout, VAL)
    (tout * _t(cot)).sum().backward()
    _close(tx.grad, jgx, GRAD)
    for lt, lj in zip(tl, jgl):
        _close(lt["w"].grad, lj["w"], GRAD)
        _close(lt["b"].grad, lj["b"], GRAD)

    # bf16 compute
    jb = jmlp.apply_mlp(layers, jnp.asarray(x, jnp.bfloat16), sigmoid_layer)
    tb = tmlp.apply_mlp(tl, tx.detach().to(torch.bfloat16), sigmoid_layer)
    assert tb.dtype == torch.bfloat16
    _close(tb, np.asarray(jb, np.float32), BF16)


@pytest.mark.parametrize("itself", [False, True])
def test_dot_interaction_values_and_grads(itself):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(16, 8)).astype(np.float32)
    ly = rng.normal(size=(16, 5, 8)).astype(np.float32)
    cot = rng.normal(size=(16, 8 + (6 * 7 if itself else 6 * 5) // 2)
                     ).astype(np.float32)
    jout = jint.dot_interaction(x, ly, itself)
    jgx, jgly = jax.grad(
        lambda a, b: jnp.sum(jint.dot_interaction(a, b, itself) * cot),
        argnums=(0, 1),
    )(x, ly)
    tx, tly = _t(x, grad=True), _t(ly, grad=True)
    tout = tint.dot_interaction(tx, tly, itself)
    assert tout.shape == jout.shape
    _close(tout, jout, VAL)
    (tout * _t(cot)).sum().backward()
    _close(tx.grad, jgx, GRAD)
    _close(tly.grad, jgly, GRAD)

    jb = jint.dot_interaction(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(ly, jnp.bfloat16), itself)
    tb = tint.dot_interaction(tx.detach().to(torch.bfloat16),
                              tly.detach().to(torch.bfloat16), itself)
    assert tb.dtype == torch.bfloat16
    _close(tb, np.asarray(jb, np.float32), BF16)


@pytest.mark.parametrize("layout", ["padded", "flat"])
@pytest.mark.parametrize("weighted", [False, True])
def test_grouped_embedding_bag(layout, weighted):
    rng = np.random.default_rng(2)
    sizes, hot, b, d = (50, 7, 90, 20), (3, 1, 5, 3), 12, 16
    hmax = max(hot)
    stacked = rng.normal(size=(sum(sizes), d)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    idx = np.stack([rng.integers(0, n, (b, hmax)) for n in sizes]
                   ).astype(np.int32)
    wt = rng.uniform(0.5, 1.5, size=idx.shape).astype(np.float32)
    if not weighted:
        wt = None
    if layout == "flat":
        idx = np.concatenate([idx[t, :, :h].ravel() for t, h in enumerate(hot)])
        if wt is not None:
            wt = np.concatenate(
                [wt[t, :, :h].ravel() for t, h in enumerate(hot)]
            )
    jout = jemb.grouped_embedding_bag(
        jnp.asarray(stacked), jnp.asarray(offs), jnp.asarray(idx),
        None if wt is None else jnp.asarray(wt), hot, batch=b,
    )
    tw = None if wt is None else _t(wt)
    tout = temb.grouped_embedding_bag(
        _t(stacked), _t(offs), _t(idx), tw, hot, batch=b
    )
    assert tout.shape == (b, len(sizes), d)
    _close(tout, jout, VAL)

    # bf16 table: pooled comes back in the table dtype
    jb = jemb.grouped_embedding_bag(
        jnp.asarray(stacked, jnp.bfloat16), jnp.asarray(offs),
        jnp.asarray(idx), None if wt is None else jnp.asarray(wt), hot,
        batch=b,
    )
    tb = temb.grouped_embedding_bag(
        _t(stacked).to(torch.bfloat16), _t(offs), _t(idx), tw, hot, batch=b
    )
    assert tb.dtype == torch.bfloat16
    _close(tb, np.asarray(jb, np.float32), BF16)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_with_pad_rows(compute_dtype):
    kw = dict(embedding_dim=16, table_sizes=(40, 30, 20), mlp_bot=(6, 12, 16),
              mlp_top=(24, 8, 1), interaction="dot", loss="bce",
              compute_dtype=compute_dtype)
    jmodel = jdlrm.DLRMModel(JaxConfig(**kw))
    tmodel = tdlrm.DLRMModel(DLRMConfig(**kw))
    params = _np(jmodel.init_params(jax.random.PRNGKey(3)))
    dense_np = {k: v for k, v in params.items() if k != "emb"}
    rng = np.random.default_rng(4)
    b = 20
    dense = rng.normal(size=(b, 6)).astype(np.float32)
    pooled = rng.normal(size=(b, 3, 16)).astype(np.float32)
    labels = rng.integers(0, 2, (b, 1)).astype(np.float32)
    labels[-3:] = -1.0  # pad rows

    def jloss(dp, ly):
        probs, logits = jmodel.forward_from_pooled(dp, dense, ly)
        per = jdlrm.per_example_loss(jmodel.cfg, probs, labels, logits)
        return jdlrm.masked_mean(per, labels), probs

    (jl, jprobs), (jgd, jgp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(dense_np, pooled)

    tp = params_from_jax(dense_np, device="cpu")
    leaves = [v for layer in tp["bot"] + tp["top"] for v in layer.values()]
    for v in leaves:
        v.requires_grad_()
    tpooled = _t(pooled, grad=True)
    probs, logits = tmodel.forward_from_pooled(tp, _t(dense), tpooled)
    per = tdlrm.per_example_loss(tmodel.cfg, probs, _t(labels), logits)
    loss = tdlrm.masked_mean(per, _t(labels))
    loss.backward()
    val, grad = (VAL, GRAD) if compute_dtype == "float32" else (BF16, BF16)
    _close(loss, jl, val)
    _close(probs, jprobs, val)
    _close(tpooled.grad, jgp, grad)
    for part in ("bot", "top"):
        for lt, lj in zip(tp[part], jgd[part]):
            _close(lt["w"].grad, lj["w"], grad)
            _close(lt["b"].grad, lj["b"], grad)
    # pad rows add nothing: their pooled grads are exactly zero
    assert float(tpooled.grad[-3:].abs().max()) == 0.0


@pytest.mark.parametrize("loss,threshold", [("mse", 0.0), ("wbce", 0.0),
                                            ("bce", 0.1)])
def test_per_example_loss_variants(loss, threshold):
    rng = np.random.default_rng(5)
    z = rng.normal(scale=3.0, size=(30, 1)).astype(np.float32)
    p = (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
    p = np.clip(p, threshold, 1 - threshold) if threshold else p
    t = rng.integers(0, 2, (30, 1)).astype(np.float32)
    kw = dict(loss=loss, loss_threshold=threshold, loss_weights=(0.3, 2.0))
    jper = jdlrm.per_example_loss(JaxConfig(**kw), p, t, z)
    tper = tdlrm.per_example_loss(DLRMConfig(**kw), _t(p), _t(t), _t(z))
    _close(tper, jper, VAL)


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_embedding_bag(weighted):
    rng = np.random.default_rng(6)
    sizes, b, h, d = (40, 9, 70), 10, 4, 8
    stacked = rng.normal(size=(sum(sizes), d)).astype(np.float32)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
    idx = np.stack([rng.integers(0, n, (b, h)) for n in sizes]).astype(
        np.int32)
    wt = (rng.uniform(0.5, 1.5, size=idx.shape).astype(np.float32)
          if weighted else None)
    jout = jemb.fused_embedding_bag(
        jnp.asarray(stacked), jnp.asarray(offs), jnp.asarray(idx),
        None if wt is None else jnp.asarray(wt))
    tout = temb.fused_embedding_bag(_t(stacked), _t(offs), _t(idx),
                                    None if wt is None else _t(wt))
    assert tout.shape == (b, len(sizes), d)
    _close(tout, jout, VAL)


def test_init_params_distributions():
    """The reference's init distributions, drawn from a torch.Generator:
    tables U(-sqrt(1/n), sqrt(1/n)), weights N(0, sqrt(2/(m+n))) stored
    [n_in, n_out], biases N(0, sqrt(1/m)); the same seed gives the same
    params."""
    cfg = DLRMConfig(embedding_dim=16, table_sizes=(400, 2500),
                     mlp_bot=(300, 200, 16), mlp_top=(256, 1), loss="bce")
    model = tdlrm.DLRMModel(cfg)
    p = model.init_params(seed=3, device="cpu")
    emb = p["emb"]["stacked"]
    assert emb.shape == (2900, 16)
    for lo, n in ((0, 400), (400, 2500)):
        tab = emb[lo: lo + n]
        bound = (1.0 / n) ** 0.5
        assert float(tab.abs().max()) <= bound
        assert float(tab.abs().max()) > 0.9 * bound
    for layers, ln in ((p["bot"], cfg.mlp_bot), (p["top"], cfg.ln_top)):
        for layer, n_in, n_out in zip(layers, ln[:-1], ln[1:]):
            assert layer["w"].shape == (n_in, n_out)
            want = (2.0 / (n_in + n_out)) ** 0.5
            assert abs(float(layer["w"].std()) / want - 1) < 0.1
    again = model.init_params(seed=3, device="cpu")
    assert torch.equal(again["emb"]["stacked"], emb)
    assert torch.equal(again["top"][0]["w"], p["top"][0]["w"])
