"""The port's dense model and embedding pooling against dlrm_tpu's, on the
same numpy inputs and the same parameters (carried with bridge.py).

Tolerances: fp32 values rtol 1e-5 / atol 1e-6 and grads rtol 1e-4 /
atol 1e-5 (the two frameworks sum in different orders); bf16 compute
rtol/atol 2e-2 where several layers compound (one bf16 rounding is 2^-8
relative). A single bf16 product (a tower layer, the dcn and projection
products) rounds once on both sides, after the fp32 bias: its output is
bit-equal to JAX's wherever the two fp32 sums are bit-equal, and within one
bf16 ulp everywhere (_assert_one_rounding)."""

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


# ------------------------------------------------ one rounding per product


def _bf16_order(a) -> np.ndarray:
    """bf16 values (torch or numpy) as integers in value order: adjacent
    bf16 numbers differ by 1."""
    if isinstance(a, torch.Tensor):
        bits = a.detach().view(torch.int16).numpy()
    else:
        bits = np.asarray(a).view(np.int16)
    bits = bits.astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def _f32_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().numpy()
    return np.asarray(a, np.float32).view(np.int32)


def _assert_one_rounding(t_out, j_out, t_pre=None, j_pre=None):
    """bf16 outputs within one ulp everywhere; where the fp32 sums before
    the rounding (same shape as the outputs) are bit-equal, or everywhere
    when every fp32 product of the chain was (t_pre is None), bit-equal."""
    assert t_out.dtype == torch.bfloat16
    ulps = np.abs(_bf16_order(t_out) - _bf16_order(j_out))
    assert ulps.max() <= 1, ulps.max()
    same = (np.ones(ulps.shape, bool) if t_pre is None
            else _f32_bits(t_pre) == _f32_bits(j_pre))
    assert (ulps[same] == 0).all()
    return same


def test_mlp_tower_bf16_rounds_once():
    """C1: each bf16 tower layer is bf16(fp32(x @ w) + b), one rounding,
    as dlrm_tpu/ops/mlp.py:55-59: layer by layer on JAX's own inputs, at
    the v2 dense widths cut to size, the layer's output bit-equal to JAX's
    wherever the fp32 pre-activations are, within one ulp everywhere."""
    rng = np.random.default_rng(11)
    layers = _np(jmlp.init_mlp(jax.random.PRNGKey(5), (13, 64, 32, 16)))
    x = jnp.asarray(rng.normal(size=(256, 13)).astype(np.float32) * 3,
                    jnp.bfloat16)
    for layer, tl in zip(layers, params_from_jax(layers, device="cpu")):
        j_pre = jnp.dot(x, jnp.asarray(layer["w"], jnp.bfloat16),
                        preferred_element_type=jnp.float32) + layer["b"]
        t_x = torch.from_numpy(np.array(x).view(np.int16)).view(
            torch.bfloat16)
        t_pre = tmlp.matmul_f32(t_x, tl["w"], tl["b"])
        assert t_pre.dtype == torch.float32
        j_out = jmlp.apply_mlp([layer], x)
        t_out = tmlp.apply_mlp([tl], t_x)
        same = _assert_one_rounding(t_out, j_out, t_pre, j_pre)
        assert same.mean() > 0.5  # the rule was exercised
        x = j_out
    # the rounding happens once: the port's layer is its fp32 sum rounded
    t_x = torch.randn(8, 13).to(torch.bfloat16)
    tl = params_from_jax(layers, device="cpu")[0]
    want = torch.relu(
        (t_x.float() @ tl["w"].to(torch.bfloat16).float() + tl["b"]
         ).to(torch.bfloat16))
    assert torch.equal(tmlp.apply_mlp([tl], t_x), want)


def _interaction_case(kind, rng):
    """(params, x, ly) of one interaction at a small width: F = 5
    features of d = 8."""
    b, t, d = 24, 4, 8
    n = (t + 1) * d
    x = rng.normal(size=(b, d)).astype(np.float32) * 0.5
    ly = rng.normal(size=(b, t, d)).astype(np.float32) * 0.5
    if kind == "dcn":
        params = [{"v": rng.normal(size=(6, n)).astype(np.float32) * 0.3,
                   "w": rng.normal(size=(n, 6)).astype(np.float32) * 0.3,
                   "b": rng.normal(size=n).astype(np.float32) * 0.1}
                  for _ in range(3)]
    elif kind == "projection":
        params = {"w1": rng.normal(size=(n, 3 * d)).astype(np.float32) * 0.3,
                  "w2": rng.normal(size=(n, 3 * d)).astype(np.float32) * 0.3}
    else:
        params = {}
    return params, x, ly


def _interact(mod, kind, params, x, ly):
    if kind == "cat":
        return mod.cat_interaction(x, ly)
    if kind == "dcn":
        return mod.low_rank_cross_net(params, mod.cat_interaction(x, ly))
    return mod.projection_interaction(x, ly, params["w1"], params["w2"])


@pytest.mark.parametrize("kind", ["cat", "dcn", "projection"])
def test_interactions_values_and_grads(kind):
    """cat, dcn (3 low-rank layers) and projection against dlrm_tpu's:
    fp32 values rtol 1e-5 / atol 1e-6 and grads of every input and weight
    rtol 1e-4 / atol 1e-5; bf16 values one rounding per product."""
    rng = np.random.default_rng(12)
    params, x, ly = _interaction_case(kind, rng)
    jout = _interact(jint, kind, params, x, ly)
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jg = jax.grad(
        lambda p, a, c: jnp.sum(_interact(jint, kind, p, a, c) * cot),
        argnums=(0, 1, 2))(params, x, ly)
    tp = params_from_jax(params, device="cpu")
    for v in jax.tree_util.tree_leaves(tp):
        v.requires_grad_()
    tx, tly = _t(x, grad=True), _t(ly, grad=True)
    tout = _interact(tint, kind, tp, tx, tly)
    assert tout.shape == jout.shape
    _close(tout, jout, VAL)
    (tout * _t(cot)).sum().backward()
    _close(tx.grad, jg[1], GRAD)
    _close(tly.grad, jg[2], GRAD)
    for a, b in zip(jax.tree_util.tree_leaves(tp),
                    jax.tree_util.tree_leaves(jg[0])):
        _close(a.grad, b, GRAD)

    # bf16 compute: every product of the chain on JAX's inputs, then the
    # outputs by the one-rounding rule
    jx, jly = jnp.asarray(x, jnp.bfloat16), jnp.asarray(ly, jnp.bfloat16)
    tbx = torch.from_numpy(np.array(jx).view(np.int16)).view(torch.bfloat16)
    tbly = torch.from_numpy(np.array(jly).view(np.int16)).view(
        torch.bfloat16)
    tpd = params_from_jax(params, device="cpu")
    j16 = _interact(jint, kind, params, jx, jly)
    t16 = _interact(tint, kind, tpd, tbx, tbly)
    products_equal = True
    feats = jint.cat_interaction(jx, jly)
    tfeats = tint.cat_interaction(tbx, tbly)
    if kind == "dcn":
        for lj, lt in zip(params, tpd):
            low_j = jnp.einsum("bn,rn->br", feats, lj["v"].astype(feats.dtype),
                               preferred_element_type=jnp.float32)
            low_t = tmlp.matmul_f32(tfeats, lt["v"].t())
            products_equal &= bool(
                (_f32_bits(low_t) == _f32_bits(low_j)).all())
            low = low_j.astype(jnp.bfloat16)
            up_j = jnp.einsum("br,nr->bn", low, lj["w"].astype(low.dtype),
                              preferred_element_type=jnp.float32)
            up_t = tmlp.matmul_f32(
                torch.from_numpy(np.array(low).view(np.int16)).view(
                    torch.bfloat16), lt["w"].t())
            products_equal &= bool((_f32_bits(up_t) == _f32_bits(up_j)).all())
            feats = jint.low_rank_cross_net([lj], feats)
            tfeats = torch.from_numpy(np.array(feats).view(np.int16)).view(
                torch.bfloat16)
    elif kind == "projection":
        for w in ("w1", "w2"):
            pj = jnp.einsum("bf,fk->bk", feats, params[w].astype(feats.dtype),
                            preferred_element_type=jnp.float32)
            pt = tmlp.matmul_f32(tfeats, tpd[w])
            products_equal &= bool((_f32_bits(pt) == _f32_bits(pj)).all())
    if products_equal:
        _assert_one_rounding(t16, j16)
    else:
        # a product differs in its last fp32 bit: one rounding apart,
        # compounded through the chain
        _close(t16, np.asarray(j16, np.float32), BF16)


@pytest.mark.parametrize("interaction", ["dot", "cat", "dcn", "projection"])
@pytest.mark.parametrize("weighted", [None, "learned", "fixed"])
def test_model_loss_and_grads(interaction, weighted):
    """DLRMModel.loss_and_prob and its gradients over the whole params tree
    (table, v_w, towers, interaction weights) against dlrm_tpu's on a
    padded batch with random weights: the dense step's function. fp32;
    "fixed" v_w takes no gradient on either side."""
    kw = dict(embedding_dim=8, table_sizes=(40, 9, 70), mlp_bot=(4, 16, 8),
              mlp_top=(16, 1), interaction=interaction, loss="bce",
              num_indices_per_lookup=3, weighted_pooling=weighted)
    if interaction == "dcn":
        from dlrm_tpu.config import DCNConfig as JaxDCN
        from dlrm_tpu_torch.config import DCNConfig

        jcfg = JaxConfig(**kw, dcn=JaxDCN(2, 5))
        tcfg = DLRMConfig(**kw, dcn=DCNConfig(2, 5))
    else:
        extra = ({"proj_interaction_dims": (2,)}
                 if interaction == "projection" else {})
        jcfg, tcfg = JaxConfig(**kw, **extra), DLRMConfig(**kw, **extra)
    jmodel, tmodel = jdlrm.DLRMModel(jcfg), tdlrm.DLRMModel(tcfg)
    params = _np(jmodel.init_params(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(8)
    if weighted:
        params["v_w"] = rng.uniform(0.5, 1.5, params["v_w"].shape).astype(
            np.float32)
    b = 12
    idx = np.stack([rng.integers(0, n, (b, 3)) for n in kw["table_sizes"]]
                   ).astype(np.int32)
    wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    dense = rng.normal(size=(b, 4)).astype(np.float32)
    labels = rng.integers(0, 2, (b, 1)).astype(np.float32)
    from dlrm_tpu.data.batch import Batch as JBatch
    from dlrm_tpu_torch.data.batch import Batch as TBatch

    jb = JBatch(dense=dense, idx=idx, wt=wt, labels=labels)
    (jl, jp), jg = jax.value_and_grad(
        lambda p: jmodel.loss_and_prob(p, jb), has_aux=True)(params)
    tp = params_from_jax(params, device="cpu")
    for v in jax.tree_util.tree_leaves(tp):
        v.requires_grad_()
    tb = TBatch(_t(dense), _t(idx), _t(wt), _t(labels))
    tl, tprob = tmodel.loss_and_prob(tp, tb)
    _close(tl, jl, VAL)
    _close(tprob, jp, VAL)
    tl.backward()
    for (path, g), t in zip(jax.tree_util.tree_flatten_with_path(jg)[0],
                            jax.tree_util.tree_leaves(tp)):
        if t.grad is None:  # fixed v_w: detached, JAX's grad is zero
            assert weighted == "fixed" and "v_w" in str(path)
            assert not np.asarray(g).any()
            continue
        _close(t.grad, g, GRAD)
    np.testing.assert_allclose(tmodel.apply(tp, tb).detach().numpy(),
                               np.asarray(jmodel.apply(params, jb)), **VAL)


def test_embedding_bag_single_table():
    rng = np.random.default_rng(9)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    idx = rng.integers(0, 30, (10, 4)).astype(np.int32)
    wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32)
    for w in (None, wt):
        jout = jemb.embedding_bag(table, idx, w)
        tout = temb.embedding_bag(_t(table), _t(idx),
                                  None if w is None else _t(w))
        _close(tout, jout, VAL)


def test_init_params_interaction_and_pooling_weights():
    """v_w starts at ones; the dcn layers (v [r, n], w [n, r] Xavier-
    uniform, b zeros) and the projection weights [F*d, p*d] have the JAX
    package's shapes and bounds; the tree crosses the bridge as JAX's
    does."""
    from dlrm_tpu_torch.config import DCNConfig

    base = dict(embedding_dim=8, table_sizes=(40, 9), mlp_bot=(4, 8),
                mlp_top=(8, 1), loss="bce")
    m = tdlrm.DLRMModel(DLRMConfig(**base, interaction="dcn",
                                   dcn=DCNConfig(2, 6),
                                   weighted_pooling="learned"))
    p = m.init_params(seed=1, device="cpu")
    assert torch.equal(p["v_w"], torch.ones(49))
    assert len(p["dcn"]) == 2
    for layer in p["dcn"]:
        assert layer["v"].shape == (6, 24) and layer["w"].shape == (24, 6)
        a = (6.0 / 30) ** 0.5
        assert float(layer["v"].abs().max()) <= a
        assert not layer["b"].any()
    m = tdlrm.DLRMModel(DLRMConfig(**base, interaction="projection",
                                   proj_interaction_dims=(4,)))
    p = m.init_params(seed=1, device="cpu")
    assert p["proj_w1"].shape == p["proj_w2"].shape == (24, 32)
    assert not torch.equal(p["proj_w1"], p["proj_w2"])
    jp = jdlrm.DLRMModel(JaxConfig(**base, interaction="projection",
                                   proj_interaction_dims=(4,))).init_params(
        jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(_np(jp))
            == jax.tree_util.tree_structure(p))


# ------------------------------------------------ QR and MD tables (the v1 CLI)


@pytest.mark.parametrize("op", ["mult", "add", "concat"])
@pytest.mark.parametrize("weighted", [False, True])
def test_qr_embedding_bag_values_and_grads(op, weighted):
    """Each bag pooled in the quotient and the remainder table, then the
    two pooled vectors combined: values and both tables' grads."""
    rng = np.random.default_rng(10)
    c, m = 3, (2 if op == "concat" else 4)
    q = rng.normal(size=(14, m)).astype(np.float32)
    r = rng.normal(size=(c, m)).astype(np.float32)
    idx = rng.integers(0, 40, (9, 5)).astype(np.int32)
    wt = rng.uniform(0.5, 1.5, idx.shape).astype(np.float32) if weighted \
        else None
    cot = rng.normal(size=(9, 4)).astype(np.float32)

    def jf(qq, rr):
        return jnp.sum(jemb.qr_embedding_bag(qq, rr, c, op, idx, wt) * cot)

    jout = jemb.qr_embedding_bag(q, r, c, op, idx, wt)
    jgq, jgr = jax.grad(jf, argnums=(0, 1))(q, r)
    tq, tr = _t(q, grad=True), _t(r, grad=True)
    tout = temb.qr_embedding_bag(tq, tr, c, op, _t(idx).long(),
                                 None if wt is None else _t(wt))
    _close(tout, jout, VAL)
    (tout * _t(cot)).sum().backward()
    _close(tq.grad, jgq, GRAD)
    _close(tr.grad, jgr, GRAD)
    with pytest.raises(ValueError, match="not supported"):
        temb.qr_embedding_bag(tq, tr, c, "max", _t(idx).long())


def _trick_configs(trick, weighted):
    from dlrm_tpu.config import MDConfig as JaxMD
    from dlrm_tpu.config import QRConfig as JaxQR
    from dlrm_tpu_torch.config import MDConfig, QRConfig

    kw = dict(embedding_dim=4, table_sizes=(40, 9, 300, 70),
              mlp_bot=(5, 8, 4), mlp_top=(8, 1), loss="bce",
              num_indices_per_lookup=6, weighted_pooling=weighted)
    if trick == "md":
        return (JaxConfig(**kw, md=JaxMD(threshold=20)),
                DLRMConfig(**kw, md=MDConfig(threshold=20)))
    op = trick.split("-")[1]
    return (JaxConfig(**kw, qr=JaxQR(collisions=3, threshold=20, operation=op)),
            DLRMConfig(**kw, qr=QRConfig(collisions=3, threshold=20,
                                         operation=op)))


@pytest.mark.parametrize("trick", ["qr-mult", "qr-add", "qr-concat", "md"])
@pytest.mark.parametrize("weighted", [None, "learned"])
def test_qr_md_forward_and_dense_step_grads(trick, weighted):
    """QR and MD models (per-table entries: q/r, w + proj for the narrower
    MD tables, w for the small ones): the loss, the probabilities and the
    grads of every leaf against dlrm_tpu's on a padded batch with weight-0
    slots; then one dense step (rwsadagrad: row-wise for w, q and r,
    element-wise for proj) to the same params."""
    from dlrm_tpu.data.batch import Batch as JBatch
    from dlrm_tpu.optim.optimizers import apply_updates as japply
    from dlrm_tpu.optim.optimizers import init_opt_state as jinit
    from dlrm_tpu_torch.data.batch import Batch as TBatch
    from dlrm_tpu_torch.optim.optimizers import init_opt_state
    from dlrm_tpu_torch.train.step import make_train_step

    jcfg, tcfg = _trick_configs(trick, weighted)
    jmodel, tmodel = jdlrm.DLRMModel(jcfg), tdlrm.DLRMModel(tcfg)
    assert tmodel.table_dims == jmodel.table_dims
    params = _np(jmodel.init_params(jax.random.PRNGKey(3)))
    if trick == "md":
        assert "proj" in params["emb"]["tables"][2]
    rng = np.random.default_rng(4)
    b = 10
    idx = np.stack([rng.integers(0, n, (b, 6)) for n in jcfg.table_sizes]
                   ).astype(np.int32)
    wt = (rng.random(idx.shape) < 0.8).astype(np.float32)
    idx[wt == 0] = 0
    dense = rng.normal(size=(b, 5)).astype(np.float32)
    labels = rng.integers(0, 2, (b, 1)).astype(np.float32)
    jb = JBatch(dense=dense, idx=idx, wt=wt, labels=labels)
    (jl, jp), jg = jax.value_and_grad(
        lambda p: jmodel.loss_and_prob(p, jb), has_aux=True)(params)
    tp = params_from_jax(params, device="cpu")
    for v in jax.tree_util.tree_leaves(tp):
        v.requires_grad_()
    tb = TBatch(_t(dense), _t(idx), _t(wt), _t(labels))
    tl, tprob = tmodel.loss_and_prob(tp, tb)
    _close(tl, jl, VAL)
    _close(tprob, jp, VAL)
    tl.backward()
    for g, t in zip(jax.tree_util.tree_leaves(jg),
                    jax.tree_util.tree_leaves(tp)):
        _close(t.grad, g, GRAD)
    # one dense step
    jo = jinit("rwsadagrad", params)
    jp2, _ = japply("rwsadagrad", params, jg, jo, 0.1)
    tp = params_from_jax(params, device="cpu")
    to = init_opt_state("rwsadagrad", tp)
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(to["accum"])] \
        == [a.shape for a in jax.tree_util.tree_leaves(jo["accum"])]
    make_train_step(tmodel, "rwsadagrad")(tp, to, tb, 0.1)
    for a, t in zip(jax.tree_util.tree_leaves(jp2),
                    jax.tree_util.tree_leaves(tp)):
        _close(t, a, GRAD)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(weighted_pooling="fixed"),
    dict(md_threshold=20),
    dict(md_threshold=20, weighted_pooling="learned", md_round=True),
], ids=["plain", "weighted", "md", "md-round-weighted"])
def test_init_params_numpy_equals_jax(cfg):
    """The reference's numpy-stream init (tables, then the bottom MLP,
    then the top MLP; MD projections from a private stream): the JAX
    package's numbers bit for bit, and the global stream left where JAX
    leaves it."""
    from dlrm_tpu.config import MDConfig as JaxMD
    from dlrm_tpu_torch.config import MDConfig

    kw = dict(embedding_dim=4, table_sizes=(40, 9, 300), mlp_bot=(5, 8, 4),
              mlp_top=(8, 1), weighted_pooling=cfg.get("weighted_pooling"))
    j_kw, t_kw = dict(kw), dict(kw)
    if "md_threshold" in cfg:
        j_kw["md"] = JaxMD(threshold=20, round_dims=cfg.get("md_round", False))
        t_kw["md"] = MDConfig(threshold=20,
                              round_dims=cfg.get("md_round", False))
    np.random.seed(5)
    jp = _np(jdlrm.DLRMModel(JaxConfig(**j_kw)).init_params_numpy())
    j_next = np.random.rand()
    np.random.seed(5)
    tp = tdlrm.DLRMModel(DLRMConfig(**t_kw)).init_params_numpy(device="cpu")
    assert np.random.rand() == j_next
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(tp))
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)


def test_init_params_numpy_interaction_and_qr():
    """The dcn weights are seeded from the global stream without drawing
    from it (JAX draws them with jax.random: the same shapes, other
    numbers); QR tables have no numpy init and raise, as in JAX."""
    from dlrm_tpu_torch.config import QRConfig

    kw = dict(embedding_dim=4, table_sizes=(40, 9), mlp_bot=(5, 4),
              mlp_top=(8, 1), interaction="dcn")
    np.random.seed(2)
    jp = _np(jdlrm.DLRMModel(JaxConfig(**kw)).init_params_numpy())
    np.random.seed(2)
    tp = tdlrm.DLRMModel(DLRMConfig(**kw)).init_params_numpy(device="cpu")
    assert [a.shape for a in jax.tree_util.tree_leaves(jp["dcn"])] == [
        tuple(t.shape) for t in jax.tree_util.tree_leaves(tp["dcn"])]
    np.testing.assert_array_equal(tp["bot"][0]["w"].numpy(),
                                  jp["bot"][0]["w"])
    m = tdlrm.DLRMModel(DLRMConfig(**{**kw, "interaction": "dot"},
                                   qr=QRConfig(threshold=10)))
    with pytest.raises(NotImplementedError, match="QR"):
        m.init_params_numpy(device="cpu")


@pytest.mark.parametrize("trick", ["qr-mult", "qr-concat", "md"])
def test_init_params_qr_md_tree_and_bounds(trick):
    """init_params (a torch.Generator) draws the JAX package's tree: the
    same shapes for q, r, w and proj; tables within U(-sqrt(1/n),
    sqrt(1/n)) of their table's n."""
    jcfg, tcfg = _trick_configs(trick, "fixed")
    jp = _np(jdlrm.DLRMModel(jcfg).init_params(jax.random.PRNGKey(0)))
    tp = tdlrm.DLRMModel(tcfg).init_params(seed=0, device="cpu")
    assert (jax.tree_util.tree_structure(jp)
            == jax.tree_util.tree_structure(tp))
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(tp)):
        assert tuple(t.shape) == a.shape
    for n, entry in zip(tcfg.table_sizes, tp["emb"]["tables"]):
        for k in ("q", "r", "w"):
            if k in entry:
                assert float(entry[k].abs().max()) <= (1.0 / n) ** 0.5
