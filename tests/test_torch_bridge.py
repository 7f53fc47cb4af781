"""bridge.py: JAX params/opt-state trees -> port -> JAX round trips are
bit-exact in the plain and the stream layouts (pad_params, cast_emb,
init_stream_opt_state), and the port's own layout helpers give the JAX
package's arrays bit for bit."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.train import stream_step as jstep
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.train import stream_step as tstep

KW = dict(
    embedding_dim=128, table_sizes=(1500, 300, 2200), mlp_bot=(8, 16, 128),
    mlp_top=(64, 8, 1), interaction="dot", loss="bce",
    num_indices_per_lookup=4,
)
B = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_trees_bit_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(np.atleast_1d(x).view(np.uint8),
                                      np.atleast_1d(y).view(np.uint8))


@pytest.fixture(scope="module")
def jax_side():
    model = JaxModel(JaxConfig(**KW))
    params = model.init_params(jax.random.PRNGKey(4))
    plan = jstep.plan_for_model(model, B, block_rows=1024)
    return model, params, plan


@pytest.mark.parametrize("layout", ["plain", "padded", "padded_bf16"])
@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad", "adagrad"])
def test_round_trip_bit_exact(jax_side, layout, optimizer):
    model, params, plan = jax_side
    if layout != "plain":
        params = jstep.pad_params(params, model, plan)
    if layout == "padded_bf16":
        params = jstep.cast_emb(params, jnp.bfloat16)
    state = jstep.init_stream_opt_state(optimizer, params, plan)
    # a non-trivial accumulator and step survive the trip too
    state = jax.tree_util.tree_map(
        lambda x: x + 0.25 if x.dtype == jnp.float32 else x + 3, state
    )
    for tree in (params, state):
        t = params_from_jax(_np(tree), device="cpu")
        _assert_trees_bit_equal(params_to_jax(t), _np(tree))
    ts = params_from_jax(_np(state), device="cpu")
    assert ts["step"] == 3 and isinstance(ts["step"], int)
    tp = params_from_jax(_np(params), device="cpu")
    want = torch.bfloat16 if layout == "padded_bf16" else torch.float32
    assert tp["emb"]["stacked"].dtype == want


def test_port_layout_helpers_match_jax(jax_side):
    model, params, plan = jax_side
    tmodel = DLRMModel(DLRMConfig(**KW))
    tplan = tstep.plan_for_model(tmodel, B, block_rows=1024)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(plan)
    tp = params_from_jax(_np(params), device="cpu")

    jp = jstep.pad_params(params, model, plan)
    tpp = tstep.pad_params(tp, tmodel, tplan)
    _assert_trees_bit_equal(params_to_jax(tpp), _np(jp))
    _assert_trees_bit_equal(
        params_to_jax(tstep.unpad_params(tpp, tmodel, tplan)), _np(params)
    )
    _assert_trees_bit_equal(
        params_to_jax(tstep.cast_emb(tpp, torch.bfloat16)),
        _np(jstep.cast_emb(jp, jnp.bfloat16)),
    )
    for optimizer in ("sgd", "rwsadagrad", "adagrad"):
        _assert_trees_bit_equal(
            params_to_jax(tstep.init_stream_opt_state(optimizer, tpp, tplan)),
            _np(jstep.init_stream_opt_state(optimizer, jp, plan)),
        )


@pytest.mark.parametrize("interaction", ["dcn", "projection"])
def test_round_trip_interaction_and_pooling_weights(interaction):
    """A tree with the dcn layer list or proj_w1/proj_w2, v_w, and the
    rwsadagrad state of the plain and the stream layouts crosses bit for
    bit; the port's pad_params/unpad_params move v_w as JAX's do."""
    from dlrm_tpu.config import DCNConfig as JaxDCN
    from dlrm_tpu.optim.optimizers import init_opt_state

    extra = ({"dcn": JaxDCN(2, 16)} if interaction == "dcn"
             else {"proj_interaction_dims": (2,)})
    kw = dict(KW, interaction=interaction, weighted_pooling="learned")
    model = JaxModel(JaxConfig(**kw, **extra))
    params = model.init_params(jax.random.PRNGKey(5))
    params["v_w"] = params["v_w"] * jnp.linspace(0.5, 1.5,
                                                 params["v_w"].shape[0])
    assert "v_w" in params and (
        "dcn" in params if interaction == "dcn" else "proj_w2" in params)
    state = jax.tree_util.tree_map(lambda x: x + 2,
                                   init_opt_state("rwsadagrad", params))
    for tree in (params, state):
        _assert_trees_bit_equal(
            params_to_jax(params_from_jax(_np(tree), device="cpu")),
            _np(tree))
    plan = jstep.plan_for_model(model, B, block_rows=1024)
    tcfg = dict(kw)
    if interaction == "dcn":
        from dlrm_tpu_torch.config import DCNConfig

        tcfg["dcn"] = DCNConfig(2, 16)
    else:
        tcfg["proj_interaction_dims"] = (2,)
    tmodel = DLRMModel(DLRMConfig(**tcfg))
    tplan = tstep.plan_for_model(tmodel, B, block_rows=1024)
    tpp = tstep.pad_params(params_from_jax(_np(params), device="cpu"),
                           tmodel, tplan)
    jp = jstep.pad_params(params, model, plan)
    _assert_trees_bit_equal(params_to_jax(tpp), _np(jp))
    _assert_trees_bit_equal(
        params_to_jax(tstep.unpad_params(tpp, tmodel, tplan)), _np(params))
