"""torchrec's DLRM_Projection in the port (two MLP branches,
ops/interaction.py; the config's interaction_branch{1,2}_layer_sizes) held
on the CPU to the benchmark's plain reference,
port_bench/reference/dlrm_proj_ref.py (imported by path), at D 8, 5 tables
and branches 64-32 and 64-48 (F1 4, F2 6): the forward, the loss, every
leaf's gradient, three fused steps under rwsadagrad, the bmm's layout, the
ReLU after the last branch layer, v2_main's parse of both branch flags on
the fused and streamed paths, the divisibility check, the interaction's
traced backward (the same bits as plain autograd), quantized branches and
the new leaves through the bridge, checkpoints and export. The simplified
single-linear form keeps its tests (test_torch_model.py and the others,
against the JAX package).

Tolerances: in fp32 compute the port and the reference take the same
products and differ only in the order of a few fp32 sums (the masked mean
of the loss, autograd's accumulation), so rtol 1e-5 (1e-4 on norms after
three Adagrad steps); the bf16 forward rounds each of five layers to 8
bits, so its probabilities are held within 1e-2."""

import contextlib
import importlib.util
import io
import os
import re

import pytest
import torch

from dlrm_tpu_torch import v2_main
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.batch import Batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.ops.interaction import projection_interaction
from dlrm_tpu_torch.optim.optimizers import init_opt_state, tree_map
from dlrm_tpu_torch.tools.export import export_program
from dlrm_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from dlrm_tpu_torch.train.fused_step import make_fused_train_step
from dlrm_tpu_torch.utils import profiling

_spec = importlib.util.spec_from_file_location(
    "dlrm_proj_ref", os.path.join(os.path.dirname(__file__), os.pardir,
                                  "port_bench", "reference",
                                  "dlrm_proj_ref.py"))
REF = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(REF)

D, SIZES, B = 8, (30, 7, 50, 40, 3), 64
CPU = torch.device("cpu")


def config(dtype="float32", b1=(64, 32), b2=(64, 48)) -> DLRMConfig:
    return DLRMConfig(embedding_dim=D, table_sizes=SIZES, mlp_bot=(13, 16, D),
                      mlp_top=(16, 1), interaction="projection",
                      interaction_branch1_layer_sizes=b1,
                      interaction_branch2_layer_sizes=b2, loss="bce",
                      num_indices_per_lookup=1, compute_dtype=dtype)


def dense_of(params) -> dict:
    return {k: v for k, v in params.items() if k != "emb"}


def batch(seed: int):
    """(Batch in the flat one-hot layout, each table's [B, 1] ids)."""
    gen = torch.Generator().manual_seed(seed)
    ids = [torch.randint(0, n, (B, 1), generator=gen) for n in SIZES]
    return Batch(dense=torch.randn((B, 13), generator=gen),
                 idx=torch.cat([i.reshape(-1) for i in ids]).int(), wt=None,
                 labels=(torch.rand((B, 1), generator=gen) < 0.3).float()
                 ), ids


def pooled_of(params, ids) -> torch.Tensor:
    model_offs = [0] + list(torch.tensor(SIZES).cumsum(0)[:-1].tolist())
    table = params["emb"]["stacked"]
    return torch.stack([table[i[:, 0] + o] for i, o in zip(ids, model_offs)],
                       dim=1)


def ref_grads(dense, feats, pooled, labels):
    leaves = {n: t.clone().requires_grad_()
              for n, t in REF.leaves(dense).items()}
    tree = {part: [] for part in REF.PARTS}
    for name, t in leaves.items():
        part, i, leaf = name.split(".")
        while len(tree[part]) <= int(i):
            tree[part].append({})
        tree[part][int(i)][leaf] = t
    pooled = pooled.clone().requires_grad_()
    z = REF.logits(tree, feats, pooled)
    loss = REF.bce(z, labels)
    *g, dly = torch.autograd.grad(loss, list(leaves.values()) + [pooled])
    return loss, torch.sigmoid(z), dict(zip(leaves, g)), dly


def test_forward_loss_and_every_gradient_against_the_reference():
    model = DLRMModel(config())
    params = model.init_params(seed=3, device=CPU)
    b, ids = batch(0)
    pooled = pooled_of(params, ids)
    loss, probs, grads, dly = model.grads_from_pooled(dense_of(params), b,
                                                      pooled)
    r_loss, r_probs, r_grads, r_dly = ref_grads(dense_of(params), b.dense,
                                                pooled, b.labels)
    torch.testing.assert_close(probs, r_probs, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loss, r_loss, rtol=1e-5, atol=1e-7)
    got = REF.leaves(grads)
    assert set(got) == set(r_grads) and len(got) == 16
    for name, g in got.items():
        torch.testing.assert_close(g, r_grads[name], rtol=1e-5, atol=1e-7,
                                   msg=name)
    torch.testing.assert_close(dly, r_dly, rtol=1e-5, atol=1e-7)


def test_bf16_forward_within_its_rounding():
    params = DLRMModel(config()).init_params(seed=4, device=CPU)
    b, ids = batch(1)
    probs, _ = DLRMModel(config("bfloat16")).forward_from_pooled(
        dense_of(params), b.dense, pooled_of(params, ids))
    _, r_probs, _, _ = ref_grads(dense_of(params), b.dense,
                                 pooled_of(params, ids), b.labels)
    assert (probs - r_probs).abs().max() < 1e-2
    assert (probs - r_probs).abs().max() > 0  # bf16 did round


def test_three_fused_steps_under_rwsadagrad():
    model = DLRMModel(config())
    params = model.init_params(seed=5, device=CPU)
    before = tree_map(lambda t: t.clone(), params)
    opt = init_opt_state("rwsadagrad", params)
    step = make_fused_train_step(model, "rwsadagrad", eps=1e-8,
                                 hot_sizes=(1,) * len(SIZES))
    batches = [batch(10 + k) for k in range(3)]
    losses, first = [], None
    for k, (b, _) in enumerate(batches):
        params, opt, loss, probs = step(params, opt, b, 0.004)
        losses.append(float(loss))
        if k == 0:
            first = probs.clone()
            grad = {n: float(a.sum().sqrt())
                    for n, a in REF.leaves(opt["accum"]).items()}
    offs = [0] + list(torch.tensor(SIZES).cumsum(0)[:-1].tolist())
    tables0, local = [], [[] for _ in batches]
    for t, o in enumerate(offs):
        rows, pos = REF.touched([ids[t] for _, ids in batches])
        tables0.append(before["emb"]["stacked"][rows + o])
        for k, p in enumerate(pos):
            local[k].append(p)
    ref = REF.train(tables0, local, dense_of(before),
                    [b.dense for b, _ in batches],
                    [b.labels for b, _ in batches], 0.004, 1e-8)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(ref["loss"]),
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(first, ref["probs"], rtol=1e-5, atol=1e-7)
    for name, v in REF.leaves(dense_of(params)).items():
        assert grad[name] == pytest.approx(ref["grad"][name], rel=1e-5)
        change = float((v - REF.leaves(dense_of(before))[name]).norm())
        assert change == pytest.approx(ref["change"][name], rel=1e-4), name
    for t, o in enumerate(offs):
        rows, _ = REF.touched([ids[t] for _, ids in batches])
        change = float((params["emb"]["stacked"][rows + o]
                        - tables0[t]).norm())
        assert change == pytest.approx(ref["change"][f"emb.{t}"], rel=1e-4)


def test_the_bmm_reads_branch_two_as_d_by_f2():
    """F1 4 != F2 6: Y is branch 1 read [B, 4, 8], Z branch 2 read
    [B, 8, 6] as it comes, not [B, 6, 8] transposed."""
    params = DLRMModel(config()).init_params(seed=6, device=CPU)
    x, ly = torch.randn((B, D)), torch.randn((B, len(SIZES), D))
    out = projection_interaction(x, ly, params["proj_branch1"],
                                 params["proj_branch2"])
    assert out.shape == (B, D + 4 * 6)
    c = torch.cat([x[:, None], ly], dim=1).reshape(B, -1)
    y = REF.mlp(params["proj_branch1"], c, lambda t: t).reshape(B, 4, D)
    z = REF.mlp(params["proj_branch2"], c, lambda t: t)
    want = torch.bmm(y, z.reshape(B, D, 6)).reshape(B, -1)
    torch.testing.assert_close(out[:, D:], want, rtol=1e-5, atol=1e-6)
    transposed = torch.bmm(y, z.reshape(B, 6, D).transpose(1, 2))
    assert not torch.allclose(out[:, D:], transposed.reshape(B, -1))


def test_relu_after_the_last_branch_layer():
    """A last layer whose sums are all negative gives Y = 0, so every
    product is 0: without the ReLU they would not be."""
    params = DLRMModel(config()).init_params(seed=7, device=CPU)
    params["proj_branch1"][-1]["b"] = torch.full((32,), -1e3)
    x, ly = torch.randn((B, D)), torch.randn((B, len(SIZES), D))
    out = projection_interaction(x, ly, params["proj_branch1"],
                                 params["proj_branch2"])
    assert torch.equal(out[:, :D], x)
    assert torch.equal(out[:, D:], torch.zeros((B, 24)))


def test_branch_sizes_must_divide_by_the_embedding_dim():
    with pytest.raises(ValueError, match="divisible by the embedding dim"):
        config(b2=(64, 30))
    with pytest.raises(ValueError, match="both"):
        DLRMConfig(embedding_dim=D, table_sizes=SIZES, mlp_bot=(13, D),
                   interaction="projection",
                   interaction_branch1_layer_sizes=(16,))
    assert config().ln_top == (D + 4 * 6, 16, 1)


@pytest.mark.parametrize("impl", ["fused", "stream"])
def test_v2_main_builds_every_layer_both_flags_name(monkeypatch, impl):
    built = []
    init = DLRMModel.init_params

    def record(self, seed=0, device="cuda"):
        built.append(init(self, seed, device))
        return built[-1]

    monkeypatch.setattr(DLRMModel, "init_params", record)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = v2_main.main([
            "--interaction_type", "projection",
            "--interaction_branch1_layer_sizes", "64,32",
            "--interaction_branch2_layer_sizes", "64,48",
            "--embedding_dim", "8", "--dense_arch_layer_sizes", "16,8",
            "--over_arch_layer_sizes", "16,1", "--num_embeddings", "40",
            "--batch_size", "16", "--limit_train_batches", "2",
            "--limit_val_batches", "1", "--limit_test_batches", "1",
            "--adagrad", "--embedding_impl", impl], device="cpu")
    assert rc == 0
    assert float(re.search(r"final loss (\S+)", buf.getvalue()).group(1)) > 0
    p = built[0]
    fd = 27 * 8  # the dense vector and 26 tables
    assert [layer["w"].shape for layer in p["proj_branch1"]] == [(fd, 64),
                                                                 (64, 32)]
    assert [layer["w"].shape for layer in p["proj_branch2"]] == [(fd, 64),
                                                                 (64, 48)]
    assert p["top"][0]["w"].shape == (8 + 4 * 6, 16)
    assert "proj_w1" not in p


def test_traced_backward_keeps_the_bits_and_opens_its_span(monkeypatch,
                                                          tmp_path):
    """The interaction's backward through backward_scope, untraced and
    traced, gives the bits of plain autograd over the same function, and
    opens its span once while traced."""
    model = DLRMModel(config("bfloat16"))
    params = model.init_params(seed=8, device=CPU)
    b, ids = batch(2)
    pooled = pooled_of(params, ids)
    scoped = model.grads_from_pooled(dense_of(params), b, pooled)
    with profiling.profile(True, str(tmp_path)):
        traced = model.grads_from_pooled(dense_of(params), b, pooled)
    names = [s.name for s in profiling.spans()]
    assert names.count(profiling.INT_BWD) == 1
    assert names.count(profiling.INT_FWD) == 1
    with monkeypatch.context() as m:
        m.setattr(profiling, "backward_scope",
                  lambda name, fn, *inputs: fn(*inputs))
        plain = model.grads_from_pooled(dense_of(params), b, pooled)
    for got in (scoped, traced):
        for a, c in zip(plain[:2] + (plain[3],), got[:2] + (got[3],)):
            assert torch.equal(a, c)
        for name, g in REF.leaves(plain[2]).items():
            assert torch.equal(g, REF.leaves(got[2])[name]), name


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_branches(bits):
    model = DLRMModel(config("bfloat16"))
    params = model.init_params(seed=9, device=CPU)
    q = model.quantize_mlps(params, bits)
    assert "qw" in q["proj_branch1"][0] and "qw" in q["proj_branch2"][1]
    b, _ = batch(3)
    with torch.no_grad():
        want = model.apply(params, b, hot_sizes=(1,) * len(SIZES))
        got = model.apply(q, b, hot_sizes=(1,) * len(SIZES))
    assert (got - want).abs().max() < 2e-2


def test_the_new_leaves_cross_bridge_checkpoint_and_export(tmp_path):
    model = DLRMModel(config("bfloat16"))
    params = model.init_params(seed=10, device=CPU)
    back = params_from_jax(params_to_jax(params), device=CPU)
    for name, t in REF.leaves(dense_of(params)).items():
        assert torch.equal(REF.leaves(dense_of(back))[name], t)
    opt = init_opt_state("rwsadagrad", params)
    save_checkpoint(str(tmp_path / "ckpt"), params, opt)
    zeros = tree_map(torch.zeros_like, params)
    loaded, _, _ = load_checkpoint(str(tmp_path / "ckpt"), zeros,
                                   init_opt_state("rwsadagrad", zeros))
    for name, t in REF.leaves(dense_of(params)).items():
        assert torch.equal(REF.leaves(dense_of(loaded))[name], t)
    b, _ = batch(4)
    padded = Batch(b.dense, b.idx.reshape(len(SIZES), B, 1), None, None)
    program = export_program(model, params, B, wt=False)
    with torch.no_grad():
        torch.testing.assert_close(
            program.module()(params, b.dense, padded.idx),
            model.apply(params, padded), rtol=0, atol=0)
