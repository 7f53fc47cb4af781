"""The port's entry points (dlrm_tpu_torch/graft_entry.py) against
__graft_entry__.py: the flagship configs field for field; entry's forward
on the small config, its params carried to the JAX model with bridge.py,
equal to the JAX forward (model.apply, what __graft_entry__.entry returns)
on the same batch within atol 1e-6 (bf16 compute: each tower layer rounds
its fp32 sum to bf16 in both, so the probabilities differ by a few fp32
ulps at most); and
dryrun_multichip on 4 gloo ranks on the CPU printing every leg's OK line
with a finite loss (and each butterfly leg's finite loss after its step,
which the step moved), the bucketed legs equal to the masked ones within
1e-4, and on 2 ranks without the hybrid leg, as the JAX dry run skips
it."""

import contextlib
import dataclasses
import io
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import __graft_entry__ as jax_entry
from dlrm_tpu.data.random_data import fixed_multihot_batch as jax_batch
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu_torch import graft_entry
from dlrm_tpu_torch.bridge import params_to_jax

LINE = re.compile(r"dryrun_multichip\((\d+)\): grid \((\d+)x(\d+)\) (.+) "
                  r"loss=(\S+) OK(?: \(== masked\))?(?: \(after the step "
                  r"(\S+)\))?$")


@pytest.mark.parametrize("small", [True, False])
def test_flagship_configs_equal_the_jax_ones(small):
    ours = dataclasses.asdict(graft_entry._flagship_cfg(small))
    theirs = dataclasses.asdict(jax_entry._flagship_cfg(small))
    assert {k: ours[k] for k in theirs if k in ours} == {
        k: theirs[k] for k in theirs if k in ours}
    assert ours["table_sizes"] == theirs["table_sizes"]
    assert ours["compute_dtype"] == "bfloat16"


def test_entry_small_forward_matches_jax(monkeypatch):
    """entry() with the small config in place of the flagship's."""
    small = graft_entry._flagship_cfg(small=True)
    monkeypatch.setattr(graft_entry, "_flagship_cfg", lambda: small)
    fwd, (params, batch) = graft_entry.entry(device="cpu")
    got = fwd(params, batch).float().numpy()
    assert got.shape == (1024, 1) and np.isfinite(got).all()

    cfg = jax_entry._flagship_cfg(small=True)
    model = JaxModel(cfg)
    hb = jax_batch(np.random.default_rng(0), cfg.num_dense, cfg.table_sizes,
                   batch_size=1024, hot_size=cfg.num_indices_per_lookup)
    np.testing.assert_array_equal(batch.idx.numpy(), hb.idx)
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_jax(params))
    want = np.asarray(model.apply(jp, hb.to_device()), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _dryrun(n):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = graft_entry.dryrun_multichip(n, device="cpu")
    return res, [LINE.match(ln) for ln in buf.getvalue().splitlines()
                 if ln.startswith("dryrun_multichip")]


def test_dryrun_multichip_four_ranks():
    res, lines = _dryrun(4)
    assert all(lines) and len(lines) == 10
    assert [m.group(4) for m in lines] == list(graft_entry.LEGS)
    assert {m.group(1, 2, 3) for m in lines} == {("4", "2", "2")}
    losses = {name: loss for name, loss, _ in res["legs"]}
    after = {name: a for name, _, a in res["legs"]}
    assert all(math.isfinite(x) for x in losses.values())
    assert [float(m.group(5)) for m in lines] == pytest.approx(
        [losses[m.group(4)] for m in lines], abs=1e-6)
    # the butterfly legs' loss after their step; the trainers' have none
    for m in lines:
        name = m.group(4)
        if name.endswith("--sharded"):
            assert after[name] is None and m.group(6) is None
        else:
            assert math.isfinite(after[name]) and after[name] != losses[name]
            assert float(m.group(6)) == pytest.approx(after[name], abs=1e-6)
    for got, want in [("bucketed striped stream butterfly",
                       "striped stream butterfly"),
                      ("owner-bucketed mixed butterfly",
                       "mixed-plan butterfly")]:
        assert abs(losses[got] - losses[want]) < 1e-4
        assert abs(after[got] - after[want]) < 1e-4
    # plain versions on the CPU: no kernel launched
    assert all(v == 0 for leg in res["launches"].values()
               for v in leg.values())
    assert res["backend"] == "gloo" and res["grid"] == (2, 2)


def test_dryrun_multichip_two_ranks_skips_the_hybrid_grid():
    res, lines = _dryrun(2)
    names = [m.group(4) for m in lines]
    assert "hybrid-mesh mixed butterfly" not in names
    assert names == [x for x in graft_entry.LEGS if "hybrid" not in x]
    assert res["grid"] == (1, 2)
