"""The port's checkpoints (dlrm_tpu_torch/train/checkpoint.py) against the
JAX package's files: a round trip, a shape mismatch, a mixed save, a
checkpoint from before save ids, a stale manifest retired, files written by
each package loading in the other (the same keys, bit for bit), and a
per-shard JAX checkpoint loading by concatenation. Exact equality
throughout."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from dlrm_tpu.config import DLRMConfig as JaxConfig
from dlrm_tpu.config import MDConfig as JaxMD
from dlrm_tpu.config import QRConfig as JaxQR
from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
from dlrm_tpu.optim.optimizers import init_opt_state as jax_init_opt_state
from dlrm_tpu.train import checkpoint as jckpt
from dlrm_tpu_torch.bridge import params_from_jax, params_to_jax
from dlrm_tpu_torch.config import DLRMConfig, MDConfig, QRConfig
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import init_opt_state, tree_leaves
from dlrm_tpu_torch.train import checkpoint as ckpt

KW = dict(embedding_dim=4, table_sizes=(50, 20, 300), mlp_bot=(8, 4),
          mlp_top=(4, 1), loss="bce")
TRICKS = {
    "plain": ({}, {}),
    "qr": ({"qr": QRConfig(threshold=30)}, {"qr": JaxQR(threshold=30)}),
    "md": ({"md": MDConfig(threshold=30)}, {"md": JaxMD(threshold=30)}),
    "wp": ({"weighted_pooling": "learned"}, {"weighted_pooling": "learned"}),
}


def _model(trick="plain", **kw):
    return DLRMModel(DLRMConfig(**{**KW, **TRICKS[trick][0], **kw}))


def _state(trick="plain", optimizer="rwsadagrad", seed=0):
    """Params and optimizer state with every leaf random (accumulators
    too), on the CPU."""
    params = _model(trick).init_params(seed=seed, device="cpu")
    opt = init_opt_state(optimizer, params)
    gen = torch.Generator().manual_seed(seed + 1)
    for a in tree_leaves(opt.get("accum", {})):
        a.copy_(torch.rand(a.shape, generator=gen))
    opt["step"] = 7
    return params, opt


def _assert_trees_equal(a, b):
    fa, fb = ckpt.flatten_with_paths(a), ckpt.flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, int) or isinstance(y, int):
            assert int(x) == int(y), k
        else:
            assert torch.equal(torch.as_tensor(np.array(x)),
                               torch.as_tensor(np.array(y))), k


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("trick", sorted(TRICKS))
def test_roundtrip(tmp_path, trick, optimizer):
    params, opt = _state(trick, optimizer)
    ckpt.save_checkpoint(str(tmp_path / "ck"), params, opt, {"epoch": 2})
    tp, to = _state(trick, optimizer, seed=5)
    p2, o2, meta = ckpt.load_checkpoint(str(tmp_path / "ck"), tp, to)
    assert meta == {"epoch": 2}
    _assert_trees_equal(p2, params)
    _assert_trees_equal(o2, opt)
    assert isinstance(o2["step"], int)


def test_keys_are_the_jax_packages(tmp_path):
    """The npz keys of a port save equal those of a JAX save of the same
    tree (the rwsadagrad state of an MD model with pooling weights)."""
    cfg = {**KW, "md": JaxMD(threshold=30), "weighted_pooling": "fixed"}
    jp = JaxModel(JaxConfig(**cfg)).init_params(jax.random.PRNGKey(0))
    jckpt.save_checkpoint(str(tmp_path / "j"), jp,
                          jax_init_opt_state("rwsadagrad", jp))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ckpt.save_checkpoint(str(tmp_path / "t"), tp,
                         init_opt_state("rwsadagrad", tp))
    keys = [sorted(np.load(str(tmp_path / d / "arrays.npz")).files)
            for d in ("j", "t")]
    assert keys[0] == keys[1]
    assert "opt/accum/emb/tables/2/w" in keys[0] and "opt/step" in keys[0]


def test_shape_mismatch_rejected(tmp_path):
    params, _ = _state()
    ckpt.save_checkpoint(str(tmp_path / "ck"), params)
    bad = _model(embedding_dim=8, mlp_bot=(8, 8)).init_params(device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_checkpoint(str(tmp_path / "ck"), bad)
    with pytest.raises(KeyError, match="missing"):
        ckpt.load_checkpoint(str(tmp_path / "ck"),
                             _model("qr").init_params(device="cpu"))


def test_mixed_save_detected(tmp_path):
    """A directory mixing files from two saves refuses to load."""
    params, _ = _state()
    ckpt.save_checkpoint(str(tmp_path / "a"), params, meta={"epoch": 1})
    ckpt.save_checkpoint(str(tmp_path / "b"), params, meta={"epoch": 2})
    shutil.copy(tmp_path / "a" / "arrays.npz", tmp_path / "b" / "arrays.npz")
    with pytest.raises(ValueError, match="inconsistent"):
        ckpt.load_checkpoint(str(tmp_path / "b"), params)


def test_pre_save_id_checkpoint_still_loads(tmp_path):
    params, _ = _state()
    ckpt.save_checkpoint(str(tmp_path / "ck"), params, meta={"epoch": 3})
    mpath = tmp_path / "ck" / "meta.json"
    meta = json.loads(mpath.read_text())
    del meta["save_id"]
    mpath.write_text(json.dumps(meta))
    p2, o2, meta2 = ckpt.load_checkpoint(str(tmp_path / "ck"), params,
                                         init_opt_state("sgd", params))
    assert meta2 == {"epoch": 3} and o2 is None
    _assert_trees_equal(p2, params)


@pytest.mark.parametrize("optimizer", ["sgd", "rwsadagrad"])
@pytest.mark.parametrize("trick", ["plain", "qr", "md"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, trick, optimizer):
    cfg = JaxConfig(**{**KW, **TRICKS[trick][1]})
    jp = JaxModel(cfg).init_params(jax.random.PRNGKey(3))
    jo = jax_init_opt_state(optimizer, jp)
    jo = jax.tree_util.tree_map(
        lambda a: a + 0.25 if a.dtype == np.float32 else a + 3, jo)
    jckpt.save_checkpoint(str(tmp_path / "ck"), jp, jo, {"epoch": 1})
    tp, to = _state(trick, optimizer)
    p2, o2, meta = ckpt.load_checkpoint(str(tmp_path / "ck"), tp, to)
    assert meta == {"epoch": 1} and o2["step"] == 3
    _assert_trees_equal(p2, jax.tree_util.tree_map(np.asarray, jp))
    _assert_trees_equal(o2, jax.tree_util.tree_map(np.asarray, jo))


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "rwsadagrad"])
@pytest.mark.parametrize("trick", ["plain", "qr", "md"])
def test_port_checkpoint_loads_in_jax(tmp_path, trick, optimizer):
    params, opt = _state(trick, optimizer)
    ckpt.save_checkpoint(str(tmp_path / "ck"), params, opt, {"it": 4})
    cfg = JaxConfig(**{**KW, **TRICKS[trick][1]})
    jp = JaxModel(cfg).init_params(jax.random.PRNGKey(9))
    jp2, jo2, meta = jckpt.load_checkpoint(
        str(tmp_path / "ck"), jp, jax_init_opt_state(optimizer, jp))
    assert meta == {"it": 4} and int(jo2["step"]) == 7
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jp2),
                        params_to_jax(params))
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jo2),
                        params_to_jax(opt))


SHARD_CFG = dict(embedding_dim=4, table_sizes=(1000, 17, 260, 33, 990, 120),
                 mlp_bot=(13, 8, 4), mlp_top=(8, 4, 1), loss="bce",
                 num_indices_per_lookup=6)


def _sharded_jax_checkpoint(path, cw_tables=None):
    """A per-shard checkpoint written by the JAX package's sharded path
    (mixed plan over a model axis of 4: the stacked table and its
    accumulator row-sharded, column-wise tables split on axis 1) and host
    copies of the sharded trees it holds."""
    from dlrm_tpu.parallel.butterfly import ButterflyDLRM
    from dlrm_tpu.parallel.mesh import make_mesh

    model = JaxModel(JaxConfig(**SHARD_CFG))
    params = jax.tree_util.tree_map(
        np.asarray, model.init_params(jax.random.PRNGKey(0)))
    bf = ButterflyDLRM(model, make_mesh(data=2, model=4), strategy="mixed",
                       rw_threshold=600, cw_tables=cw_tables)
    sp = bf.shard_params(params)
    so = jax.tree_util.tree_map(lambda a: a + 0.5,
                                jax_init_opt_state("adagrad", sp))
    jckpt.save_checkpoint(path, sp, so, meta={"it": 1})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return host(sp), host(so)


@pytest.mark.parametrize("cw_tables", [None, [2, 4]], ids=["rows", "columns"])
def test_per_shard_jax_checkpoint_loads_by_concatenation(tmp_path,
                                                        cw_tables):
    """Each sharded array's blocks concatenated on its sharded axis (rows,
    or columns for column-wise tables), the accumulators too; a legacy
    manifest's bare int means axis 0; a block from another save is
    refused."""
    path = str(tmp_path / "ck")
    sp, so = _sharded_jax_checkpoint(path, cw_tables)
    manifest = json.load(open(os.path.join(path, "sharding.json")))
    assert manifest["params/emb/stacked"] == [4, 0]
    if cw_tables:
        assert manifest["params/emb/cw_stacked"] == [4, 1]
    with np.load(os.path.join(path, "arrays.npz")) as z:
        assert "params/emb/stacked" not in z.files
    tp = params_from_jax(jax.tree_util.tree_map(np.zeros_like, sp), "cpu")
    to = params_from_jax(jax.tree_util.tree_map(np.zeros_like, so), "cpu")
    p2, o2, meta = ckpt.load_checkpoint(path, tp, to)
    assert meta == {"it": 1}
    _assert_trees_equal(p2, sp)
    _assert_trees_equal(o2, so)
    legacy = {k: (v[0] if v[1] == 0 else v) for k, v in manifest.items()}
    json.dump(legacy, open(os.path.join(path, "sharding.json"), "w"))
    p3, _, _ = ckpt.load_checkpoint(path, tp)
    _assert_trees_equal(p3, sp)
    other = str(tmp_path / "other")
    _sharded_jax_checkpoint(other, cw_tables)
    shutil.copy(os.path.join(other, "shard_00001.npz"),
                os.path.join(path, "shard_00001.npz"))
    with pytest.raises(ValueError, match="inconsistent"):
        ckpt.load_checkpoint(path, tp)


def test_unsharded_save_retires_stale_manifest(tmp_path):
    """A port save into a directory that held a per-shard JAX checkpoint
    retires its sharding.json and loads as written."""
    path = str(tmp_path / "ck")
    _sharded_jax_checkpoint(path)
    tp = DLRMModel(DLRMConfig(**SHARD_CFG)).init_params(seed=2, device="cpu")
    ckpt.save_checkpoint(path, tp, meta={"it": 2})
    assert not os.path.exists(os.path.join(path, "sharding.json"))
    p2, _, meta = ckpt.load_checkpoint(path, tp)
    assert meta == {"it": 2}
    _assert_trees_equal(p2, tp)


def test_multi_process_save_raises(tmp_path, monkeypatch):
    params, _ = _state()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="queue A item 11"):
        ckpt.save_checkpoint(str(tmp_path / "ck"), params)
    assert not os.path.exists(tmp_path / "ck")


def test_flatten_with_paths_sorts_dict_keys():
    """The JAX package's tree order: dict keys sorted at every level, list
    items in order."""
    tree = {"top": [{"w": 1, "b": 2}], "emb": {"stacked": 3}, "bot": []}
    assert list(ckpt.flatten_with_paths(tree, "params")) == [
        "params/emb/stacked", "params/top/0/b", "params/top/0/w"]
    jp = JaxModel(JaxConfig(**KW, weighted_pooling="fixed")).init_params(
        jax.random.PRNGKey(0))
    jkeys = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert list(ckpt.flatten_with_paths(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu"))) \
        == jkeys
