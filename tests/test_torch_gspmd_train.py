"""The training half of the port's GspmdDLRM
(dlrm_tpu_torch/parallel/gspmd.py: shard_params, shard_opt_state,
shard_batch, make_train_step, make_eval_step, unshard_params) on gloo CPU
ranks of a 1 x 2 and a 2 x 2 ("data" x "model") grid, held to the JAX
package's single-device make_train_step (and make_eval_step) on the CPU,
and under rwsadagrad to JAX's own GspmdDLRM on 4 of the CPU devices, from
the JAX init (one per variant, carried across with bridge.py) and the same
seeded batches.

Tiny widths: 6 tables of 7-301 rows (the stacked table's 769 rows, QR's
3-row r tables and most per-table leaves need padding on 2 ranks), d 8,
ragged hots in the padded [T, B, 4] layout, batch 16 with pad rows (label
-1) spread unevenly over the slices. The variants are the JAX test's
(tests/test_gspmd.py:39): plain tables, QR (3 collisions), MD and learned
pooling weights v_w, each under rwsadagrad; sgd and adagrad on two variants
each; fixed v_w; and the flat per-hit layout (hot_sizes). After 3 steps:
the global loss of each step on every rank, each rank's probs of its
slice, the eval step's, the unsharded params and optimizer accumulators
(the same on every rank), and every padded row of every row-sharded leaf
and accumulator exactly 0.

Tolerances (a pooled sum over hits in several blocks is summed block by
block and then over the blocks, so it differs from one device's by fp32
rounding): losses rtol 1e-5; tables, QR's q and r and v_w rtol 1e-5 / atol
1e-6; dense params (MD projections included) rtol 1e-4 / atol 1e-5, except
under (rw)adagrad the dense elements whose squared grads sum below 1e-12
(only rounding-level grads, which Adagrad divides by themselves), held to
|dw| <= steps * lr (tests/test_torch_stream_step.py's rule); probs rtol
1e-4 / atol 1e-5; accumulators rtol 1e-4 / atol 1e-8.

The ranks are spawned once for the module (both grids at once) and run
every case while the JAX package runs in this process. The JAX package is
imported inside the functions that run it: the spawned ranks import this
module, and start in a third of the time without it. The host helpers the slice
brought along (path_keys, stack_tables, offsets_to_padded,
padded_to_offsets, global_batch_from_replicated,
global_batch_from_local_shard) are held to their JAX originals here too."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dlrm_tpu_torch.bridge import params_from_jax
from dlrm_tpu_torch.config import DLRMConfig
from dlrm_tpu_torch.data.random_data import HostBatch, ragged_multihot_batch
from dlrm_tpu_torch.models.dlrm import DLRMModel
from dlrm_tpu_torch.optim.optimizers import (
    init_opt_state,
    tree_map,
    tree_map_with_path,
)
from dlrm_tpu_torch.parallel.collectives import Axis
from dlrm_tpu_torch.parallel.launch import start_ranks

B = 16
LR = 0.05
STEPS = 3
TABLES = (301, 64, 250, 17, 130, 7)
HOTS = (3, 2, 1, 2, 4, 1)
KW = dict(embedding_dim=8, table_sizes=TABLES, mlp_bot=(4, 8, 8),
          mlp_top=(16, 8, 1), interaction="dot", loss="bce",
          num_indices_per_lookup=max(HOTS))
PAD_ROWS = ((), (0, 1, 2, 9), (13,))  # each step's label -1 rows
# a variant's config beyond KW (QR and MD as each package's config class)
VARIANTS = {
    "plain": {},
    "qr": {"qr": ("QRConfig", dict(collisions=3, threshold=100))},
    "md": {"md": ("MDConfig", dict(temperature=0.3, threshold=100))},
    "weighted": {"weighted_pooling": "learned"},
    "fixed": {"weighted_pooling": "fixed"},
}
# name: (variant, optimizer, flat per-hit layout); every variant under the
# JAX test's rwsadagrad, and each optimizer on two variants
CASES = {f"{v}-rwsadagrad": (v, "rwsadagrad", False) for v in VARIANTS}
CASES.update({
    "plain-sgd": ("plain", "sgd", False),
    "plain-adagrad": ("plain", "adagrad", False),
    "qr-sgd": ("qr", "sgd", False),
    "md-adagrad": ("md", "adagrad", False),
    "weighted-sgd": ("weighted", "sgd", False),
    "plain-flat-rwsadagrad": ("plain", "rwsadagrad", True),
})
# the flat case is plain-rwsadagrad's run in the other layout: one seed
SEEDS = {c: i + 1 for i, c in enumerate(CASES)}
SEEDS["plain-flat-rwsadagrad"] = SEEDS["plain-rwsadagrad"]
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
RUNS = [(c, g) for g in GRIDS for c in CASES]
# JAX's GspmdDLRM on the JAX test's optimizer, on the 2 x 2 grid
JAX_GSPMD = [(v, "2x2") for v in ("plain", "qr", "md", "weighted")]
TOL = {"loss": dict(rtol=1e-5, atol=0), "table": dict(rtol=1e-5, atol=1e-6),
       "dense": dict(rtol=1e-4, atol=1e-5),
       "probs": dict(rtol=1e-4, atol=1e-5), "acc": dict(rtol=1e-4, atol=1e-8)}
# the helpers' test batch: its fields' specs as JAX PartitionSpec tuples
SPECS = ((("data", "model"),), (None, ("data", "model")),
         (None, ("data", "model")), (("data", "model"),))


def _cfg(variant, jax_side=False):
    """The variant's config kwargs for the port's DLRMConfig (jax_side:
    the JAX package's)."""
    if jax_side:
        import dlrm_tpu.config as C
    else:
        import dlrm_tpu_torch.config as C
    return dict(KW, **{k: getattr(C, v[0])(**v[1]) if isinstance(v, tuple)
                       else v for k, v in VARIANTS[variant].items()})


def _batches(seed):
    """STEPS train batches (with PAD_ROWS) and an eval batch, as numpy
    HostBatches in the padded layout."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(STEPS + 1):
        hb = ragged_multihot_batch(rng, 4, TABLES, HOTS, B)
        if s < STEPS:
            hb.labels[list(PAD_ROWS[s])] = -1.0
        out.append(hb)
    return out[:STEPS], out[STEPS]


def _jax_params(variant, seed):
    import jax

    from dlrm_tpu.config import DLRMConfig as JaxConfig
    from dlrm_tpu.models.dlrm import DLRMModel as JaxModel

    model = JaxModel(JaxConfig(**_cfg(variant, True)))
    return _np_tree(model.init_params(jax.random.PRNGKey(seed)))


def _jax_batch(hb):
    from dlrm_tpu.data.random_data import HostBatch as JaxHostBatch

    return JaxHostBatch(hb.dense, hb.idx, hb.wt, hb.labels).to_device()


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_mesh(grid):
    import jax

    from dlrm_tpu.parallel.mesh import make_mesh

    d, m = GRIDS[grid]
    return make_mesh(data=d, model=m, devices=jax.devices()[:d * m])


def _jax_single(case, params, seed):
    """The JAX single-device step from `params` (numpy) on the case's
    batches: per-step losses and probs, the final params and
    accumulators, the eval probs."""
    import jax.numpy as jnp

    from dlrm_tpu.config import DLRMConfig as JaxConfig
    from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
    from dlrm_tpu.optim.optimizers import init_opt_state as jax_init
    from dlrm_tpu.train.step import make_eval_step, make_train_step

    variant, opt, _ = CASES[case]
    model = JaxModel(JaxConfig(**_cfg(variant, True)))
    params = _tree(jnp.asarray, params)
    state = jax_init(opt, params)
    step = make_train_step(model, opt)
    train, ev = _batches(seed)
    losses, probs = [], []
    for hb in train:
        params, state, loss, p = step(params, state, _jax_batch(hb), LR)
        losses.append(float(loss))
        probs.append(np.asarray(p).reshape(-1))
    return {"losses": losses, "probs": probs, "params": _np_tree(params),
            "accum": _np_tree(state.get("accum")),
            "eval": np.asarray(make_eval_step(model)(
                params, _jax_batch(ev))).reshape(-1)}


def _tree(fn, tree):
    import jax

    return jax.tree_util.tree_map(fn, tree)


def _jax_gspmd(variant, grid, params, seed):
    """JAX's GspmdDLRM under rwsadagrad on the grid's CPU devices from
    `params` (numpy) on the batches of `seed`: losses and the unsharded
    params."""
    import jax.numpy as jnp

    from dlrm_tpu.config import DLRMConfig as JaxConfig
    from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
    from dlrm_tpu.optim.optimizers import init_opt_state as jax_init
    from dlrm_tpu.parallel.gspmd import GspmdDLRM as JaxGspmd

    model = JaxModel(JaxConfig(**_cfg(variant, True)))
    runner = JaxGspmd(model, _jax_mesh(grid))
    sp = runner.shard_params(_tree(jnp.asarray, params))
    st = runner.shard_opt_state(jax_init("rwsadagrad", sp))
    step = runner.make_train_step("rwsadagrad")
    losses = []
    for hb in _batches(seed)[0]:
        sp, st, loss, _ = step(sp, st, runner.shard_batch(_jax_batch(hb)),
                               LR)
        losses.append(float(loss))
    return {"losses": losses,
            "params": _np_tree(runner.unshard_params(sp, params))}


def _padding(tree, template, msize, m):
    """(padded rows of this rank's row-sharded leaves, all exactly 0)."""
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    found = []

    def visit(path, leaf, t):
        if isinstance(leaf, torch.Tensor) and _is_row_shardable(path, leaf):
            n, block = np.shape(t)[0], leaf.shape[0]
            assert block == -(-n // msize)
            pad = leaf[max(0, min(block, n - m * block)):]
            found.append((pad.shape[0], bool((pad == 0).all())))

    tree_map_with_path(visit, tree, template)
    return sum(n for n, _ in found), all(z for _, z in found)


def _helpers_rank(mesh, seed):
    """global_batch_from_replicated and global_batch_from_local_shard on
    this rank, from the helpers' test batch."""
    from dlrm_tpu_torch.parallel.multihost import (
        global_batch_from_local_shard,
        global_batch_from_replicated,
    )

    batch = _helper_batch(seed).to_device("cpu")
    mine = global_batch_from_replicated(mesh, batch, SPECS)
    whole = global_batch_from_local_shard(mesh, mine, SPECS)
    return ([x.numpy().copy() for x in mine[:4]],
            [x.numpy().copy() for x in whole[:4]])


def _helper_batch(seed):
    return ragged_multihot_batch(np.random.default_rng(seed), 4, TABLES,
                                 HOTS, B)


def _port_rank(rank, grid, runs, jax_params):
    """Every case on this rank of `grid`: losses, probs, eval probs, the
    unsharded params and accumulators, the padded rows; the batch
    helpers' results."""
    from dlrm_tpu_torch.parallel.gspmd import GspmdDLRM
    from dlrm_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    d, m = GRIDS[grid]
    mesh = make_mesh(data=d, model=m)
    out = {}
    for case, seed in runs:
        variant, opt, flat = CASES[case]
        model = DLRMModel(DLRMConfig(**_cfg(variant)))
        params = params_from_jax(jax_params[variant], device="cpu")
        state0 = init_opt_state(opt, params)
        runner = GspmdDLRM(model, mesh, device="cpu",
                           hot_sizes=HOTS if flat else None)
        sp = runner.shard_params(params)
        st = runner.shard_opt_state(state0)
        step = runner.make_train_step(opt)
        train, ev = _batches(seed)
        hots = HOTS if flat else None
        losses, probs = [], []
        for hb in train:
            batch = runner.shard_batch(hb.to_device("cpu", flat_hots=hots))
            sp, st, loss, p = step(sp, st, batch, LR)
            losses.append(float(loss))
            probs.append(p.reshape(-1).numpy().copy())
        evp = runner.make_eval_step()(
            sp, runner.shard_batch(ev.to_device("cpu", flat_hots=hots)))
        pad = [_padding(sp, params, m, mesh.m)]
        res = {"losses": losses, "probs": probs, "step": st["step"],
               "eval": evp.reshape(-1).numpy().copy(),
               "params": tree_map(lambda t: t.numpy(),
                                  runner.unshard_params(sp, params))}
        if opt != "sgd":
            pad.append(_padding(st["accum"], state0["accum"], m, mesh.m))
            res["accum"] = tree_map(lambda t: t.numpy(), runner.unshard_params(
                st["accum"], state0["accum"]))
        res["batch_index"] = mesh.batch_index
        res["padded_rows"] = sum(n for n, _ in pad)
        res["padding_zero"] = all(z for _, z in pad)
        out[case] = res
    out["helpers"] = _helpers_rank(mesh, 7), mesh.batch_index
    return out


@pytest.fixture(scope="module")
def both():
    """{(case, grid): (JAX results, [rank results])}, JAX's GspmdDLRM's
    runs, and the ranks' helper results by grid."""
    seeds = SEEDS
    runs = [(c, seeds[c]) for c in CASES]
    jax_params = {v: _jax_params(v, i) for i, v in enumerate(VARIANTS)}
    jobs = {}
    try:
        for grid, (d, m) in GRIDS.items():
            jobs[grid] = start_ranks(_port_rank, d * m,
                                     args=(grid, runs, jax_params))
        jx = {c: _jax_single(c, jax_params[CASES[c][0]], seeds[c])
              for c in CASES if "flat" not in c}
        jx["plain-flat-rwsadagrad"] = jx["plain-rwsadagrad"]
        jg = {(v, g): _jax_gspmd(v, g, jax_params[v],
                                 seeds[f"{v}-rwsadagrad"])
              for v, g in JAX_GSPMD}
    except BaseException:
        for job in jobs.values():
            job.close()
        raise
    ranks = {g: job.wait(timeout_s=300) for g, job in jobs.items()}
    return ({(c, g): (jx[c], [r[c] for r in ranks[g]]) for c, g in RUNS},
            jg, ranks)


def _close(a, b, what, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), err_msg=what,
                               **TOL[tol])


def _flat(tree):
    """[(path, leaf)] of a tree of nested dicts and lists, in key order."""
    out = []
    tree_map_with_path(lambda path, x: out.append((path, x)), tree)
    return out


def _hold_params(got, want, acc, what):
    """Tables and v_w to TOL["table"]; the dense params to TOL["dense"],
    except Adagrad's rounding-level elements (see the module docstring)."""
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    accs = dict(_flat(acc)) if acc is not None else {}
    for (path, x), (_, y) in zip(_flat(got), _flat(want)):
        name = f"{what} {'/'.join(map(str, path))}"
        assert np.shape(x) == np.shape(y), name
        if _is_row_shardable(path, x):
            _close(x, y, name, "table")
            continue
        noise = (np.asarray(accs[path]) < 1e-12 if path in accs
                 else np.zeros(np.shape(x), bool))
        _close(np.asarray(x)[~noise], np.asarray(y)[~noise], name, "dense")
        assert (np.abs(np.asarray(x) - np.asarray(y))[noise]
                <= STEPS * LR).all(), name


@pytest.mark.parametrize("case,grid", RUNS, ids=[f"{c}-{g}" for c, g in RUNS])
def test_gspmd_train_matches_jax_single_device(both, case, grid):
    jx, ranks = both[0][(case, grid)]
    _, opt, _ = CASES[case]
    what = f"{case} {grid}"
    for r in ranks:
        assert r["step"] == STEPS
        _close(r["losses"], jx["losses"], f"{what} losses", "loss")
        assert r["padding_zero"], f"{what}: a padded row moved"
    assert ranks[0]["padded_rows"] + ranks[-1]["padded_rows"] > 0, what
    order = np.argsort([r["batch_index"] for r in ranks])
    for s in range(STEPS):  # the (d * model + m)-th slice on rank (d, m)
        _close(np.concatenate([ranks[i]["probs"][s] for i in order]),
               jx["probs"][s], f"{what} probs step {s}", "probs")
    _close(np.concatenate([ranks[i]["eval"] for i in order]), jx["eval"],
           f"{what} eval probs", "probs")
    _hold_params(ranks[0]["params"], jx["params"], jx["accum"], what)
    if opt != "sgd":
        for (path, x), (_, y) in zip(_flat(ranks[0]["accum"]),
                                     _flat(jx["accum"])):
            _close(x, y, f"{what} accumulator {path}", "acc")
    for r in ranks[1:]:  # every rank unshards the same tree
        for (path, x), (_, y) in zip(_flat(r["params"]),
                                     _flat(ranks[0]["params"])):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {path}")


@pytest.mark.parametrize("variant,grid", JAX_GSPMD,
                         ids=[f"{v}-{g}" for v, g in JAX_GSPMD])
def test_gspmd_train_matches_jax_gspmd(both, variant, grid):
    """The port's ranks against JAX's GspmdDLRM on as many CPU devices."""
    want = both[1][(variant, grid)]
    ranks = both[0][(f"{variant}-rwsadagrad", grid)][1]
    what = f"{variant} {grid} against JAX's GspmdDLRM"
    _close(ranks[0]["losses"], want["losses"], f"{what} losses", "loss")
    _hold_params(ranks[0]["params"], want["params"], None, what)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_the_padding_is_the_tail_of_each_row_sharded_leaf(both, grid):
    """Each row-sharded leaf (and accumulator) of n rows carries (-n) %
    model padded rows in all, at the end of the last blocks: summed over a
    data group's ranks, every case's padded rows are the leaves' own."""
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    dsize, msize = GRIDS[grid]
    for case in CASES:
        jx, ranks = both[0][(case, grid)]
        trees = [jx["params"]] + ([jx["accum"]] if jx["accum"] else [])
        want = sum((-np.shape(x)[0]) % msize for t in trees
                   for path, x in _flat(t) if _is_row_shardable(path, x))
        got = sum(r["padded_rows"] for r in ranks) // dsize
        assert got == want > 0, case


def _jax_trees(variant, opt):
    import jax

    from dlrm_tpu.config import DLRMConfig as JaxConfig
    from dlrm_tpu.models.dlrm import DLRMModel as JaxModel
    from dlrm_tpu.optim.optimizers import init_opt_state as jax_init

    model = JaxModel(JaxConfig(**_cfg(variant, True)))
    params = model.init_params(jax.random.PRNGKey(0))
    return params, jax_init(opt, params)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_path_keys_and_row_sharding_rule_match_jax(variant):
    """path_keys and _is_row_shardable against the JAX package's, on the
    JAX key paths and on the port's own paths of the same trees (params
    and rwsadagrad / adagrad state)."""
    import jax

    from dlrm_tpu.optim.optimizers import path_keys as jax_path_keys
    from dlrm_tpu.parallel.gspmd import _is_row_shardable as jax_rule
    from dlrm_tpu_torch.optim.optimizers import path_keys
    from dlrm_tpu_torch.parallel.gspmd import _is_row_shardable

    for opt in ("rwsadagrad", "adagrad"):
        for tree in _jax_trees(variant, opt):
            flat = jax.tree_util.tree_flatten_with_path(tree)[0]
            port = _flat(params_from_jax(_np_tree(tree), device="cpu"))
            port = [(p, x) for p, x in port if isinstance(x, torch.Tensor)]
            assert len(port) == len([1 for _, x in flat if np.ndim(x)])
            for path, leaf in flat:
                assert path_keys(path) == jax_path_keys(path)
                assert _is_row_shardable(path, leaf) == bool(
                    jax_rule(path, leaf)), path
            arrays = [(p, x) for p, x in flat if np.ndim(x)]
            for (jpath, jleaf), (ppath, pleaf) in zip(arrays, port):
                assert path_keys(ppath) == jax_path_keys(jpath)
                assert _is_row_shardable(ppath, pleaf) == bool(
                    jax_rule(jpath, jleaf)), ppath


def test_host_helpers_match_jax():
    """stack_tables, offsets_to_padded and padded_to_offsets against the
    JAX package's copies: truncated bags, weights, lengths."""
    from dlrm_tpu.ops import embedding as J
    from dlrm_tpu_torch.ops import embedding as P

    rng = np.random.default_rng(3)
    tables = [rng.normal(size=(n, 4)).astype(np.float32) for n in (5, 9, 2)]
    for x, y in zip(P.stack_tables(tables), J.stack_tables(tables)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="equal widths"):
        P.stack_tables([np.zeros((2, 3)), np.zeros((2, 4))])
    lengths = np.array([3, 0, 5, 1, 2])
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    indices = rng.integers(0, 50, lengths.sum())
    psw = rng.normal(size=lengths.sum()).astype(np.float32)
    for hot in (2, 5):
        for w in (None, psw):
            got = P.offsets_to_padded(indices, offsets, hot, w)
            want = J.offsets_to_padded(indices, offsets, hot, w)
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
            for ln in (None, np.minimum(lengths, hot)):
                for x, y in zip(P.padded_to_offsets(*got, lengths=ln),
                                J.padded_to_offsets(*got, lengths=ln)):
                    np.testing.assert_array_equal(x, y)
                    assert x.dtype == y.dtype


@pytest.mark.parametrize("grid", list(GRIDS))
def test_batch_slices_match_jax_shards(grid):
    """batch_slice (GspmdDLRM.shard_batch's) of each rank of the grid: the
    padded layout equals the shard of JAX's GspmdDLRM.shard_batch on the
    matching device, and the flat layout equals the flat layout of that
    slice."""
    from dlrm_tpu.parallel.gspmd import GspmdDLRM as JaxGspmd
    from dlrm_tpu_torch.parallel.gspmd import batch_slice

    dsize, msize = GRIDS[grid]
    n = dsize * msize
    hb = _helper_batch(11)
    jmesh = _jax_mesh(grid)
    jb = JaxGspmd(None, jmesh).shard_batch(_jax_batch(hb))
    for k, dev in enumerate(jmesh.devices.reshape(-1)):
        got = batch_slice(hb.to_device("cpu"), k, n)
        for x, f in zip(got[:4], ("dense", "idx", "wt", "labels")):
            want = next(s.data for s in getattr(jb, f).addressable_shards
                        if s.device == dev)
            np.testing.assert_array_equal(x.numpy(), np.asarray(want))
        b = B // n
        rows = slice(k * b, (k + 1) * b)
        sl = HostBatch(hb.dense[rows], hb.idx[:, rows], hb.wt[:, rows],
                       hb.labels[rows]).to_device("cpu", flat_hots=HOTS)
        flat = batch_slice(hb.to_device("cpu", flat_hots=HOTS), k, n, HOTS)
        for x, y in zip(flat[:4], sl[:4]):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="hot_sizes"):
        batch_slice(hb.to_device("cpu", flat_hots=HOTS), 0, n)
    with pytest.raises(ValueError, match="does not split"):
        batch_slice(hb.to_device("cpu"), 0, 3)


def test_batch_helpers_match_jax(both):
    """global_batch_from_replicated on each rank equals JAX's global
    array's shard on the matching device, and global_batch_from_local_shard
    assembles the global batch JAX's gives (one process: local = global)."""
    from dlrm_tpu.parallel.multihost import (
        global_batch_from_local_shard as jax_from_local,
        global_batch_from_replicated as jax_from_replicated,
    )
    from jax.sharding import PartitionSpec as P

    hb = _helper_batch(7)
    for grid, ranks in both[2].items():
        jmesh = _jax_mesh(grid)
        specs = tuple(P(*s) for s in SPECS)
        rep = jax_from_replicated(jmesh, _jax_batch(hb), specs)
        whole = jax_from_local(jmesh, _jax_batch(hb), specs)
        for r in ranks:
            (mine, gathered), k = r["helpers"]
            dev = jmesh.devices.reshape(-1)[k]
            for x, f in zip(mine, ("dense", "idx", "wt", "labels")):
                want = next(s.data for s in getattr(rep, f).addressable_shards
                            if s.device == dev)
                np.testing.assert_array_equal(x, np.asarray(want), f)
            for x, f in zip(gathered, ("dense", "idx", "wt", "labels")):
                np.testing.assert_array_equal(
                    x, np.asarray(getattr(whole, f)), f)


def test_one_rank_is_the_single_device_step():
    """On a 1 x 1 grid GspmdDLRM is train/step.py's dense step: the same
    losses and params to the bit after 3 steps, QR and v_w included."""
    from dlrm_tpu_torch.parallel.gspmd import GspmdDLRM
    from dlrm_tpu_torch.parallel.mesh import make_mesh
    from dlrm_tpu_torch.train.step import make_train_step

    for variant in ("plain", "qr", "weighted"):
        model = DLRMModel(DLRMConfig(**_cfg(variant)))
        params = model.init_params(seed=4, device="cpu")
        runner = GspmdDLRM(model, make_mesh(), device="cpu")
        sp = runner.shard_params(params)
        st = runner.shard_opt_state(init_opt_state("rwsadagrad", params))
        p1 = tree_map(torch.clone, params)
        s1 = init_opt_state("rwsadagrad", p1)
        step, step1 = (runner.make_train_step("rwsadagrad"),
                       make_train_step(model, "rwsadagrad"))
        for hb in _batches(4)[0]:
            batch = hb.to_device("cpu")
            sp, st, loss, _ = step(sp, st, runner.shard_batch(batch), LR)
            p1, s1, loss1, _ = step1(p1, s1, batch, LR)
            assert torch.equal(loss, loss1), variant
        for (path, x), (_, y) in zip(_flat(sp), _flat(p1)):
            assert torch.equal(x, y), (variant, path)


def test_a_row_sharded_table_answers_only_its_lookups():
    """F.embedding_bag (mode "sum") and indexing; anything else raises."""
    from dlrm_tpu_torch.parallel.row_sharded import RowShardedTable

    t = RowShardedTable(torch.ones(4, 2), Axis(None, [0], 0))
    idx = torch.tensor([[0, 3], [1, 1]])
    assert torch.equal(F.embedding_bag(idx, t, mode="sum"),
                       torch.full((2, 2), 2.0))
    assert torch.equal(t[torch.tensor([2])], torch.ones(1, 2))
    with pytest.raises(NotImplementedError, match="mode='sum'"):
        F.embedding_bag(idx, t, mode="mean")
    with pytest.raises(NotImplementedError, match="row-sharded"):
        torch.matmul(t, torch.ones(2, 2))
