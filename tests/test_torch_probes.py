"""The probes' plain versions (dlrm_tpu_torch/ops/probe_kernels.py) against
the JAX probes' own Pallas kernels under bench_scripts/, which run here in
TPU interpret mode at small sizes (the size globals set on the loaded
module, the files untouched), and the probes' entry points on the CPU. The
CUDA kernels are held against these plain versions by
tests/test_torch_cuda_probes.py (skipped without a card) and chip_smoke.py.

Exact: P1 and P5a gathers, P2b's takes, P4's walks, P5b's scatter-add with
unique indices (the same copies and one fp32 add each). P2a rtol 1e-6
(XLA may fuse the reference's multiply and add). P6: the expressions the
reference's t-functions assert, at their tolerances. P3: V1/V2/V5/V6 against
dlrm_tpu's stream_update (sgd, interpret mode) on the blocks the items name,
rtol 1e-5 / atol 1e-6 (one-hot matmul sums against slot-order sums); the
skeletons leave the table as it was."""

import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from dlrm_tpu.ops import stream_kernels as jk
from dlrm_tpu.ops import stream_plan as jsp
from dlrm_tpu_torch.ops import probe_kernels as pk
from dlrm_tpu_torch.ops import stream_plan as tsp
from dlrm_tpu_torch.probes import (
    k2_bisect,
    kernel_feasibility,
    pallas_probe,
    revolve_probe,
    scan_probe,
    stream_variants,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _bench(name):
    """bench_scripts/<name>.py loaded as a module (the directory is not a
    package)."""
    spec = importlib.util.spec_from_file_location(
        f"bench_scripts_{name}", ROOT / "bench_scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    return np.array(x)  # a writable copy


def _table(rows, d=128, seed=0):
    return np.random.default_rng(seed).normal(size=(rows, d)).astype(
        np.float32)


# ------------------------------------------------------------- P1, P5a
@pytest.mark.parametrize("order", ["random", "sorted"])
@pytest.mark.parametrize("probe", ["scan_probe", "pallas_probe"])
def test_row_gather_matches_pallas_gather(probe, order):
    table = _table(200)
    idx = np.random.default_rng(1).integers(0, 200, 64).astype(np.int32)
    if order == "sorted":
        idx = np.sort(idx)
    with pltpu.force_tpu_interpret_mode():
        want = _bench(probe).pallas_gather(jnp.asarray(table),
                                           jnp.asarray(idx), chunk=16)
    got = pk.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), _np(want))


# ------------------------------------------------------------------ P5b
def test_row_scatter_add_matches_pallas_scatter_add():
    table = _table(300)
    rng = np.random.default_rng(2)
    idx = rng.permutation(300)[:64].astype(np.int32)
    delta = rng.normal(size=(64, 128)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _bench("pallas_probe").pallas_scatter_add(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(delta),
            chunk=16)
    t = torch.from_numpy(table.copy())
    got = pk.row_scatter_add_(t, torch.from_numpy(idx),
                              torch.from_numpy(delta), check_unique=True)
    assert got is t  # in place
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_row_scatter_add_refuses_repeated_indices_when_asked():
    t = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="unique"):
        pk.row_scatter_add_(t, torch.tensor([1, 1], dtype=torch.int32),
                            torch.ones((2, 4)), check_unique=True)


# ------------------------------------------------------------------ P2b
def test_takes_match_stream_variants_t1(capsys):
    """The reference's two takes pass in interpret mode, and the port's
    row_gather gives their reference expressions exactly."""
    with pltpu.force_tpu_interpret_mode():
        _bench("stream_variants").t1_variants()
    printed = capsys.readouterr().out
    assert "T1v1 take 2D idx: OK" in printed
    assert "T1v2 take lanes: OK" in printed
    dly = _np(jax.random.normal(jax.random.PRNGKey(0), (256, 128)))
    idx2 = np.random.default_rng(0).integers(0, 256, (8, 128)).astype(
        np.int32)
    got = pk.row_gather(torch.from_numpy(dly), torch.from_numpy(idx2))
    np.testing.assert_array_equal(got.numpy(), np.take(dly, idx2, axis=0))
    dly_t = torch.from_numpy(np.ascontiguousarray(dly.T))  # [128, 256]
    lanes = pk.row_gather(dly_t.T, torch.from_numpy(idx2[0])).T
    np.testing.assert_array_equal(lanes.numpy(),
                                  np.take(dly.T, idx2[0], axis=1))


# ------------------------------------------------------------------ P2a
@pytest.mark.parametrize("alias,donate", [(False, False), (False, True),
                                          (True, True)])
def test_block_stream_matches_make_stream(monkeypatch, alias, donate):
    sv = _bench("stream_variants")
    monkeypatch.setattr(sv, "R", 64)
    monkeypatch.setattr(sv, "BR", 16)
    t = _table(64, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = _np(sv.make_stream(alias, donate)(jnp.asarray(t)))
    src = torch.from_numpy(t.copy())
    kw = dict(scale=stream_variants.SCALE, shift=stream_variants.SHIFT,
              block_rows=16)
    got = (pk.block_stream(src, **kw) if alias
           else pk.block_stream(src, out=torch.empty_like(src), **kw))
    assert (got is src) == alias
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


# ------------------------------------------------------------------- P4
def _revolve_port(variant, t, ib):
    kw = dict(scale=1.0, shift=1.0, block_rows=16)
    src = torch.from_numpy(t.copy())
    out = torch.full_like(src, float("nan"))
    calls = {
        "S": lambda: pk.block_stream(src, None, out=out, **kw),
        "D": lambda: pk.block_stream(src, ib, out=out, **kw),
        "M": lambda: pk.block_stream(src, ib, **kw),
        "N": lambda: pk.block_stream(src, None, **kw),
        "P": lambda: pk.block_stream(src, None, out=out, depth=2, **kw),
        "Q": lambda: pk.block_stream(src, None, out=out, depth=4, **kw),
        "E": lambda: pk.block_stream_plain(src, None, out=out, **kw),
        "X": lambda: pk.block_stream_plain(src, ib, **kw),
    }
    return calls[variant]().numpy()


@pytest.mark.parametrize("variant", list("SDMNPQEX"))
def test_block_stream_matches_revolve_probe(monkeypatch, variant):
    rp = _bench("revolve_probe")
    monkeypatch.setattr(rp, "BR", 16)
    monkeypatch.setattr(rp, "NBLK", 4)
    t = _table(64, seed=4)
    ib = np.arange(4, dtype=np.int32)  # the reference's walk
    with pltpu.force_tpu_interpret_mode():
        want = _np(rp.build(variant)(jnp.asarray(ib), jnp.asarray(t)))
    got = _revolve_port(variant, t, torch.from_numpy(ib))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", list("DMX"))
def test_block_stream_matches_revolve_probe_permuted_walk(monkeypatch,
                                                          variant):
    """D, M and X read the walk for both sides: a permuted walk gives
    out[ib[g]] = t[ib[g]] + 1 on both."""
    rp = _bench("revolve_probe")
    monkeypatch.setattr(rp, "BR", 16)
    monkeypatch.setattr(rp, "NBLK", 4)
    t = _table(64, seed=5)
    ib = np.array([2, 0, 3, 1], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = _np(rp.build(variant)(jnp.asarray(ib), jnp.asarray(t)))
    got = _revolve_port(variant, t, torch.from_numpy(ib))
    np.testing.assert_array_equal(got, want)


def test_block_stream_partial_walk_leaves_other_blocks():
    t = torch.arange(6 * 4 * 8, dtype=torch.float32).reshape(24, 8)
    out = torch.zeros_like(t)
    pk.block_stream(t, torch.tensor([4, 1], dtype=torch.int32), scale=2.0,
                    shift=-1.0, out=out, block_rows=4)
    want = torch.zeros_like(t)
    for b in (4, 1):
        want[b * 4:(b + 1) * 4] = t[b * 4:(b + 1) * 4] * 2.0 - 1.0
    assert torch.equal(out, want)


# ------------------------------------------------------------------- P6
def _kf():
    return _bench("kernel_feasibility")


def test_feasibility_t1_take():
    with pltpu.force_tpu_interpret_mode():
        _kf().t1()
    dly = _np(jax.random.normal(jax.random.PRNGKey(0), (256, 128)))
    idx = np.random.default_rng(0).integers(0, 256, (8, 128)).astype(
        np.int32)
    got = pk.row_gather(torch.from_numpy(dly), torch.from_numpy(idx[0]))
    np.testing.assert_array_equal(got.numpy(), np.take(dly, idx[0], axis=0))


def test_feasibility_t2_contract():
    with pltpu.force_tpu_interpret_mode():
        _kf().t2()
    a = _np(jax.random.normal(jax.random.PRNGKey(0), (8, 128, 256)))
    b = _np(jax.random.normal(jax.random.PRNGKey(1), (8, 128, 128)))
    got = pk.t2_contract(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.einsum("slr,sld->rd", a, b),
                               rtol=0, atol=1e-3)


def test_feasibility_t3_reshape_add():
    with pltpu.force_tpu_interpret_mode():
        _kf().t3()
    x = np.arange(8 * 128, dtype=np.int32).reshape(8, 128)
    got = pk.t3_reshape_add(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x + 1)


def test_feasibility_t4_onehot_accumulate():
    with pltpu.force_tpu_interpret_mode():
        _kf().t4()
    cap, rows = 256, 512
    idx = np.random.default_rng(0).integers(0, rows, (cap, 1)).astype(
        np.int32)
    g = _np(jax.random.normal(jax.random.PRNGKey(0), (cap, 128)))
    got = pk.t4_onehot_accumulate(torch.from_numpy(idx), torch.from_numpy(g),
                                  rows)
    oh = np.eye(rows, dtype=np.float32)[idx[:, 0]]
    np.testing.assert_allclose(got.numpy(), oh.T @ g, rtol=0, atol=1e-4)


def test_feasibility_t6_revolve_accumulate():
    with pltpu.force_tpu_interpret_mode():
        _kf().t6()
    nb, br, d, steps = 4, 256, 128, 3
    x = _np(jax.random.normal(jax.random.PRNGKey(0),
                              (nb * steps * br, d)))
    got = pk.t6_revolve_accumulate(torch.from_numpy(x), steps, br)
    want = x.reshape(nb, steps, br, d).sum(axis=1).reshape(nb * br, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# T3 at shapes whose numel is not a multiple of 4, and a start that is not
# 16-byte aligned (x[1:] of a contiguous buffer), held to the reference's
# own expression x + 1 in jax.numpy, exactly
@pytest.mark.parametrize("shape", [(3, 5), (1, 1), (7, 129), (8, 128)])
@pytest.mark.parametrize("offset", [0, 1])
def test_t3_reshape_add_ragged_matches_jnp(shape, offset):
    n = shape[0] * shape[1]
    buf = np.random.default_rng(n).integers(
        -2**31, 2**31 - 1, n + offset, dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(buf)[offset:].view(shape)
    got = pk.t3_reshape_add(x)
    want = jnp.asarray(buf[offset:].reshape(shape)) + 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# T6: a block of numel % 4 != 0, steps 1, one output block, steps past the
# kernel's loads of 4 at a time, against the reference's own expression in
# jax.numpy (x.reshape(nb, steps, br, d).sum(axis=1)) at its atol 1e-5
T6_SHAPES = [(2, 3, 5, 3), (3, 1, 4, 8), (1, 3, 256, 128), (2, 5, 3, 7),
             (1, 4, 2, 4)]


@pytest.mark.parametrize("nb,steps,br,d", T6_SHAPES)
def test_t6_revolve_accumulate_ragged_matches_jnp(nb, steps, br, d):
    x = np.random.default_rng(nb * steps).normal(
        size=(nb * steps * br, d)).astype(np.float32)
    got = pk.t6_revolve_accumulate(torch.from_numpy(x), steps, br)
    want = jnp.asarray(x).reshape(nb, steps, br, d).sum(axis=1)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(nb * br, d),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("nb,steps,br,d", T6_SHAPES)
def test_t6_revolve_accumulate_plain_adds_in_step_order(nb, steps, br, d):
    """The plain version (the kernel's contract) equals, bit for bit, fp32
    adds in j order from +0.0, negative zeros included."""
    x = np.random.default_rng(steps).normal(
        size=(nb, steps, br, d)).astype(np.float32)
    x[..., 0] = -0.0  # 0.0 + -0.0 is +0.0: the sum starts from +0.0
    want = np.zeros((nb, br, d), np.float32)
    for j in range(steps):
        want = want + x[:, j]
    got = pk.t6_revolve_accumulate_plain(
        torch.from_numpy(x.reshape(-1, d)), steps, br)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.reshape(nb * br, d).view(np.int32))


# T2 at ragged shapes (R and C not multiples of 4, K = 1, a K that is not
# a whole number of the kernel's stages) and the reference's own, with an a
# that starts 4 bytes past a 16-byte boundary (a[1:] of a contiguous
# buffer), held to the reference's expression in jax.numpy at its atol 1e-3
T2_SHAPES = [(1, 1, 1, 1), (3, 7, 33, 17), (2, 129, 65, 3), (8, 128, 256, 128)]


@pytest.mark.parametrize("s,l,r,c", T2_SHAPES)
@pytest.mark.parametrize("offset", [0, 1])
def test_t2_contract_ragged_matches_jnp(s, l, r, c, offset):
    rng = np.random.default_rng(s * l + r + c)
    abuf = rng.normal(size=s * l * r + offset).astype(np.float32)
    b = rng.normal(size=(s, l, c)).astype(np.float32)
    a = torch.from_numpy(abuf)[offset:].view(s, l, r)
    got = pk.t2_contract(a, torch.from_numpy(b))
    want = jnp.einsum("slr,sld->rd",
                      jnp.asarray(abuf[offset:].reshape(s, l, r)),
                      jnp.asarray(b))
    assert got.shape == (r, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


# T4 at ragged shapes, with every hit on one row and with indices outside
# [0, rows) (negative and past the last row), held to the reference's own
# expression in jax.numpy: the one-hot (idx.reshape(cap, 1) == iota) and
# dot_general at HIGHEST, within its atol 1e-4
def _t4_inputs(cap, rows, d, kind):
    rng = np.random.default_rng(cap * 1009 + rows * 31 + d)
    if kind == "spread":
        idx = rng.integers(0, rows, cap)
    elif kind == "one_row":
        idx = np.full(cap, rows // 2)
    else:  # out_of_range: about a third of the hits in [0, rows)
        idx = rng.integers(-rows - 3, 2 * rows + 3, cap)
        idx[:2] = np.array([-1, rows])[:cap]  # one below, one past
    g = rng.normal(size=(cap, d)).astype(np.float32)
    return idx.astype(np.int32).reshape(cap, 1), g


T4_KINDS = ["spread", "one_row", "out_of_range"]


@pytest.mark.parametrize("kind", T4_KINDS)
@pytest.mark.parametrize("d", [1, 3, 128, 129])
@pytest.mark.parametrize("rows", [1, 30, 512])
@pytest.mark.parametrize("cap", [1, 37, 256])
def test_t4_onehot_accumulate_ragged_matches_jnp(cap, rows, d, kind):
    idx, g = _t4_inputs(cap, rows, d, kind)
    got = pk.t4_onehot_accumulate(torch.from_numpy(idx), torch.from_numpy(g),
                                  rows)
    iota = jax.lax.broadcasted_iota(jnp.int32, (cap, rows), 1)
    oh = (jnp.asarray(idx).reshape(cap, 1) == iota).astype(jnp.float32)
    want = jax.lax.dot_general(
        oh, jnp.asarray(g), dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    assert got.shape == (rows, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("cap,rows,d,kind", [
    (1, 1, 1, "spread"), (37, 30, 3, "out_of_range"),
    (256, 512, 128, "spread"), (256, 512, 129, "out_of_range"),
    (256, 30, 128, "one_row"), (4096, 8, 129, "spread"),
    (20_000, 3, 64, "out_of_range")])
def test_t4_onehot_accumulate_plain_adds_in_index_order(cap, rows, d, kind):
    """The plain version (the kernel's contract, which the card holds bit
    for bit) equals fp32 adds in index order from +0.0, out-of-range hits
    dropped, negative zeros included."""
    idx, g = _t4_inputs(cap, rows, d, kind)
    g[:, 0] = -0.0  # 0.0 + -0.0 is +0.0: each row's sum starts from +0.0
    want = np.zeros((rows, d), np.float32)
    for c, r in enumerate(idx[:, 0]):
        if 0 <= r < rows:
            want[r] = want[r] + g[c]
    got = pk.t4_onehot_accumulate_plain(torch.from_numpy(idx),
                                        torch.from_numpy(g), rows)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


# ------------------------------------------------------------------- P3
TABLES = (300, 50, 700)
B, H, BR, LR = 256, 2, 1024, 0.05


@functools.lru_cache(maxsize=None)
def _k2_case():
    """A tiny plan's full work list, a table, G_u and dlrm_tpu's sgd
    stream_update (interpret mode) on them."""
    rng = np.random.default_rng(7)
    plan = tsp.make_stream_plan(TABLES, 128, B, H, block_rows=BR)
    idx = np.stack([rng.integers(0, n, (B, H)) for n in TABLES]).astype(
        np.int32)
    work = tsp.build_stream_work(plan, idx, prefer_native=False)
    table = (rng.normal(size=(plan.padded_rows, 128)) * 0.05).astype(
        np.float32)
    g_u = rng.normal(size=(plan.u_total, 128)).astype(np.float32)
    jplan = jsp.make_stream_plan(TABLES, 128, B, H, block_rows=BR)
    (want,) = jk.stream_update(
        "sgd", jplan, jnp.asarray(table), None, jnp.asarray(g_u),
        jnp.asarray(work.rows_u), jnp.asarray(work.item_block),
        jnp.asarray(work.item_row0), jnp.asarray(work.item_u), LR,
        interpret=True)
    return plan, work, table, g_u, _np(want)


@pytest.mark.parametrize("variant", sorted(pk.K2_VARIANTS))
def test_k2_bisect_plain_matches_jax_stream_update(variant):
    plan, work, table, g_u, want = _k2_case()
    t = torch.from_numpy(table.copy())
    got = pk.k2_bisect(
        variant, plan, t, torch.from_numpy(g_u),
        *(torch.from_numpy(a) for a in (work.rows_u, work.item_block,
                                        work.item_row0, work.item_u)), LR)
    assert got is t  # in place
    if not pk.K2_VARIANTS[variant]:
        np.testing.assert_array_equal(got.numpy(), table)
        return
    named = np.unique(work.item_block[work.item_block < plan.num_blocks])
    rows = (named[:, None] * BR + np.arange(BR)).reshape(-1)
    assert not np.array_equal(got.numpy()[rows], table[rows])
    np.testing.assert_allclose(got.numpy()[rows], want[rows], rtol=1e-5,
                               atol=1e-6)


def test_k2_bisect_rejects_unknown_variant():
    plan, work, table, g_u, _ = _k2_case()
    with pytest.raises(ValueError, match="V7"):
        pk.k2_bisect("V7", plan, torch.from_numpy(table),
                     torch.from_numpy(g_u),
                     *(torch.from_numpy(a) for a in (
                         work.rows_u, work.item_block, work.item_row0,
                         work.item_u)), LR)


# ---------------------------------------------- the entry points (CPU)
def test_scan_probe_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(scan_probe, "ROWS_TOTAL", 500)
    monkeypatch.setattr(scan_probe, "N", 26 * 8)
    res = scan_probe.main("cpu")
    assert "row_gather random" in res and "CAL" in capsys.readouterr().out
    assert res["row_gather random"]["nbytes"] == 2 * 26 * 8 * 128 * 4 + 26 * 32


def test_pallas_probe_main_on_cpu(monkeypatch):
    monkeypatch.setattr(pallas_probe, "ROWS_TOTAL", 500)
    monkeypatch.setattr(pallas_probe, "N", 64)
    res = pallas_probe.main("cpu")
    assert set(res) == {"torch index_select", "row_gather",
                        "torch index_add_ (unique)", "row_scatter_add"}


def test_stream_variants_main_on_cpu(monkeypatch):
    monkeypatch.setattr(stream_variants, "R", 64)
    monkeypatch.setattr(stream_variants, "BR", 16)
    res = stream_variants.main("cpu")
    assert set(res["t1"].values()) == {"OK"}
    assert len(res["stream"]) == 4


def test_revolve_probe_main_on_cpu(monkeypatch):
    monkeypatch.setattr(revolve_probe, "NBLK", 4)
    monkeypatch.setattr(revolve_probe, "BR", 16)
    res = revolve_probe.main("cpu")
    assert set(res) == set(revolve_probe.VARIANTS.split(","))


def _tiny_shape():
    plan = tsp.make_stream_plan(TABLES, 128, B, H, block_rows=BR)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, (B, H)) for n in TABLES]).astype(
        np.int32)
    return plan, tsp.build_stream_work(plan, idx, prefer_native=False)


def test_k2_bisect_main_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(k2_bisect, "probe_shape", _tiny_shape)
    monkeypatch.setattr(k2_bisect, "main_path_shape", _tiny_shape)
    res = k2_bisect.main("cpu")
    assert set(res) == {"probe", "main-path"}
    res = res["probe"]
    assert set(pk.K2_VARIANTS) | set(k2_bisect.K2_LADDER) | {
        k2_bisect.LIBRARY} <= set(res)
    geo = res["geometry"]
    assert geo["hits"] == len(TABLES) * B * H
    assert res["V4"]["nbytes"] == 2 * geo["tiles"] * 128 * 128 * 4
    printed = capsys.readouterr().out
    assert "split: G reads and sums (V1 - V3)" in printed
    assert "split: rwsadagrad instead of sgd, bf16 table" in printed


def test_kernel_feasibility_main_on_cpu(monkeypatch):
    monkeypatch.setattr(kernel_feasibility, "T5_ROWS", 2048)
    res = kernel_feasibility.main("cpu")
    assert set(res.values()) == {"OK"}
