"""P3: which of K2's stages costs its time (the port of
bench_scripts/k2_bisect.py). Runs the variants of csrc/k2_bisect.cu — K2's
sgd update on an fp32 table by one CTA per (block, 128-row tile), which
finds its tile's hits by binary search over the block's row-sorted slots
and sums each row's run in registers, with its stages compiled in or out —
at two shapes, each on the full cover item list:

  probe      the reference's: 26 tables x 200,000 rows, d 128, batch 2048,
             8 uniform hits per bag, block_rows 2048;
  main-path  the train step's: the same tables, batch 16,384, the ragged
             v2 hot sizes (214 hits per sample), where K2 runs on the card.

  V1  full update, writing only rows that got a hit (K2's bits, sgd, fp32)
  V2  full update, writing every row of each visited 128-row tile
  V3  skeleton: scans rows_u, writes the hit rows, reads no G row
  V4  skeleton writing every row of each visited tile: the revolve floor
  V5  V4 with the tile stored by one bulk copy
  V6  V2 with the tile stored by one bulk copy

At each shape it also times K2 itself (stream_update, a warp per touched
row's run of hits) on a ladder of
configurations from V1's to the train step's, one change per rung:

  sgd fp32                  V1's: fp32 table, fp32 G
  sgd fp32 mm bf16          each G row rounded to bf16 before the sums
  sgd fp32 G_u bf16         the same values, G_u stored in bf16 (the step's
                            g_dtype): half the G bytes
  sgd bf16 sr mm bf16       a bf16 table written with stochastic rounding
  rwsadagrad bf16 sr        the train step's: row-wise Adagrad's epilogue
                            and its fp32 accumulator
  rwsadagrad fp32           the epilogue on an fp32 table, beside sgd fp32

and the library call that computes V1's function, one
Tensor.index_add_(0, hit rows, hit G rows, alpha=-lr) (it adds each hit in
turn with atomics where K2 sums a row's hits first, and it is given only
the real slots' G rows, gathered beforehand, where K2 skips the sentinel
slots itself). It checks every variant and the library call once against
their values (the sgd update or the unchanged table) and prints the time
split by stage.

    python -m dlrm_tpu_torch.probes.k2_bisect [V1,V2,...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from dlrm_tpu_torch.data.random_data import (
    V2_HOT_SIZES,
    ragged_multihot_batch,
)
from dlrm_tpu_torch.ops.probe_kernels import K2_VARIANTS, k2_bisect
from dlrm_tpu_torch.ops.stream_kernels import stream_update
from dlrm_tpu_torch.ops.stream_plan import (
    SENTINEL_ROW,
    WINDOW,
    build_stream_work,
    make_stream_plan,
)
from dlrm_tpu_torch.probes.common import probe_device, record, time_ms

NAMES = {
    "V1": "V1 sgd full, hit-row writes (K2)",
    "V2": "V2 sgd full, whole-tile writes",
    "V3": "V3 skeleton, hit-row writes",
    "V4": "V4 skeleton, whole-tile writes",
    "V5": "V5 skeleton, whole tiles by bulk copy",
    "V6": "V6 sgd full, whole tiles by bulk copy",
}
# K2's ladder: rung -> (optimizer, table dtype, mm_dtype, stochastic round,
# G_u dtype)
F32, BF16 = torch.float32, torch.bfloat16
K2_LADDER = {
    "K2 sgd fp32": ("sgd", F32, F32, False, F32),
    "K2 sgd fp32 mm bf16": ("sgd", F32, BF16, False, F32),
    "K2 sgd fp32 G_u bf16": ("sgd", F32, BF16, False, BF16),
    "K2 sgd bf16 sr mm bf16": ("sgd", BF16, BF16, True, F32),
    "K2 rwsadagrad bf16 sr": ("rwsadagrad", BF16, BF16, True, F32),
    "K2 rwsadagrad fp32": ("rwsadagrad", F32, F32, False, F32),
}
LIBRARY = "torch index_add_ (sgd on the hits)"
TABLES = tuple([200_000] * 26)
LR = 0.01
ITERS = 10


def probe_shape():
    """The reference's shape: uniform hits, random rows."""
    d, b, h, br = 128, 2048, 8, 2048
    plan = make_stream_plan(TABLES, d, b, h, block_rows=br)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, n, (b, h)) for n in TABLES]).astype(
        np.int32)
    return plan, build_stream_work(plan, idx)


def main_path_shape():
    """The train step's shape: bench.py's ragged batch, full item list."""
    d, b, br = 128, 16_384, 2048
    plan = make_stream_plan(TABLES, d, b, V2_HOT_SIZES, block_rows=br)
    hb = ragged_multihot_batch(np.random.default_rng(0), 13, TABLES,
                               V2_HOT_SIZES, b)
    return plan, hb.with_stream_work(plan, unit_weights=True).stream


def hit_rows(plan, work):
    """The real slots of the work and each one's row of the stacked
    table."""
    rows = work.rows_u.reshape(-1)
    slots = np.flatnonzero(rows != SENTINEL_ROW)
    table = np.repeat(work.w2t, WINDOW)[slots]
    return slots, np.asarray(plan.padded_offsets, np.int64)[table] + rows[
        slots]


def geometry(plan, work) -> dict:
    """What this work needs moved: hits, touched rows, visited tiles."""
    slots, grow = hit_rows(plan, work)
    blocks = np.unique(work.item_block[work.item_block < plan.num_blocks])
    return {"hits": int(slots.size), "touched": int(np.unique(grow).size),
            "tiles": int(blocks.size) * (plan.block_rows // 128),
            "slots": int(work.rows_u.size),
            "items": int(work.item_block.size)}


def variant_bytes(variant, geo, d) -> int:
    """Bytes the variant must move once: each visited tile read and written
    (whole-tile variants) or each touched row (hit-row variants); the hits'
    G rows where it sums; rows_u and the items where it scans."""
    row = d * 4
    whole = variant in ("V2", "V4", "V5", "V6")
    n = (2 * geo["tiles"] * 128 * row if whole
         else 2 * geo["touched"] * row)
    if K2_VARIANTS[variant]:
        n += geo["hits"] * row
    if variant not in ("V4", "V5"):
        n += geo["slots"] * 4 + geo["items"] * 12
    return n


def rung_bytes(optimizer, table_dtype, g_dtype, geo, d) -> int:
    """Bytes a rung of K2's ladder must move once: V1's, with the table
    rows in table_dtype, the hits' G rows in g_dtype and, for rwsadagrad,
    each touched row's fp32 accumulator read and written."""
    row = d * table_dtype.itemsize
    return (geo["hits"] * d * g_dtype.itemsize + 2 * geo["touched"] * row
            + geo["slots"] * 4 + geo["items"] * 12
            + (2 * geo["touched"] * 4 if optimizer == "rwsadagrad" else 0))


def run_shape(tag, plan, work, dev, variants) -> dict:
    geo = geometry(plan, work)
    d = plan.dim
    print(f"[{tag}] padded_rows {plan.padded_rows}, u_total {plan.u_total}, "
          f"items {geo['items']}, hits {geo['hits']}, touched rows "
          f"{geo['touched']}, visited tiles {geo['tiles']}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    table = torch.randn((plan.padded_rows, d), generator=gen, device=dev)
    g_u = torch.randn((plan.u_total, d), generator=gen, device=dev) * 1e-6

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    items = (put(work.rows_u), put(work.item_block), put(work.item_row0),
             put(work.item_u))
    # each variant's values: the sgd update (K2's) or the table itself
    k2_sgd = stream_update("sgd", plan, table.clone(), None, g_u, *items,
                           LR)[0]
    res = {}
    for v in variants:
        got = k2_bisect(v, plan, table.clone(), g_u, *items, LR)
        want = k2_sgd if K2_VARIANTS[v] else table
        if not torch.equal(got, want):
            raise AssertionError(f"[{tag}] {v} differs from its values")
        del got
        t = table.clone()
        ms = time_ms(lambda: k2_bisect(v, plan, t, g_u, *items, LR), dev,
                     ITERS)
        del t
        res[v] = record(f"[{tag}] {NAMES[v]}", ms, dev,
                        nbytes=variant_bytes(v, geo, d), width=52)
    # the library call for V1's function: the hits' G rows and rows
    # gathered beforehand, then one index_add_
    slots, grow = (put(a) for a in hit_rows(plan, work))
    g_hits = g_u[slots]
    lib = table.clone().index_add_(0, grow, g_hits, alpha=-LR)
    if not torch.allclose(lib, k2_sgd, rtol=1e-5, atol=1e-6):
        raise AssertionError(f"[{tag}] index_add_ differs from the sgd "
                             "update")
    del lib, k2_sgd, slots
    t = table.clone()
    res[LIBRARY] = record(
        f"[{tag}] {LIBRARY}",
        time_ms(lambda: t.index_add_(0, grow, g_hits, alpha=-LR), dev,
                ITERS), dev,
        nbytes=geo["hits"] * (d * 4 + 8) + 2 * geo["touched"] * d * 4,
        width=52)
    del g_hits, grow
    acc = torch.zeros((plan.acc_rows, 128), device=dev)
    g_u16 = g_u.to(BF16)
    for name, (opt, tdt, mm, sr, gdt) in K2_LADDER.items():
        t = table.to(tdt)
        g = g_u16 if gdt == BF16 else g_u
        res[name] = record(
            f"[{tag}] {name}",
            time_ms(lambda: stream_update(
                opt, plan, t, acc if opt == "rwsadagrad" else None, g,
                *items, LR, mm_dtype=mm, stochastic_round=sr, seed=1),
                dev, ITERS), dev, nbytes=rung_bytes(opt, tdt, gdt, geo, d),
            width=52)
        del t
    print(f"[{tag}] all variants and the library call hold their values",
          flush=True)
    split(tag, res)
    res["geometry"] = geo
    return res


def split(tag, res) -> None:
    """K2's time by stage, from the differences of the variants and of the
    ladder's rungs."""
    ms = {v: r["ms"] for v, r in res.items() if isinstance(r, dict)
          and "ms" in r}
    s32, s32b, g16, s16, r16, r32 = K2_LADDER
    parts = (
        ("revolve floor: read+write every visited tile (V4)", ("V4",), ()),
        ("bulk store instead of thread stores (V5 - V4)", ("V5",), ("V4",)),
        ("scan rows_u, hit-row writes (V3)", ("V3",), ()),
        ("G reads and sums (V1 - V3)", ("V1",), ("V3",)),
        ("whole-tile instead of hit-row writes (V2 - V1)", ("V2",), ("V1",)),
        ("bulk store with the sums (V6 - V2)", ("V6",), ("V2",)),
        ("G rounded to bf16 in the sums", (s32b,), (s32,)),
        ("G_u stored bf16 (half the G bytes)", (g16,), (s32b,)),
        ("bf16 table with SR instead of fp32", (s16,), (s32b,)),
        ("rwsadagrad instead of sgd, bf16 table", (r16,), (s16,)),
        ("rwsadagrad instead of sgd, fp32 table", (r32,), (s32,)),
    )
    for name, plus, minus in parts:
        if all(v in ms for v in plus + minus):
            val = sum(ms[v] for v in plus) - sum(ms[v] for v in minus)
            print(f"[{tag}] split: {name:52s} {val:9.3f} ms", flush=True)


def main(device="cuda", variants: str = ",".join(NAMES)) -> dict:
    """Run the variants, the library call and K2's ladder at the probe and
    the main-path shape. Returns {tag: {variant, LIBRARY or rung:
    {"ms", "gbps", "nbytes"}, ..., "geometry": {...}}}."""
    dev = probe_device(device)
    vs = variants.split(",")
    for v in vs:
        if v not in K2_VARIANTS:
            raise ValueError(f"unknown variant {v!r}")
    return {tag: run_shape(tag, *make(), dev, vs)
            for tag, make in (("probe", probe_shape),
                              ("main-path", main_path_shape))}


if __name__ == "__main__":
    main(variants=sys.argv[1] if len(sys.argv) > 1 else ",".join(NAMES))
