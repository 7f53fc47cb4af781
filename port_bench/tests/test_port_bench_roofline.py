"""The yardstick's operations and bytes against counts made by hand at a
tiny shape."""

import pytest

from port_bench.roofline import work

MODEL = {"embedding_dim": 8, "table_sizes": [300, 7, 5000, 40],
         "hot_sizes": [3, 1, 10, 2], "mlp_bot": [13, 16, 8],
         "mlp_top": [32, 16, 1], "dcn_num_layers": 2, "dcn_low_rank_dim": 8}


def test_layers_and_parameters_by_hand():
    # x0 = 8 + 4 tables x 8 = 40 wide
    assert work.layers(MODEL) == [(13, 16), (16, 8), (40, 8), (8, 40),
                                  (40, 8), (8, 40), (40, 32), (32, 16),
                                  (16, 1)]
    # bot 13*16+16 + 16*8+8; two cross layers of V 8x40, W 40x8, b 40;
    # top 40*32+32 + 32*16+16 + 16+1
    assert work.dense_params(MODEL) == 360 + 2 * 680 + 1857


def test_flops_by_hand():
    fwd = 2 * (208 + 128 + 4 * 320 + 1280 + 512 + 16)
    assert work.model_flops(MODEL, 1, train=False) == fwd == 6848
    assert work.model_flops(MODEL, 5, train=False) == 5 * fwd
    # backward: two products a layer, less the first layer's input gradient
    assert work.model_flops(MODEL, 5, train=True) == 5 * (3 * fwd - 2 * 208)


def test_step_bytes_by_hand():
    b, rows = 4, 30
    hits = b * 16
    inputs = hits * 4 + b * (13 * 4 + 4)
    params = 3577
    assert work.step_bytes(MODEL, b, rows, False, 16) == (
        rows * 16 + inputs + params * 4)
    assert work.step_bytes(MODEL, b, rows, True, 16) == (
        rows * (2 * 16 + 8) + inputs + params * 16)


def test_k2_bytes_by_hand():
    # 10 hits of fp32 G rows at d 8, 2 items of 256 slots, 3 touched bf16
    # rows with their accumulators
    assert work.k2_bytes(10, 512, 2, 3, 8, 4, 2) == (
        10 * 8 * 4 + 512 * 4 + 2 * 12 + 3 * (2 * 8 * 2 + 8))


@pytest.mark.parametrize("flops,nbytes,bound", [(989e12, 1.0, "flops"),
                                                (1.0, 3.35e12, "bytes")])
def test_share_takes_the_larger_bound(flops, nbytes, bound):
    got = work.share(flops, nbytes, 2.0)
    assert got["bound_by"] == bound
    assert got["pct"] == pytest.approx(50.0)
