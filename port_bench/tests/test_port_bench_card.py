"""The tiny cells on the card, with the program's CUDA kernels: sound runs
are correct, the control and a planted fault are not. Marked `cuda`; the
fixture skips where there is no card.

    python3 -m pytest -q -m cuda port_bench/tests/test_port_bench_card.py
"""

import time

import pytest
import torch

from port_bench import core
from port_bench.calibrate import half_batch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def run(root, name, card, **kw):
    cell = core.load_cell(name, root)
    return cell.driver().run(cell, 2**31 + 101, 0.5, True, card,
                             core.Stages(time.perf_counter()), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train.tiny.uniform", "train.tiny.pareto",
                                  "serve.tiny.offline"])
def test_tiny_cells_are_correct_on_the_card(tiny_root, card, name):
    res = run(tiny_root, name, card)
    assert res["checks"].ok(), res["checks"].table()
    out = core.report(core.load_cell(name, tiny_root), res, True,
                      {"platform": "gpu"})
    assert out["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_half_batch_is_not_correct_on_the_card(tiny_root, card):
    res = run(tiny_root, "train.tiny.uniform", card, fault=half_batch)
    assert not res["checks"].ok(), res["checks"].table()
