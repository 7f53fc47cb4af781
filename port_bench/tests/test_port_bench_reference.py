"""The comparison that decides `correct`, run on the CPU at a tiny size
through the whole of a cell's driver: the port's step and forward (their
plain versions) agree with the plain reference within the limits; the
control (one precision below) and each fault a cell can have, planted in
the timed path, come out not correct."""

import time

import pytest
import torch

from port_bench import core
from port_bench.calibrate import half_batch

CPU = torch.device("cpu")
SEEDS = [3, 2**31 + 17]


def run(root, cell_name, seed, **kw):
    cell = core.load_cell(cell_name, root)
    return cell.driver().run(cell, seed, 0.2, False, CPU,
                             core.Stages(time.perf_counter()), **kw)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["train.tiny.uniform", "train.tiny.pareto",
                                  "serve.tiny.offline"])
def test_the_port_agrees_with_the_reference(tiny_root, cell, seed):
    res = run(tiny_root, cell, seed)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["checks"].ok(), res["checks"].table()
    assert set(res["checks"].values) == set(
        core.load_cell(cell, tiny_root).limits)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_train_control_fails(tiny_root, seed):
    res = run(tiny_root, "train.tiny.uniform", seed, control=True)
    ctl = core.Checks(core.load_cell("train.tiny.uniform", tiny_root).limits)
    for k, v in res["control"].items():
        ctl.add(k, v)
    assert not ctl.ok(), ctl.table()


@pytest.mark.parametrize("seed", SEEDS)
def test_the_serve_control_fails(tiny_root, seed):
    res = run(tiny_root, "serve.tiny.offline", seed, control=True)
    lim = core.load_cell("serve.tiny.offline", tiny_root).limits
    assert res["control"]["probs_gap"] > lim["probs_gap"]["limit"]


def unchanged(step):
    """A step that leaves the parameters as they were."""
    return lambda params, opt, batch, lr: step(params, opt, batch, 0.0)


@pytest.mark.parametrize("fault", [unchanged, half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_train_step_is_not_correct(tiny_root, fault):
    res = run(tiny_root, "train.tiny.uniform", SEEDS[0], fault=fault)
    assert not res["checks"].ok(), res["checks"].table()


def altered(forward):
    """One answer altered where it is produced."""

    def broken(batch):
        p = forward(batch).clone()
        p[3] = 1.0 - p[3]
        return p

    return broken


def half_scored(forward):
    """Half of the batch left out: its scores the mean of the rest's."""

    def broken(batch):
        p = forward(batch).clone()
        p[p.shape[0] // 2:] = p[: p.shape[0] // 2].mean()
        return p

    return broken


@pytest.mark.parametrize("fault", [altered, half_scored],
                         ids=["answer_altered", "half_batch"])
def test_a_broken_forward_is_not_correct(tiny_root, fault):
    res = run(tiny_root, "serve.tiny.offline", SEEDS[0], fault=fault)
    assert not res["checks"].ok(), res["checks"].table()
    assert res["failed"] > 0
