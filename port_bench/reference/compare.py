"""The numbers that decide `correct`: each a gap between what the timed
path produced and what the plain reference computes from the same inputs.

Training (the first three steps of the object the window then drives):
  probs_gap   max over the first step's samples of |p - p_ref|
  grad_gap    by the worst leaf, |n - n_ref| / max(n_ref, median leaf's
              n_ref), n the first gradient's norm as the optimizer got it
              (worked out from its accumulators after one step)
  change_gap  the same for the norm of each leaf's change after the three
              steps; a leaf whose reference gradient is under a thousandth
              of the median leaf's (nought to rounding) is left out
Each step's relative loss gap is logged beside them and not compared: the
mean over the batch cancels what the control moves, and the later steps'
gaps swing from seed to seed with Adagrad's first step (PERF.md §2).
Serving:
  probs_gap   max over every served sample of |p - p_ref|
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

NOUGHT = 1e-3  # a leaf's gradient under this share of the median's


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               names: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    names = list(ref if names is None else names)
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def moving_leaves(ref_grad: Dict[str, float]) -> list:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= NOUGHT * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """prog and ref: {"loss": [per step], "probs": tensor, "grad": {leaf:
    norm}, "change": {leaf: norm}}."""
    probs = float((prog["probs"].float().reshape(-1).cpu()
                   - ref["probs"].float().reshape(-1).cpu()).abs().max())
    grad, _ = worst_leaf(prog["grad"], ref["grad"])
    change, _ = worst_leaf(prog["change"], ref["change"],
                           moving_leaves(ref["grad"]))
    return {"probs_gap": probs, "grad_gap": grad, "change_gap": change}


def loss_gaps(prog: dict, ref: dict) -> list:
    """Each step's |loss - loss_ref| / |loss_ref|."""
    return [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """Which leaf gave grad_gap and change_gap (for the log)."""
    return {"grad_gap": worst_leaf(prog["grad"], ref["grad"])[1],
            "change_gap": worst_leaf(prog["change"], ref["change"],
                                     moving_leaves(ref["grad"]))[1]}
