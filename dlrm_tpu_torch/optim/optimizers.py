"""Dense-parameter optimizers: SGD, Adagrad, and the dense half of row-wise
sparse Adagrad (the port of dlrm_tpu/optim/optimizers.py::apply_updates for
the parameters outside the embedding table).

  * sgd        p -= lr * g
  * adagrad    a += g^2; p -= lr * g / (sqrt(a) + eps), eps = 1e-10
  * rwsadagrad non-table params fall back to element-wise Adagrad (the
               row-wise table update is the streamed kernel's epilogue,
               ops/stream_kernels.py)

Parameters and accumulators are updated IN PLACE (the JAX step donates
them); the arithmetic order is the JAX package's: (lr * g) / (sqrt(a) + eps).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

ADAGRAD_EPS = 1e-10


def tree_map(fn: Callable, tree, *rest):
    """Map fn over the tensor leaves of nested dicts/lists/tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def init_dense_state(name: str, params) -> Any:
    """Accumulators for the dense params (None for sgd)."""
    if name == "sgd":
        return None
    if name in ("adagrad", "rwsadagrad"):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    raise ValueError(f"optimizer {name!r} not supported")


@torch.no_grad()
def apply_updates(name: str, params, grads, accum, lr,
                  eps: float = ADAGRAD_EPS) -> None:
    """Update the `params` tree (and the `accum` tree) in place from the
    `grads` tree; the trees are matched by key, not by order."""
    if name == "sgd":
        tree_map(lambda p, g: p.sub_(lr * g), params, grads)
        return
    if name in ("adagrad", "rwsadagrad"):

        def upd(p, g, a):
            g32 = g.float()
            a.add_(g32 * g32)
            p.sub_((lr * g32) / (torch.sqrt(a) + eps))

        tree_map(upd, params, grads, accum)
        return
    raise ValueError(f"optimizer {name!r} not supported")
