"""Optimizers: SGD, Adagrad and row-wise sparse Adagrad (the port of
dlrm_tpu/optim/optimizers.py).

  * sgd        p -= lr * g
  * adagrad    a += g^2; p -= lr * g / (sqrt(a) + eps), eps = 1e-10
  * rwsadagrad a 2-D leaf under params["emb"] (an embedding table, not an
               MD "proj") keeps ONE accumulator per row, a += mean(g_row^2),
               p_row -= lr * g_row / (sqrt(a) + eps) (optim/rwsadagrad.py:
               117-148); every other leaf falls back to element-wise
               Adagrad (:145-148)

Parameters and accumulators are updated IN PLACE (the JAX step donates
them); the arithmetic order is the JAX package's: (lr * g) / (sqrt(a) + eps).
The state is {"step": int} for sgd and {"step": int, "accum": tree} for the
others, the JAX package's tree with the step kept on the host.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

ADAGRAD_EPS = 1e-10


def tree_map(fn: Callable, tree, *rest):
    """Map fn over the tensor leaves of nested dicts/lists/tuples."""
    return tree_map_with_path(lambda _, *x: fn(*x), tree, *rest)


def tree_map_with_path(fn: Callable, tree, *rest, path=()):
    """tree_map whose fn also takes the leaf's path: the dict keys and
    list indices from the root."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], *(r[k] for r in rest),
                                      path=path + (k,)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, x, *(r[i] for r in rest), path=path + (i,))
            for i, x in enumerate(tree)
        )
    return fn(path, tree, *rest)


def path_keys(path) -> list:
    """Dict keys / sequence indices along a tree path: the entries of a
    path of tree_map_with_path as they are, and the .key / .idx of a JAX
    key path's entries (its other entries dropped), as the JAX package's
    path_keys reads them."""
    keys = []
    for p in path:
        if hasattr(p, "key"):
            keys.append(p.key)
        elif hasattr(p, "idx"):
            keys.append(p.idx)
        elif isinstance(p, (str, int)):
            keys.append(p)
    return keys


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def _is_table(path, p) -> bool:
    """An embedding table: a 2-D leaf under params["emb"], not an MD
    projection (a dense nn.Linear-style param in the reference)."""
    return (bool(path) and path[0] == "emb" and path[-1] != "proj"
            and p.dim() == 2)


def init_dense_state(name: str, params) -> Any:
    """Element-wise accumulators for `params` (None for sgd)."""
    if name == "sgd":
        return None
    if name in ("adagrad", "rwsadagrad"):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)
    raise ValueError(f"optimizer {name!r} not supported")


def init_opt_state(name: str, params) -> dict:
    """The JAX package's init_opt_state: under rwsadagrad, one fp32
    accumulator per row for each table; element-wise elsewhere."""
    if name == "sgd":
        return {"step": 0}
    if name == "adagrad":
        return {"step": 0, "accum": init_dense_state(name, params)}
    if name == "rwsadagrad":

        def make(path, p):
            if _is_table(path, p):
                return torch.zeros((p.shape[0],), dtype=torch.float32,
                                   device=p.device)
            return torch.zeros_like(p, dtype=torch.float32)

        return {"step": 0, "accum": tree_map_with_path(make, params)}
    raise ValueError(f"optimizer {name!r} not supported")


@torch.no_grad()
def apply_updates(name: str, params, grads, accum, lr,
                  eps: float = ADAGRAD_EPS) -> None:
    """Update the `params` tree (and the `accum` tree) in place from the
    `grads` tree; the trees are matched by key, not by order. The paths
    are the trees' own, so a table is recognised only in a tree that holds
    params["emb"]."""
    if name == "sgd":
        tree_map(lambda p, g: p.sub_(lr * g), params, grads)
        return
    if name not in ("adagrad", "rwsadagrad"):
        raise ValueError(f"optimizer {name!r} not supported")
    rowwise = name == "rwsadagrad"

    def upd(path, p, g, a):
        g32 = g.float()
        if rowwise and _is_table(path, p):
            a.add_((g32 * g32).mean(dim=1))
            p.sub_((lr * g32) / (torch.sqrt(a) + eps)[:, None])
        else:
            a.add_(g32 * g32)
            p.sub_((lr * g32) / (torch.sqrt(a) + eps))

    tree_map_with_path(upd, params, grads, accum)
