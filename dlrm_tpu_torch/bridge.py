"""Carry parameter and optimizer-state trees between the JAX package and the
port, as numpy.

params_from_jax takes a tree of nested dicts/lists whose leaves are numpy
arrays (e.g. jax.tree_util.tree_map(np.asarray, params) on the JAX side)
and returns the same tree of torch tensors on `device`; params_to_jax is the
inverse. The tree and every shape are kept as they are, so both the plain
layout ([total_rows, d] stacked table) and the stream layout of
train/stream_step.py (padded [padded_rows, d] table, bf16 after cast_emb,
the packed rwsadagrad accumulator [padded_rows/128, 128], opt_state with its
integer "step") cross unchanged and bit-exact. bf16 arrays travel as their
16-bit patterns (numpy's bfloat16 is ml_dtypes'). A 0-d integer array (the
optimizer step) becomes a Python int, as the port keeps the step on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from dlrm_tpu_torch.device import resolve_device


def params_from_jax(tree, device="cuda"):
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        a = np.asarray(x)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            return int(a)
        if a.dtype.name == "bfloat16":
            t = torch.from_numpy(np.array(a).view(np.uint16))
            return t.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return conv(tree)


def params_to_jax(tree):
    """The inverse: torch tensors -> numpy arrays (bf16 as ml_dtypes'
    bfloat16), Python ints -> int32 0-d arrays."""

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, int):
            return np.asarray(x, dtype=np.int32)
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
        return t.numpy().copy()

    return conv(tree)
