"""MLP tower ops (the port of dlrm_tpu/ops/mlp.py).

Weights are stored [n_in, n_out] as in the JAX package (nn.Linear stores the
transpose), so forward is a plain x @ w and parameters carry across the
bridge unchanged. Masters stay fp32 and are cast to the compute dtype at use.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


def init_mlp(gen: torch.Generator, ln: Sequence[int],
             device: torch.device) -> List[dict]:
    """The reference's distributions: per layer W ~ N(0, sqrt(2/(m+n)))
    of shape [n, m] and b ~ N(0, sqrt(1/m)), drawn from `gen`."""
    layers = []
    for i in range(len(ln) - 1):
        n, m = int(ln[i]), int(ln[i + 1])
        w = torch.randn((n, m), generator=gen, device=device)
        b = torch.randn((m,), generator=gen, device=device)
        layers.append({"w": w * math.sqrt(2.0 / (m + n)),
                       "b": b * math.sqrt(1.0 / m)})
    return layers


def apply_mlp(layers: List[dict], x: torch.Tensor,
              sigmoid_layer: int = -1) -> torch.Tensor:
    """x @ w + b per layer; ReLU everywhere except Sigmoid at `sigmoid_layer`.

    Activations stay in the caller's compute dtype. Where the port rounds:
    in bf16 the product x @ w comes back from the matmul already rounded to
    bf16 (fp32 accumulation inside), the fp32 bias is added in fp32, and the
    sum is rounded to bf16 again. The JAX package adds the bias to the fp32
    product and rounds once (dlrm_tpu/ops/mlp.py:56-59); the two differ by at
    most one bf16 rounding per layer. In fp32 both are the same sums."""
    dtype = x.dtype
    for i, layer in enumerate(layers):
        y = torch.matmul(x, layer["w"].to(dtype)).float() + layer["b"]
        x = y.to(dtype)
        x = torch.sigmoid(x) if i == sigmoid_layer else torch.relu(x)
    return x
