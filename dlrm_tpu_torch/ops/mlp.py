"""MLP tower ops (the port of dlrm_tpu/ops/mlp.py).

Weights are stored [n_in, n_out] as in the JAX package (nn.Linear stores the
transpose), so forward is a plain x @ w and parameters carry across the
bridge unchanged. Masters stay fp32 and are cast to the compute dtype at use.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch


def init_mlp_numpy(ln: Sequence[int], device) -> List[dict]:
    """The reference's init from the GLOBAL numpy stream, in create_mlp's
    order (dlrm_s_pytorch.py:221-225): per layer W ~ N(0, sqrt(2/(m+n)))
    of shape (m, n), then b ~ N(0, sqrt(1/m)); W is stored transposed."""
    layers = []
    for i in range(len(ln) - 1):
        n, m = int(ln[i]), int(ln[i + 1])
        w = np.random.normal(0.0, np.sqrt(2.0 / (m + n)), size=(m, n)).astype(
            np.float32
        )
        b = np.random.normal(0.0, np.sqrt(1.0 / m), size=m).astype(np.float32)
        layers.append({"w": torch.from_numpy(np.ascontiguousarray(w.T)).to(device),
                       "b": torch.from_numpy(b).to(device)})
    return layers


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


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 sums, returned in fp32 unrounded. On the card the
    bf16 tensor-core product writes its fp32 sums (aten::mm.dtype); on the
    CPU, whose build has no mm.dtype, the operands are widened first: a
    product of two bf16 values is exact in fp32, so both are the fp32 sums
    of the same exact products."""
    if x.device.type == "cuda":
        return torch.mm(x, w, out_dtype=torch.float32)
    return torch.mm(x.float(), w.float())


class _MatmulF32(torch.autograd.Function):
    """_mm_f32 with the gradient of a product in the operands' dtype: the
    fp32 cotangent is rounded to that dtype and multiplied there (fp32 sums
    inside, as autograd's backward of a bf16 matmul does)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g = gy.to(x.dtype)
        gx = torch.mm(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = torch.mm(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32(x @ w) + b in fp32, not rounded: the JAX package's
    jnp.dot(x, w, preferred_element_type=float32) + b. x is [..., n_in] in
    the compute dtype and w [n_in, n_out] is cast to it; the caller rounds
    the result once. In fp32 it is the plain product."""
    w = w.to(x.dtype)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = torch.mm(x2, w)
    else:
        y = _MatmulF32.apply(x2, w)
    y = y.reshape(*lead, w.shape[1])
    return y if b is None else y + b


def apply_mlp(layers: List[dict], x: torch.Tensor,
              sigmoid_layer: int = -1) -> torch.Tensor:
    """x @ w + b per layer; ReLU everywhere except Sigmoid at `sigmoid_layer`.

    Activations stay in the caller's compute dtype. Each layer rounds once,
    as dlrm_tpu/ops/mlp.py:55-59 does: the fp32 bias is added to the fp32
    product (matmul_f32) and the sum is rounded to the compute dtype."""
    dtype = x.dtype
    for i, layer in enumerate(layers):
        x = matmul_f32(x, layer["w"], layer["b"]).to(dtype)
        x = torch.sigmoid(x) if i == sigmoid_layer else torch.relu(x)
    return x
